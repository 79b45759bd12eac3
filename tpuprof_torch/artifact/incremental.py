"""Incremental profiles on the merge laws.

Counterpart of ``tpuprof/artifact/incremental.py``.  A fold-state artifact
(``write_artifact(path, profiler=prof)``) stores a stream's whole
mergeable state, so ``profile(A ∪ Δ) == stored_state(A) ⊕ profile(Δ)``:
:func:`resume_profiler` rebuilds a
:class:`~tpuprof_torch.runtime.stream.StreamingProfiler` whose state is the
artifact's, and feeding it only the new rows gives the stats a full stream
of A ∪ Δ gives.  The restore path is a checkpoint's
(``StreamingProfiler.from_payload``), with its checks (hash route, sample
size, register width, the shapes of the device state); a degraded prefix
stays degraded, and a fused profiler's edges and histogram fold come back
with it, so the rest is binned on the same edges.  Under ``exact_distinct``
the artifact references the tracker's spill runs by path (they outlive the
writer until its ``close()``), and the resumed profiler counts on from
them; runs that are gone demote their columns to the estimate.
"""

from __future__ import annotations

import os
from typing import Any, Union

from tpuprof_torch.artifact.store import Artifact, read_artifact


def resume_profiler(artifact: Union[str, os.PathLike, Artifact],
                    config=None, device=None) -> Any:
    """A :class:`StreamingProfiler` from a fold-state artifact (a path or
    an :class:`Artifact` already read), on ``device`` (``cuda:0`` by
    default).  ``update(delta)`` then ``stats()`` equals a full stream of
    the artifact's rows and the delta.  Raises
    :class:`~tpuprof_torch.errors.CorruptArtifactError` for a stats-only,
    torn or foreign artifact, and ``ValueError`` where the state does not
    fit ``config``."""
    art = artifact if isinstance(artifact, Artifact) \
        else read_artifact(os.fspath(artifact))
    payload = art.state_payload()
    from tpuprof_torch.runtime.stream import StreamingProfiler
    return StreamingProfiler.from_payload(payload, config=config,
                                          device=device)
