"""Stats-only ``tpuprof-stats-v1`` artifacts: :func:`write_artifact` and
:func:`read_artifact` (``tpuprof_torch/artifact/store.py``)."""

from tpuprof_torch.artifact.store import (Artifact, build_sketches,
                                          read_artifact, write_artifact)

__all__ = ["Artifact", "build_sketches", "read_artifact", "write_artifact"]
