"""``tpuprof-stats-v1`` artifacts: :func:`write_artifact` and
:func:`read_artifact` (``store.py``; stats-only, or with a stream's fold
state that :func:`resume_profiler` folds on from, ``incremental.py``), and
the drift between two of them:
:func:`compute_drift` (``drift.py``) and its HTML page,
:func:`drift_to_html` (``render.py``)."""

from tpuprof_torch.artifact.drift import (DRIFT_SCHEMA_ID, DriftThresholds,
                                          compute_drift, ks_statistic,
                                          psi_statistic)
from tpuprof_torch.artifact.incremental import resume_profiler
from tpuprof_torch.artifact.render import drift_to_html
from tpuprof_torch.artifact.store import (Artifact, build_sketches,
                                          read_artifact, write_artifact)

__all__ = ["Artifact", "DRIFT_SCHEMA_ID", "DriftThresholds",
           "build_sketches", "compute_drift", "drift_to_html",
           "ks_statistic", "psi_statistic", "read_artifact",
           "resume_profiler", "write_artifact"]
