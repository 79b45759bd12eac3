"""tpuprof_torch — the PyTorch/CUDA port of tpuprof.

``describe(source)`` / ``ProfileReport(source)`` profile a pandas
DataFrame, a pyarrow Table or Dataset, or a Parquet file or directory with
the two-pass scan (pass A and pass B each run kernels written by hand for
NVIDIA Hopper, ``kernels/csrc``) or, with ``profile_passes="fused"``, in
one read of every batch on seeded bin edges (``runtime/singlepass.py``), on
the first CUDA device unless the caller passes ``device="cpu"``;
``ProfileReport.to_file`` writes the HTML report.  ``checkpoint_path``
makes a long profile resumable after a crash.  ``StreamingProfiler``
maintains a profile over a stream of micro-batches (checkpoint, restore),
and ``resume_profiler`` folds new rows onto a fold-state artifact.
``tpuprof_torch.artifact`` writes, reads and compares
``tpuprof-stats-v1`` artifacts, and ``python -m tpuprof_torch`` runs the
``profile`` and ``diff`` verbs.  The JAX package ``tpuprof`` is the
reference; this package imports nothing from it.
"""

from tpuprof_torch.api import (ProfileReport, StreamingProfiler, describe,
                               resume_profiler)
from tpuprof_torch.config import ProfilerConfig

# the port's own version; artifacts carry it in meta["tpuprof_version"]
__version__ = "0.1.0"

__all__ = ["ProfileReport", "ProfilerConfig", "StreamingProfiler",
           "__version__", "describe", "resume_profiler"]
