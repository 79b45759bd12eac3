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
``profile`` and ``diff`` verbs.  ``tpuprof_torch.obs`` is the telemetry
(metrics, JSONL events, the crash flight recorder, ``--trace``).  Several
CUDA devices shard a scan (``runtime/mesh.py``), several processes profile
a dataset's stripes and merge over gloo (``runtime/distributed.py``), and
an elastic fleet of members survives a lost one (``runtime/fleet.py``).
``tpuprof_torch.serve`` is the resident daemon with its HTTP edge and
drift watch, ``tpuprof_torch.warehouse`` the columnar history of
profiles, and ``describe(df, backend="cpu")`` the exact pandas oracle.
``tpuprof_torch.spark_df_profiling`` is the spark-df-profiling drop-in
(``ProfileReport(df, bins=10, corr_reject=0.9)``), and ``python -m
tpuprof_torch lint`` runs ``tpuprof_torch.analysis``, the invariant suite,
over the port's own tree.
The JAX package ``tpuprof`` is the reference; this package imports
nothing from it.
"""

from tpuprof_torch.api import (ProfileReport, StreamingProfiler, describe,
                               resume_profiler)
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.errors import InputError

# the port's own version; artifacts carry it in meta["tpuprof_version"]
__version__ = "0.1.0"

__all__ = ["InputError", "ProfileReport", "ProfilerConfig",
           "StreamingProfiler", "__version__", "describe", "resume_profiler"]
