"""tpuprof_torch — the PyTorch/CUDA port of tpuprof.

``describe(df)`` / ``ProfileReport(df)`` profile a pandas DataFrame or a
pyarrow Table with the two-pass scan: pass A and pass B each run one kernel
written by hand for NVIDIA Hopper (``kernels/csrc``), on the first CUDA
device unless the caller passes ``device="cpu"``.  The JAX package
``tpuprof`` is the reference; this package imports nothing from it.
"""

from tpuprof_torch.api import ProfileReport, describe
from tpuprof_torch.config import ProfilerConfig

__all__ = ["ProfileReport", "ProfilerConfig", "describe"]
