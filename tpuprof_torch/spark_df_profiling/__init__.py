"""Drop-in import surface for users migrating from spark-df-profiling, on
the GPU (counterpart of the repo's ``spark_df_profiling`` package, which is
backed by the JAX package).

The reference library's whole public API (SURVEY.md §1: ``ProfileReport``
with ``bins``/``corr_reject`` kwargs, ``.to_file``/``.html``/
``.get_rejected_variables``/``_repr_html_``, ``base.describe``, and the
``formatters`` helpers) is re-exported from the port, so

    from tpuprof_torch import spark_df_profiling
    report = spark_df_profiling.ProfileReport(df, bins=10, corr_reject=0.9)
    report.to_file("report.html")

keeps working verbatim — backed by the port's kernels on ``cuda:0``.  Like
``tpuprof_torch.ProfileReport`` it raises without a CUDA device; pass
``device="cpu"`` to run the kernels' plain versions on the CPU.  Accepts
pandas DataFrames, pyarrow Tables, and Parquet paths (there is no
SparkSession here to accept Spark DataFrames; convert with
``df.toPandas()`` or point at the Parquet the Spark job wrote).
"""

from tpuprof_torch.api import ProfileReport, describe
from tpuprof_torch.config import ProfilerConfig
from tpuprof_torch.report import formatters

from tpuprof_torch.spark_df_profiling import base, templates

__all__ = ["ProfileReport", "ProfilerConfig", "describe", "formatters",
           "base", "templates"]
