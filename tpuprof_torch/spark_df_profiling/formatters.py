"""Reference-layout alias for ``spark_df_profiling.formatters``
(SURVEY.md §2.1: fmt_percent / fmt_bytesize and friends); counterpart of
the repo's ``spark_df_profiling/formatters.py``, on the port's
``report/formatters.py``."""

from tpuprof_torch.report.formatters import (VALUE_FORMATTERS, alert_class,
                                             fmt_bytesize, fmt_number,
                                             fmt_percent, fmt_stat,
                                             fmt_timedelta, fmt_timestamp,
                                             fmt_value)

__all__ = ["fmt_percent", "fmt_bytesize", "fmt_number", "fmt_timestamp",
           "fmt_timedelta", "fmt_value", "fmt_stat", "alert_class",
           "VALUE_FORMATTERS"]
