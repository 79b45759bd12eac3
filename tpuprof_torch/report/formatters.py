"""Human formatting of statistics.

Copy of ``tpuprof/report/formatters.py``: ``fmt_percent``, ``fmt_bytesize``,
``fmt_number``, ``fmt_timestamp``, ``fmt_timedelta``, ``fmt_value``,
``alert_class`` and the ``fmt_stat`` dispatch table the report templates
use (the reference's ``spark_df_profiling/formatters.py``).
"""

from __future__ import annotations

import math
from datetime import datetime
from typing import Any

import numpy as np
import pandas as pd


def fmt_percent(value: Any) -> str:
    """0.123 -> '12.3%' (reference: fmt_percent)."""
    if value is None or (isinstance(value, float) and not math.isfinite(value)):
        return ""
    return f"{value * 100:.1f}%"


def fmt_bytesize(num: Any, suffix: str = "B") -> str:
    """1234 -> '1.2 KiB' (reference: fmt_bytesize)."""
    if num is None or (isinstance(num, float) and not math.isfinite(num)):
        return ""
    num = float(num)
    for unit in ("", "Ki", "Mi", "Gi", "Ti", "Pi"):
        if abs(num) < 1024.0:
            return f"{num:3.1f} {unit}{suffix}"
        num /= 1024.0
    return f"{num:.1f} Ei{suffix}"


def fmt_number(value: Any) -> str:
    """General numeric formatting: ints with thousands separators, floats
    with 5 significant digits (reference: formatters.fmt)."""
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return f"{int(value):,}"
    if isinstance(value, (float, np.floating)):
        value = float(value)
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "∞" if value > 0 else "-∞"
        if value == int(value) and abs(value) < 1e15:
            return f"{int(value):,}"
        return f"{value:.5g}"
    return str(value)


def fmt_timestamp(value: Any) -> str:
    if value is None or value is pd.NaT:
        return ""
    if isinstance(value, (pd.Timestamp, datetime, np.datetime64)):
        ts = pd.Timestamp(value)
        return str(ts)
    return str(value)


def fmt_timedelta(value: Any) -> str:
    if value is None or value is pd.NaT:
        return ""
    if isinstance(value, (pd.Timedelta, np.timedelta64)):
        return str(pd.Timedelta(value))
    return str(value)


def fmt_value(value: Any) -> str:
    """Dispatch on type — the template-facing catch-all."""
    if isinstance(value, (pd.Timestamp, datetime, np.datetime64)):
        return fmt_timestamp(value)
    if isinstance(value, (pd.Timedelta, np.timedelta64)):
        return fmt_timedelta(value)
    if isinstance(value, (int, float, np.integer, np.floating, np.bool_, bool)):
        return fmt_number(value)
    if value is None:
        return ""
    return str(value)


def alert_class(value: Any, threshold: float) -> str:
    """Reference: fmt_color — alert values get a CSS class so templates can
    highlight them (here a class name rather than an inline color)."""
    try:
        if value is not None and float(value) > threshold:
            return "alert-value"
    except (TypeError, ValueError):
        pass
    return ""


# Reference: value_formatters / row_formatters dispatch tables used by the
# Jinja environment (templates call these by stat name).
VALUE_FORMATTERS = {
    "p_missing": fmt_percent,
    "p_unique": fmt_percent,
    "p_zeros": fmt_percent,
    "p_infinite": fmt_percent,
    "total_missing": fmt_percent,
    "cv": fmt_number,
    "memorysize": fmt_bytesize,
}


def fmt_stat(name: str, value: Any) -> str:
    """Format a named statistic using its registered formatter."""
    return VALUE_FORMATTERS.get(name, fmt_value)(value)
