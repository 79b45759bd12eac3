"""Human formatting of statistics: the part of ``tpuprof/report/formatters.py``
that :func:`fmt_value` needs (the ``display`` section of the export)."""

from __future__ import annotations

import math
from datetime import datetime
from typing import Any

import numpy as np
import pandas as pd


def fmt_number(value: Any) -> str:
    """Ints with thousands separators, floats with 5 significant digits."""
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


def fmt_value(value: Any) -> str:
    """Dispatch on type."""
    if isinstance(value, (pd.Timestamp, datetime, np.datetime64)):
        return "" if value is pd.NaT else str(pd.Timestamp(value))
    if isinstance(value, (pd.Timedelta, np.timedelta64)):
        return "" if value is pd.NaT else str(pd.Timedelta(value))
    if isinstance(value, (int, float, np.integer, np.floating, np.bool_,
                          bool)):
        return fmt_number(value)
    if value is None or value is pd.NaT:
        return ""
    return str(value)
