"""Machine-readable export of the full stats dict (schema
``tpuprof-stats-v1``).

Copy of ``tpuprof/report/export.py``: every value in ``table`` and
``variables`` in its raw form (floats stay floats, non-finite become null,
timestamps ISO strings), the human formatting in a parallel ``display``
section, plus ``freq``, ``correlations``, ``messages`` and ``sample``, and
on a degraded run the manifest of the skipped batches (``quarantine``).
Private keys of the stats dict (``_bin_seeds``) are never exported.
"""

from __future__ import annotations

import math
from datetime import datetime, timedelta
from typing import Any, Dict

import numpy as np
import pandas as pd

from tpuprof_torch.report.formatters import fmt_value

# the export contract's version; artifacts embed it and refuse others
SCHEMA_ID = "tpuprof-stats-v1"


def json_scalar(value: Any) -> Any:
    """One value -> its JSON-safe raw form (no human formatting)."""
    if value is None or value is pd.NaT:
        return None
    if isinstance(value, (tuple, list)):
        return [json_scalar(v) for v in value]
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        value = float(value)
        return value if math.isfinite(value) else None
    if isinstance(value, (pd.Timestamp, datetime, np.datetime64)):
        return str(pd.Timestamp(value))
    if isinstance(value, (pd.Timedelta, timedelta, np.timedelta64)):
        return str(pd.Timedelta(value))
    return str(value)


def _corr_entry(matrix: pd.DataFrame) -> Dict[str, Any]:
    cols = [str(c) for c in matrix.columns]
    # row by row from one numpy copy: a pandas lookup per entry took
    # minutes at 1,024 columns (a million entries)
    return {
        "columns": cols,
        "matrix": {str(r): dict(zip(cols, map(json_scalar, row)))
                   for r, row in zip(matrix.index,
                                     matrix.to_numpy().tolist())},
        # a sample-estimated Spearman matrix says so
        "approx": bool(matrix.attrs.get("approx", False)),
    }


def stats_to_json(stats: Dict[str, Any]) -> Dict[str, Any]:
    """The complete stats dict as a ``json.dump``-ready structure."""
    # histograms are render-layer data, not column statistics
    var_items = {
        name: {k: v for k, v in var.items()
               if k not in ("histogram", "mini_histogram")}
        for name, var in stats["variables"].items()}
    out: Dict[str, Any] = {
        "schema": SCHEMA_ID,
        "table": {k: json_scalar(v) for k, v in stats["table"].items()},
        "variables": {
            name: {k: json_scalar(v) for k, v in var.items()}
            for name, var in var_items.items()},
        "display": {
            "table": {k: fmt_value(v) for k, v in stats["table"].items()},
            "variables": {
                name: {k: fmt_value(v) for k, v in var.items()}
                for name, var in var_items.items()},
        },
        "freq": {
            str(col): [{"value": json_scalar(idx), "count": int(cnt)}
                       for idx, cnt in vc.items()]
            for col, vc in stats.get("freq", {}).items()},
        "correlations": {
            str(method): _corr_entry(matrix)
            for method, matrix in stats.get("correlations", {}).items()},
        "messages": [
            {**m.to_dict(), "value": json_scalar(m.value)}
            for m in stats.get("messages", ())],
    }
    if stats.get("_quarantine"):
        # degraded runs only: the skipped-batch manifest rides the export
        out["quarantine"] = [
            {k: json_scalar(v) if not isinstance(v, (list, type(None)))
             else v for k, v in e.items()}
            for e in stats["_quarantine"]]
    sample = stats.get("sample")
    if sample is None:
        out["sample"] = {"columns": [], "rows": []}
    else:
        out["sample"] = {
            "columns": [str(c) for c in sample.columns],
            "rows": [[json_scalar(v) for v in row]
                     for row in sample.itertuples(index=False, name=None)],
        }
    return out
