"""The stats-dict contract (copy of ``tpuprof/schema.py``).

The report layer and ``get_rejected_variables`` consume one nested dict,
``{'table', 'variables', 'freq', 'correlations', 'messages', 'sample'}``;
every backend produces exactly this shape.  Column kinds follow the
reference's dispatch order:

    distinct <= 1              -> CONST
    boolean dtype              -> BOOL
    numeric dtype              -> NUM
    datetime dtype             -> DATE
    distinct == non-null count -> UNIQUE   (non-numeric only)
    otherwise                  -> CAT

plus CORR for NUM columns whose |Pearson| against an earlier kept column
exceeds ``corr_reject``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd

# ---------------------------------------------------------------------------
# Column kinds (reference row types; each maps to a renderer template)
# ---------------------------------------------------------------------------

NUM = "NUM"
CAT = "CAT"
DATE = "DATE"
BOOL = "BOOL"
CONST = "CONST"
UNIQUE = "UNIQUE"
CORR = "CORR"

ALL_KINDS = (NUM, CAT, DATE, BOOL, CONST, UNIQUE, CORR)

# Message (warning/alert) ids — reference: messages derivation, SURVEY §2.1.
MSG_HIGH_CARDINALITY = "HIGH_CARDINALITY"
MSG_HIGH_MISSING = "HIGH_MISSING"
MSG_HIGH_ZEROS = "HIGH_ZEROS"
MSG_SKEWED = "SKEWED"
MSG_CONST = "CONST"
MSG_UNIQUE = "UNIQUE"
MSG_CORR = "CORR"
# a CAT column's distinct count fell back to the HLL estimate (its
# Misra-Gries summary and exact duplicate tracker both overflowed)
MSG_APPROX_DISTINCT = "APPROX_DISTINCT"


@dataclasses.dataclass
class Message:
    """One alert row in the report's messages block."""

    kind: str            # one of the MSG_* ids
    column: str
    value: Any = None    # the offending value (p_missing, correlation, ...)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "column": self.column, "value": self.value}


# ---------------------------------------------------------------------------
# Per-kind stat field lists (the §2.1 feature checklist).  The renderer and
# the contract test both key off these, so a backend that forgets a field
# fails loudly.
# ---------------------------------------------------------------------------

COMMON_FIELDS = [
    "type", "count", "n_missing", "p_missing", "distinct_count", "p_unique",
    "is_unique", "distinct_approx", "memorysize",
]

NUM_FIELDS = COMMON_FIELDS + [
    "mean", "std", "variance", "min", "max", "range", "sum",
    "p5", "p25", "p50", "p75", "p95", "iqr", "cv", "mad",
    "skewness", "kurtosis", "n_zeros", "p_zeros", "n_infinite", "p_infinite",
    "mode", "mode_approx", "histogram", "mini_histogram",
]

CAT_FIELDS = COMMON_FIELDS + ["mode", "top", "freq"]
BOOL_FIELDS = COMMON_FIELDS + ["mean", "mode", "mode_approx", "top", "freq"]
DATE_FIELDS = COMMON_FIELDS + ["min", "max", "range"]
CONST_FIELDS = COMMON_FIELDS + ["mode"]
UNIQUE_FIELDS = COMMON_FIELDS + ["first_rows"]
CORR_FIELDS = COMMON_FIELDS + ["correlation_var", "correlation"]

FIELDS_BY_KIND = {
    NUM: NUM_FIELDS,
    CAT: CAT_FIELDS,
    BOOL: BOOL_FIELDS,
    DATE: DATE_FIELDS,
    CONST: CONST_FIELDS,
    UNIQUE: UNIQUE_FIELDS,
    CORR: CORR_FIELDS,
}

# Quantile probe -> variables-frame field name.
QUANTILE_FIELDS = {0.05: "p5", 0.25: "p25", 0.5: "p50", 0.75: "p75", 0.95: "p95"}


def classify_dtype(series: pd.Series) -> str:
    """Coarse dtype family before distinct-count refinement."""
    if pd.api.types.is_bool_dtype(series):
        return BOOL
    if pd.api.types.is_numeric_dtype(series):
        return NUM
    if pd.api.types.is_datetime64_any_dtype(series):
        return DATE
    return CAT


def classify(base_kind: str, distinct_count: int, count: int) -> str:
    """Reference dispatch order (SURVEY §2.1): CONST first, UNIQUE only for
    non-numeric, else the dtype family."""
    if distinct_count <= 1:
        return CONST
    if base_kind in (NUM, BOOL, DATE):
        return base_kind
    if count > 0 and distinct_count == count:
        return UNIQUE
    return CAT


def make_table_stats(
    n: int,
    variables: Dict[str, Dict[str, Any]],
    memorysize: float = float("nan"),
) -> Dict[str, Any]:
    """Table-level block: row/var counts, total missing %, var-type census
    (reference: base.describe() table assembly [U])."""
    nvar = len(variables)
    cells = n * nvar
    total_missing = (
        sum(v.get("n_missing", 0) for v in variables.values()) / cells
        if cells else 0.0
    )
    census = {k: 0 for k in ALL_KINDS}
    for v in variables.values():
        census[v["type"]] = census.get(v["type"], 0) + 1
    table = {
        "n": n,
        "nvar": nvar,
        "total_missing": total_missing,
        "memorysize": memorysize,
        "n_duplicates": None,  # not computed by the reference's Spark fork
    }
    table.update(census)
    return table


def derive_messages(
    variables: Dict[str, Dict[str, Any]],
    config,
) -> List[Message]:
    """Warnings block (reference: messages derivation, SURVEY §2.1):
    high cardinality, high missing, high zeros, skewness, constant, unique,
    correlation-rejected."""
    msgs: List[Message] = []
    for name, v in variables.items():
        kind = v["type"]
        if kind == CONST:
            msgs.append(Message(MSG_CONST, name, v.get("mode")))
        elif kind == UNIQUE:
            msgs.append(Message(MSG_UNIQUE, name))
        elif kind == CORR:
            msgs.append(Message(MSG_CORR, name,
                                (v.get("correlation_var"), v.get("correlation"))))
        elif kind == CAT:
            # distinct_count None = nested="opaque" declared it unknown
            # (a policy, not an estimator overflow) — neither message
            distinct = v.get("distinct_count")
            if distinct is not None \
                    and distinct > config.high_cardinality_threshold:
                msgs.append(Message(MSG_HIGH_CARDINALITY, name, distinct))
            if v.get("distinct_approx") and distinct is not None:
                # only CAT warns: approximate distincts can change the
                # UNIQUE/CAT call there, and only past both exact tiers
                msgs.append(Message(MSG_APPROX_DISTINCT, name, distinct))
        elif kind == NUM:
            skew = v.get("skewness")
            if skew is not None and np.isfinite(skew) and \
                    abs(skew) > config.skewness_threshold:
                msgs.append(Message(MSG_SKEWED, name, skew))
            if v.get("p_zeros", 0.0) > config.zeros_threshold:
                msgs.append(Message(MSG_HIGH_ZEROS, name, v["p_zeros"]))
        if v.get("p_missing", 0.0) > config.missing_threshold:
            msgs.append(Message(MSG_HIGH_MISSING, name, v["p_missing"]))
    return msgs


def variables_frame(variables: Dict[str, Dict[str, Any]]) -> pd.DataFrame:
    """The reference keeps per-column stats as a pandas DataFrame indexed by
    column name (base.describe() [U]); provide the same view."""
    if not variables:
        return pd.DataFrame()
    frame = pd.DataFrame.from_dict(variables, orient="index")
    frame.index.name = "variable"
    return frame


class VariablesView(Dict[str, Dict[str, Any]]):
    """``description['variables']`` serving BOTH access idioms.

    The reference kept per-column stats as a pandas DataFrame indexed by
    column name (SURVEY §1 L2→L3 seam), so migrating code does
    ``.loc[col, 'mean']`` / ``.index`` / ``.T``; tpuprof's native
    contract is a dict of per-column dicts (``variables['col']['mean']``).
    This dict subclass adds the DataFrame accessors, built lazily from
    the dict and cached (the stats dict is frozen once assembled)."""

    def _frame(self) -> pd.DataFrame:
        cached = getattr(self, "_cached_frame", None)
        if cached is None:
            cached = variables_frame(self)
            self._cached_frame = cached
        return cached

    @property
    def loc(self):
        return self._frame().loc

    @property
    def iloc(self):
        return self._frame().iloc

    @property
    def at(self):
        return self._frame().at

    @property
    def index(self):
        return self._frame().index

    @property
    def columns(self):
        return self._frame().columns

    @property
    def T(self):
        return self._frame().T

    def iterrows(self):
        return self._frame().iterrows()

    def to_frame(self) -> pd.DataFrame:
        """Explicit DataFrame copy of the per-column stats."""
        return self._frame().copy()


def validate_stats(stats: Dict[str, Any]) -> List[str]:
    """Contract check: return a list of problems (empty == valid).  Used by
    the dict-contract snapshot test (SURVEY §4.4) and debug asserts."""
    problems: List[str] = []
    for key in ("table", "variables", "freq", "correlations", "messages",
                "sample"):
        if key not in stats:
            problems.append(f"missing top-level key {key!r}")
    if problems:
        return problems
    for name, v in stats["variables"].items():
        kind = v.get("type")
        if kind not in FIELDS_BY_KIND:
            problems.append(f"{name}: unknown type {kind!r}")
            continue
        for field in FIELDS_BY_KIND[kind]:
            if field not in v:
                problems.append(f"{name} ({kind}): missing field {field!r}")
    for msg in stats["messages"]:
        if not isinstance(msg, Message):
            problems.append(f"message {msg!r} is not a Message")
    return problems


def reject_by_correlation(corr, ordered_cols, config) -> Dict[str, tuple]:
    """The reference's rejection rule (SURVEY §2.1), backend-agnostic:
    scanning numeric columns in order, reject a column whose |ρ| vs an
    *earlier kept* column exceeds ``corr_reject``; returns
    {rejected_col: (earlier_col, rho)}.  ``corr`` is a pandas DataFrame.
    The scan reads a numpy copy of ``corr``: a pandas lookup per pair would
    cost minutes at the 2,048 columns the port profiles."""
    overrides = set(config.correlation_overrides or ())
    kept: List[str] = []
    kept_at: List[int] = []          # corr column positions of ``kept``
    rejected: Dict[str, tuple] = {}
    if len(corr):
        mat = corr.to_numpy(dtype=np.float64)
        row_of = {c: i for i, c in enumerate(corr.index)}
        col_of = {c: j for j, c in enumerate(corr.columns)}
    for col in ordered_cols:
        if col in overrides:
            kept.append(col)
            kept_at.append(col_of[col] if len(corr) else -1)
            continue
        hit = None
        if kept and len(corr):
            rho = mat[row_of[col], kept_at]
            first = np.flatnonzero(np.isfinite(rho)
                                   & (np.abs(rho) > config.corr_reject))
            if first.size:
                hit = (kept[first[0]], float(rho[first[0]]))
        if hit:
            rejected[col] = hit
        else:
            kept.append(col)
            kept_at.append(col_of[col] if len(corr) else -1)
    return rejected


def rejected_variables(stats: Dict[str, Any],
                       threshold: Optional[float] = None) -> List[str]:
    """Reference: ProfileReport.get_rejected_variables(corr_threshold) scans
    the cached variables dict for CORR rows above the threshold (SURVEY
    §3.4) — no recomputation."""
    out = []
    for name, v in stats["variables"].items():
        if v["type"] == CORR:
            if threshold is None or abs(v.get("correlation") or 0) > threshold:
                out.append(name)
    return out
