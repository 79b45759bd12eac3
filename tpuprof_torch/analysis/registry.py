"""Checker registry + the one entrypoint (`run_lint`); counterpart of
``tpuprof/analysis/registry.py``.

A checker is a function ``(AnalysisContext) -> List[Finding]``
registered under a stable id with :func:`checker`.  Adding a checker is
three steps (ANALYSIS.md "Adding a checker"): write the function in
``tpuprof_torch/analysis/checkers/``, decorate it, import the module from
``checkers/__init__`` so registration runs.  The registry is ordered —
checkers run (and report) in registration order, so output stays diff-
stable across runs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from tpuprof_torch.analysis import suppress
from tpuprof_torch.analysis.context import AnalysisContext
from tpuprof_torch.analysis.model import Finding, LintReport

CheckerFn = Callable[[AnalysisContext], List[Finding]]

_CHECKERS: "Dict[str, CheckerFn]" = {}
_DOCS: Dict[str, str] = {}


def checker(checker_id: str, doc: str) -> Callable[[CheckerFn], CheckerFn]:
    """Register ``fn`` under ``checker_id`` (one line of ``doc`` feeds
    ``lint --list`` and the ANALYSIS.md catalogue)."""

    def _register(fn: CheckerFn) -> CheckerFn:
        if checker_id in _CHECKERS:
            raise ValueError(f"duplicate checker id {checker_id!r}")
        _CHECKERS[checker_id] = fn
        _DOCS[checker_id] = doc
        return fn

    return _register


def checker_ids() -> List[str]:
    _ensure_loaded()
    return list(_CHECKERS)


def checker_doc(checker_id: str) -> str:
    _ensure_loaded()
    return _DOCS[checker_id]


def _ensure_loaded() -> None:
    # importing the subpackage runs every @checker decorator exactly
    # once; lazy so `import tpuprof_torch.analysis` never pays the
    # checker imports
    from tpuprof_torch.analysis import checkers  # noqa: F401


def run_lint(root: str, only: Optional[Sequence[str]] = None,
             suppressions: Optional[str] = None,
             strict: bool = False,
             package: str = "tpuprof_torch") -> LintReport:
    """Run the invariant suite over the tree at ``root``.

    ``only`` limits to the named checker ids (unknown ids raise — a CI
    job invoking a misspelled checker must fail loudly, not pass
    empty).  ``strict`` ignores the suppression file entirely: every
    finding reports, none absorb.  Suppression bookkeeping (malformed
    + stale entries) reports through the pseudo-checker id
    ``suppressions``.  ``package="tpuprof"`` lints the reference's
    tree (pass its root ``LINT_SUPPRESSIONS`` as ``suppressions``).
    """
    _ensure_loaded()
    t0 = time.perf_counter()
    if only:
        unknown = [c for c in only if c not in _CHECKERS]
        if unknown:
            raise ValueError(
                f"unknown checker id(s) {unknown} — known: "
                f"{list(_CHECKERS)}")
        run_ids = [c for c in _CHECKERS if c in set(only)]
    else:
        run_ids = list(_CHECKERS)

    ctx = AnalysisContext(root, package=package)
    findings: List[Finding] = [
        Finding(checker="parse", path=relpath, line=0,
                ident=f"parse:{relpath}",
                message=f"module failed to parse: {err}")
        for relpath, err in ctx.parse_errors
    ]
    for cid in run_ids:
        found = _CHECKERS[cid](ctx)
        # checker order is registration order; within a checker, sort
        # by location so output is stable across dict-iteration quirks
        findings.extend(sorted(found,
                               key=lambda f: (f.path, f.line, f.ident)))

    report = LintReport(root=ctx.root, findings=findings,
                        checkers_run=run_ids)
    if not strict:
        entries, bad = suppress.load(root, suppressions)
        suppressed, stale = suppress.apply(
            findings, entries, suppressions or suppress.DEFAULT_FILE)
        report.suppressed = suppressed
        # a partial run (--only) cannot judge staleness: entries for
        # checkers that did not run are legitimately un-hit
        report.findings = report.findings + bad \
            + (stale if only is None else [])
    report.wall_s = time.perf_counter() - t0
    return report
