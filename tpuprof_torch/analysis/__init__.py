"""tpuprof_torch/analysis — the AST-enforced invariant suite of the port
(counterpart of ``tpuprof/analysis``; ANALYSIS.md).

The profiler's correctness rests on conventions — atomic tmp+rename
publication, dot-prefixed tmp names, the config⇄env⇄CLI⇄doc surface,
metric/event names synced to their docs, the error⇄exit-code taxonomy,
the locked runner seam — that the port shares with the reference: the
same config fields and env twins, the same metric names in
OBSERVABILITY.md, the same error classes and exit codes in ROBUSTNESS.md,
the same ``EVENT_SCHEMA``, the same atomic publication in the same durable
modules.  ``python -m tpuprof_torch lint`` machine-checks them over the
port's own tree with the reference's checkers, reading the reference's
documents as the contract both packages keep.  Pure host code: it touches
no device and its modules import nothing of ``torch``.

Public surface::

    from tpuprof_torch.analysis import run_lint
    report = run_lint("/path/to/repo")        # LintReport
    report.unsuppressed()                     # [] = clean tree
    report.to_json()                          # tpuprof-lint-v1

Exit-code contract (CLI ``lint``): clean tree → 0, any unsuppressed
finding → 2 (:class:`tpuprof_torch.errors.LintFindingsError`).
"""

from tpuprof_torch.analysis.model import LINT_SCHEMA, Finding, LintReport
from tpuprof_torch.analysis.registry import (checker, checker_doc,
                                             checker_ids, run_lint)
from tpuprof_torch.obs import metrics as _obs_metrics

#: one count per unsuppressed finding, labelled by checker id — a CI
#: lint run with metrics on exposes drift the same way every other
#: subsystem exposes failure (OBSERVABILITY.md "Lint")
FINDINGS_TOTAL = _obs_metrics.counter(
    "tpuprof_lint_findings_total",
    "unsuppressed lint findings by checker id (tpuprof/analysis)")


def observe(report: LintReport) -> None:
    """Record a finished run's findings on the process registry (the
    CLI calls this; library callers may too)."""
    for f in report.unsuppressed():
        FINDINGS_TOTAL.inc(checker=f.checker)


__all__ = ["Finding", "LintReport", "LINT_SCHEMA", "run_lint",
           "checker", "checker_ids", "checker_doc", "observe",
           "FINDINGS_TOTAL"]
