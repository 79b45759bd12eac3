"""Findings model of the port's lint (counterpart of
``tpuprof/analysis/model.py``; ANALYSIS.md).

A :class:`Finding` is one violated invariant at one location.  Its
``ident`` is the STABLE identity the suppression file matches against —
never a line number (line numbers churn on every edit; a suppression
keyed to one would silently stop matching).  The JSON export
(``python -m tpuprof_torch lint --json``) carries the reference's
``tpuprof-lint-v1`` schema id, and the same keys, so CI consumers gate on
one format for both packages, not on stdout prose.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

LINT_SCHEMA = "tpuprof-lint-v1"

#: findings -> CLI exit 2 (errors.LintFindingsError, an InputError: "the
#: tree the user asked us to bless is not blessable")
SEVERITIES = ("error", "warn")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``checker``   the checker id that produced it (ANALYSIS.md catalogue)
    ``path``      root-relative file the violation lives in (a doc or a
                  module)
    ``line``      1-based line (0 = whole-file / cross-file finding)
    ``ident``     stable suppression identity, e.g.
                  ``serve_workers:doc`` or ``metric:tpuprof_x:undocumented``
    ``message``   the human sentence: what drifted and what the fix is
    """

    checker: str
    path: str
    line: int
    ident: str
    message: str
    severity: str = "error"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.checker}] {self.message}"


@dataclasses.dataclass
class LintReport:
    """Everything one lint run produced, suppressions applied.

    ``findings`` is every finding in checker order; ``suppressed``
    maps a finding's ident to the suppression reason that absorbed it.
    """

    root: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    suppressed: Dict[Finding, str] = dataclasses.field(default_factory=dict)
    checkers_run: List[str] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if f not in self.suppressed]

    def counts_by_checker(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.unsuppressed():
            out[f.checker] = out.get(f.checker, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": LINT_SCHEMA,
            "root": self.root,
            "checkers": list(self.checkers_run),
            "wall_s": round(self.wall_s, 4),
            "findings": [
                {
                    "checker": f.checker,
                    "file": f.path,
                    "line": f.line,
                    "ident": f.ident,
                    "severity": f.severity,
                    "message": f.message,
                    "suppressed": f in self.suppressed,
                    **({"reason": self.suppressed[f]}
                       if f in self.suppressed else {}),
                }
                for f in self.findings
            ],
            "counts_by_checker": self.counts_by_checker(),
            "suppressed_count": len(self.suppressed),
            "clean": not self.unsuppressed(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=False)
