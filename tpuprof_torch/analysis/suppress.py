"""The committed suppression file (counterpart of
``tpuprof/analysis/suppress.py``; ANALYSIS.md "Suppressions").

The port's file is ``tpuprof_torch/LINT_SUPPRESSIONS``, inside its own
package, beside the reference's root ``LINT_SUPPRESSIONS``.

One entry per line::

    <checker-id>  <ident-glob>  <reason — mandatory prose>

``#`` comments and blank lines are ignored.  The ident-glob is an
fnmatch pattern against :attr:`Finding.ident` (NEVER file:line — line
numbers churn; idents are stable names like ``serve_workers:doc``).
``*`` as the checker id matches any checker.

Two rules keep the file honest:

* **no silent allowlisting** — an entry with no reason text is itself
  a finding (checker id ``suppressions``), so nothing gets waved
  through without a recorded why;
* **no rot** — an entry that matched nothing this run is a STALE
  finding: the violation it excused is gone, delete the line (or the
  glob quietly widened past its purpose).
"""

from __future__ import annotations

import fnmatch
import os
from typing import Dict, List, Optional, Tuple

from tpuprof_torch.analysis.model import Finding

#: root-relative default location of the port's committed suppression file
DEFAULT_FILE = "tpuprof_torch/LINT_SUPPRESSIONS"


class Suppression:
    def __init__(self, checker: str, pattern: str, reason: str,
                 line: int):
        self.checker = checker
        self.pattern = pattern
        self.reason = reason
        self.line = line
        self.hits = 0

    def matches(self, finding: Finding) -> bool:
        if self.checker not in ("*", finding.checker):
            return False
        return fnmatch.fnmatchcase(finding.ident, self.pattern)


def load(root: str, path: Optional[str] = None
         ) -> Tuple[List[Suppression], List[Finding]]:
    """(entries, file-format findings).  A missing file is an empty —
    perfectly clean — suppression set, not an error."""
    relpath = path or DEFAULT_FILE
    abspath = relpath if os.path.isabs(relpath) \
        else os.path.join(root, relpath)
    try:
        with open(abspath, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return [], []
    entries: List[Suppression] = []
    bad: List[Finding] = []
    shown = os.path.relpath(abspath, root) \
        if abspath.startswith(os.path.abspath(root) + os.sep) else relpath
    for i, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 2)
        if len(parts) < 3 or not parts[2].strip():
            bad.append(Finding(
                checker="suppressions", path=shown, line=i,
                ident=f"malformed:{i}",
                message="suppression entries are '<checker> "
                        "<ident-glob> <reason>' — the reason prose is "
                        "mandatory (no silent allowlisting): "
                        f"{line!r}"))
            continue
        entries.append(Suppression(parts[0], parts[1], parts[2].strip(),
                                   i))
    return entries, bad


def apply(findings: List[Finding], entries: List[Suppression],
          suppression_path: str) -> Tuple[Dict[Finding, str],
                                          List[Finding]]:
    """(suppressed finding -> reason, stale-entry findings)."""
    suppressed: Dict[Finding, str] = {}
    for f in findings:
        for s in entries:
            if s.matches(f):
                s.hits += 1
                suppressed[f] = s.reason
                break
    stale = [
        Finding(
            checker="suppressions", path=suppression_path, line=s.line,
            ident=f"stale:{s.checker}:{s.pattern}",
            message=f"suppression '{s.checker} {s.pattern}' matched no "
                    "finding this run — the violation it excused is "
                    "gone; delete the entry")
        for s in entries if s.hits == 0
    ]
    return suppressed, stale
