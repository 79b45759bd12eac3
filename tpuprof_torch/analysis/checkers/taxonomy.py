"""Checker ``error-taxonomy`` — errors.py ⇄ exit codes ⇄ ROBUSTNESS.md
(counterpart of ``tpuprof/analysis/checkers/taxonomy.py``).

The typed-error contract (ROBUSTNESS.md "degradation ladder"): every
exception class defined in the package's ``errors.py`` has a row in the
ROBUSTNESS.md taxonomy table, the row's documented exit code equals
what ``errors.exit_code`` would compute (via the ``_EXIT_CODES``
ordered mapping, inheritance included — subclasses like
``CorruptResultError`` legitimately share their parent's code), every
``_EXIT_CODES`` entry names a live class listed in ``TYPED_ERRORS``,
distinct ``_EXIT_CODES`` entries never collide on a code, and the doc
table names no dead classes.  The port defines the reference's classes
with the reference's codes, so the reference's table is its contract.

Everything is read from the AST, not by importing ``errors`` — so the
checker renders the same verdict on a synthetic (deliberately broken)
tree as on the real one.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from tpuprof_torch.analysis.context import AnalysisContext
from tpuprof_torch.analysis.model import Finding
from tpuprof_torch.analysis.registry import checker

_ROB = "ROBUSTNESS.md"
# the taxonomy table's shape: | `Class` | `Base` | meaning | code |
_ROW_RE = re.compile(
    r"^\|\s*`([A-Za-z_][A-Za-z0-9_]*)`\s*\|.*\|\s*([^|]+?)\s*\|$")


def _classes(tree: ast.Module) -> Dict[str, Tuple[List[str], int]]:
    """class name -> (base names, line) for every top-level class."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
            out[node.name] = (bases, node.lineno)
    return out


def _exit_pairs(tree: ast.Module) -> List[Tuple[str, int, int]]:
    """(class name, code, line) in declaration order from the
    ``_EXIT_CODES`` tuple-of-pairs assignment."""
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "_EXIT_CODES"
                        for t in node.targets) \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            pairs = []
            for elt in node.value.elts:
                if isinstance(elt, (ast.Tuple, ast.List)) \
                        and len(elt.elts) == 2 \
                        and isinstance(elt.elts[0], ast.Name) \
                        and isinstance(elt.elts[1], ast.Constant):
                    pairs.append((elt.elts[0].id,
                                  int(elt.elts[1].value), elt.lineno))
            return pairs
    return []


def _typed_errors(tree: ast.Module) -> Set[str]:
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name)
                        and t.id == "TYPED_ERRORS"
                        for t in node.targets) \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return {e.id for e in node.value.elts
                    if isinstance(e, ast.Name)}
    return set()


def _ancestors(name: str, classes: Dict[str, Tuple[List[str], int]]
               ) -> Set[str]:
    seen: Set[str] = set()
    todo = [name]
    while todo:
        cur = todo.pop()
        for base in classes.get(cur, ([], 0))[0]:
            if base not in seen:
                seen.add(base)
                todo.append(base)
    return seen


def _computed_code(name: str, classes, pairs) -> int:
    """What ``errors.exit_code`` returns for an instance of ``name``:
    the FIRST _EXIT_CODES entry the class is-a (order matters — the
    mapping's own comment), 1 when nothing matches."""
    lineage = {name} | _ancestors(name, classes)
    for cls, code, _line in pairs:
        if cls in lineage:
            return code
    return 1


@checker(
    "error-taxonomy",
    "errors.py classes ⇄ _EXIT_CODES ⇄ ROBUSTNESS.md taxonomy table, "
    "bijective (subclass code-sharing allowed)")
def check_taxonomy(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    sf = ctx.file("/errors.py")
    if sf is None:
        return [Finding(
            checker="error-taxonomy", path=f"{ctx.package}/errors.py",
            line=0,
            ident="errors:missing",
            message="no errors.py module found — the taxonomy cannot "
                    "be checked")]
    classes = _classes(sf.tree)
    pairs = _exit_pairs(sf.tree)
    typed = _typed_errors(sf.tree)

    doc = ctx.doc_text(_ROB)
    doc_rows: Dict[str, Tuple[str, int]] = {}
    if doc is None:
        findings.append(Finding(
            checker="error-taxonomy", path=_ROB, line=0,
            ident="doc:missing",
            message="ROBUSTNESS.md not found — the taxonomy table "
                    "cannot be checked"))
    else:
        for i, line in enumerate(doc.splitlines(), 1):
            m = _ROW_RE.match(line.strip())
            if m and m.group(1) in classes:
                doc_rows[m.group(1)] = (m.group(2), i)
            elif m and m.group(1)[:1].isupper() \
                    and m.group(1) not in doc_rows:
                # CamelCase row with no matching class: dead doc row
                # (snake_case rows belong to the config table —
                # config-surface owns those)
                findings.append(Finding(
                    checker="error-taxonomy", path=_ROB, line=i,
                    ident=f"{m.group(1)}:doc-dead",
                    message=f"ROBUSTNESS.md taxonomy table documents "
                            f"'{m.group(1)}' but errors.py defines no "
                            "such class — stale row"))

    for name, (_bases, lineno) in classes.items():
        code = _computed_code(name, classes, pairs)
        if doc is not None and name not in doc_rows:
            findings.append(Finding(
                checker="error-taxonomy", path=sf.relpath, line=lineno,
                ident=f"{name}:undocumented",
                message=f"error class '{name}' has no ROBUSTNESS.md "
                        "taxonomy-table row — every typed failure "
                        "shape must be documented with its exit code"))
        elif doc is not None:
            documented, doc_line = doc_rows[name]
            digits = re.findall(r"\d+", documented)
            if digits:
                if int(digits[-1]) != code:
                    findings.append(Finding(
                        checker="error-taxonomy", path=_ROB,
                        line=doc_line, ident=f"{name}:code-mismatch",
                        message=f"ROBUSTNESS.md documents exit "
                                f"{digits[-1]} for '{name}' but "
                                f"errors.exit_code computes {code}"))
            elif code != 1:
                findings.append(Finding(
                    checker="error-taxonomy", path=_ROB, line=doc_line,
                    ident=f"{name}:code-mismatch",
                    message=f"ROBUSTNESS.md marks '{name}' as having "
                            f"no exit code but errors.exit_code "
                            f"computes {code}"))

    for cls, _code, lineno in pairs:
        if cls not in classes:
            findings.append(Finding(
                checker="error-taxonomy", path=sf.relpath, line=lineno,
                ident=f"{cls}:orphan-exit-code",
                message=f"_EXIT_CODES maps '{cls}' which errors.py "
                        "does not define — orphan exit-code entry"))
        elif typed and cls not in typed:
            findings.append(Finding(
                checker="error-taxonomy", path=sf.relpath, line=lineno,
                ident=f"{cls}:not-typed",
                message=f"_EXIT_CODES maps '{cls}' but TYPED_ERRORS "
                        "does not list it — the CLI would print a "
                        "traceback for an error with a documented "
                        "exit code"))
    seen_codes: Dict[int, str] = {}
    for cls, code, lineno in pairs:
        if code in seen_codes:
            findings.append(Finding(
                checker="error-taxonomy", path=sf.relpath, line=lineno,
                ident=f"{cls}:code-collision",
                message=f"_EXIT_CODES gives '{cls}' exit {code}, "
                        f"already claimed by '{seen_codes[code]}' — "
                        "codes must be distinct (subclasses share via "
                        "inheritance, not duplicate entries)"))
        else:
            seen_codes[code] = cls
    return findings
