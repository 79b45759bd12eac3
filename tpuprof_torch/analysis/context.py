"""Shared parse state for one lint run (counterpart of
``tpuprof/analysis/context.py``).

Checkers never touch the filesystem directly: the context loads the
package tree ONCE (ast.parse per module, parent links, docs, the
EVENT_SCHEMA test contract) and every checker reads from it.  That is
both the speed contract (the whole suite stays cheap enough to live in
tier-1 forever) and the seam that lets tests lint SYNTHETIC trees: point
:class:`AnalysisContext` at a tmp dir holding a doctored
``tpuprof_torch/`` + docs and the checkers see only that.  The docs and
the event contract are the reference's: the two packages share them.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Tuple

#: docs the checkers parse, looked up root-relative
DOC_NAMES = ("README.md", "OBSERVABILITY.md", "ROBUSTNESS.md",
             "ARTIFACTS.md", "ANALYSIS.md")

#: where the JSONL event contract lives (tests/test_obs_smoke.py keeps
#: the runtime validator; the lint obs checker reads the same dict so
#: there is exactly one schema)
EVENT_SCHEMA_FILE = os.path.join("tests", "test_obs_smoke.py")


class SourceFile:
    """One parsed module: root-relative path, source text, AST, and a
    child->parent node map (built lazily — most files never need it)."""

    def __init__(self, relpath: str, text: str, tree: ast.Module):
        self.relpath = relpath
        self.text = text
        self.tree = tree
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents.get(node)


def call_name(node: ast.AST) -> str:
    """Best-effort dotted name of a call target: ``os.path.join``,
    ``faults.hit``, ``open``.  Unresolvable pieces render as ``?`` so
    ``endswith`` checks still work on the known tail."""
    if isinstance(node, ast.Call):
        node = node.func
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def literal_head(node: ast.AST) -> Optional[str]:
    """The LEADING literal text of a string-producing expression — the
    part of a filename a prefix scan would see.  Handles plain
    constants, f-strings (first chunk), ``"." + x`` concatenations and
    ``os.path.join(..., tail)`` (delegates to the last arg).  None =
    the expression starts with runtime data (nothing provable)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        return literal_head(node.values[0])
    if isinstance(node, ast.FormattedValue):
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return literal_head(node.left)
    if isinstance(node, ast.Call) and call_name(node).endswith("join") \
            and node.args:
        return literal_head(node.args[-1])
    return None


class AnalysisContext:
    """Parsed view of one repo tree rooted at ``root``.

    ``package`` is the package directory name under the root
    (``tpuprof_torch`` for the port's tree; ``tpuprof`` lints the
    reference's with the same checkers; synthetic test trees mirror
    either).
    Modules that fail to parse surface as findings from every checker's
    caller (``parse_errors``) rather than crashing the run.
    """

    def __init__(self, root: str, package: str = "tpuprof_torch"):
        self.root = os.path.abspath(root)
        self.package = package
        self.files: List[SourceFile] = []
        self.parse_errors: List[Tuple[str, str]] = []
        self._docs: Dict[str, Optional[str]] = {}
        pkg_dir = os.path.join(self.root, package)
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                abspath = os.path.join(dirpath, name)
                relpath = os.path.relpath(abspath, self.root)
                try:
                    with open(abspath, encoding="utf-8") as fh:
                        text = fh.read()
                    tree = ast.parse(text, filename=relpath)
                except (OSError, SyntaxError) as exc:
                    self.parse_errors.append((relpath, str(exc)))
                    continue
                self.files.append(SourceFile(relpath, text, tree))

    # -- lookups ------------------------------------------------------------

    def file(self, *suffixes: str) -> Optional[SourceFile]:
        """The first package module whose root-relative path ends with
        one of ``suffixes`` (``/``-normalized)."""
        for sf in self.files:
            norm = sf.relpath.replace(os.sep, "/")
            if any(norm.endswith(s) for s in suffixes):
                return sf
        return None

    def doc_text(self, name: str) -> Optional[str]:
        if name not in self._docs:
            try:
                with open(os.path.join(self.root, name),
                          encoding="utf-8") as fh:
                    self._docs[name] = fh.read()
            except OSError:
                self._docs[name] = None
        return self._docs[name]

    def doc_line(self, name: str, needle: str) -> int:
        """1-based first line of ``needle`` in doc ``name`` (0 = not
        found / no doc) — findings point at the drifted doc row."""
        text = self.doc_text(name)
        if not text:
            return 0
        for i, line in enumerate(text.splitlines(), 1):
            if needle in line:
                return i
        return 0

    # -- cross-file AST sweeps (shared by several checkers) -----------------

    def iter_calls(self) -> Iterator[Tuple[SourceFile, ast.Call]]:
        for sf in self.files:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    yield sf, node

    def string_literals(self) -> Iterator[Tuple[SourceFile, str]]:
        for sf in self.files:
            for node in ast.walk(sf.tree):
                v = const_str(node)
                if v is not None:
                    yield sf, v

    def event_schema_keys(self) -> Optional[Dict[str, int]]:
        """kind -> line of the ``EVENT_SCHEMA`` dict in the obs smoke
        test — the one JSONL event contract.  None = the contract file
        is missing or holds no EVENT_SCHEMA (itself a finding)."""
        path = os.path.join(self.root, EVENT_SCHEMA_FILE)
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=EVENT_SCHEMA_FILE)
        except (OSError, SyntaxError):
            return None
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "EVENT_SCHEMA"
                            for t in node.targets) \
                    and isinstance(node.value, ast.Dict):
                out = {}
                for k in node.value.keys:
                    v = const_str(k)
                    if v is not None:
                        out[v] = k.lineno
                return out
        return None
