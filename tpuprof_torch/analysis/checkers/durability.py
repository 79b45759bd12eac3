"""Checker ``durability`` — atomic publication of every durable file
(counterpart of ``tpuprof/analysis/checkers/durability.py``).

Scope: the modules that write into directories other processes scan or
re-read across crashes (spool, fleet dir, artifact chains, checkpoint
paths) — :data:`DURABLE_MODULES`.  Three rules, each a shipped-race
postmortem turned invariant:

* **bare-write** — a function that opens a file for writing must be an
  atomic-write seam: the same function fsyncs the handle AND publishes
  via ``os.replace``/``os.link`` (rename-after-fsync).  A bare
  ``open(path, "w")`` (or ``Path.write_bytes``/``write_text``) into a
  durable directory can be observed torn by a concurrent reader or
  survive a crash half-written.
* **tmp-name** — the seam's temp file must be DOT-PREFIXED in its
  basename.  Suffix-style ``path + ".tmp"`` names share the real
  file's prefix, so every ``startswith("part.")``-style scan matches
  the in-flight write (``part.<phase>.<host>.<seq>.tmp.<pid>`` read torn
  by a concurrent finish barrier, a race the reference shipped once).
* **scan-unfiltered** — a directory scan (``os.listdir``/``scandir``)
  over a durable directory must filter names: a prefix/suffix/regex
  test (which a dot-prefixed tmp can never pass) or an explicit
  dot/``.tmp.`` exclusion.  An unfiltered iteration reads whatever is
  mid-flight.

Emptiness probes (``if not os.listdir(d)``) are exempt — they touch no
names.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from tpuprof_torch.analysis.context import (AnalysisContext, SourceFile,
                                      call_name, const_str, literal_head)
from tpuprof_torch.analysis.model import Finding
from tpuprof_torch.analysis.registry import checker

#: root-relative suffixes of the modules under the durability contract
#: (ANALYSIS.md lists them; extend when a new module starts publishing
#: durable files).  The reference's suffixes: the port's modules of the
#: same names publish the same files.
DURABLE_MODULES = (
    "runtime/checkpoint.py",
    "runtime/fleet.py",
    "runtime/aot.py",
    "artifact/store.py",
    "serve/server.py",
    "serve/scheduler.py",
    "serve/watch.py",
    "serve/http.py",
    "obs/fleet.py",
    "warehouse/columnar.py",
    "warehouse/store.py",
)

_WRITE_CHARS = set("wax+")
_FILTER_ATTRS = ("startswith", "endswith", "match", "fullmatch")


def _walk_shallow(fn: ast.AST):
    """Walk a function's OWN body, not descending into nested defs —
    a closure's writes are the closure's findings, once."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


def _embedded_literals(node: ast.AST) -> List[str]:
    """Every constant string inside a name-building expression."""
    out = []
    for n in ast.walk(node):
        v = const_str(n)
        if v is not None:
            out.append(v)
    return out


def _is_write_open(node: ast.Call) -> bool:
    if not call_name(node).endswith("open"):
        return False
    mode: Optional[ast.AST] = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    m = const_str(mode)
    return bool(m) and bool(set(m) & _WRITE_CHARS)


def _resolve_in_function(fn: ast.AST, expr: ast.AST) -> ast.AST:
    """If ``expr`` is a Name assigned once in ``fn``, the assigned
    value; else ``expr`` itself."""
    if not isinstance(expr, ast.Name):
        return expr
    assigned = [n.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == expr.id
                        for t in n.targets)]
    return assigned[0] if len(assigned) == 1 else expr


def _listdir_is_probe(sf: SourceFile, node: ast.Call) -> bool:
    """True when the scan result is only truth-tested (emptiness),
    never iterated: ``if not os.listdir(d)`` / ``len(os.listdir(d))``."""
    parent = sf.parent(node)
    if isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.Not):
        return True
    if isinstance(parent, ast.Call) and call_name(parent) == "len":
        return True
    if isinstance(parent, (ast.If, ast.While, ast.BoolOp, ast.Compare)):
        return True
    return False


@checker(
    "durability",
    "durable writes go tmp→fsync→rename through dot-prefixed temp "
    "names, and durable-directory scans filter in-flight files out")
def check_durability(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        norm = sf.relpath.replace("\\", "/")
        if not any(norm.endswith(m) for m in DURABLE_MODULES):
            continue
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            write_opens = []
            has_fsync = has_publish = False
            for node in _walk_shallow(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if _is_write_open(node):
                    write_opens.append(node)
                elif name.endswith(".fsync"):
                    has_fsync = True
                elif name.endswith((".replace", ".link", ".rename")):
                    has_publish = True
                elif name.endswith((".write_bytes", ".write_text")):
                    findings.append(Finding(
                        checker="durability", path=sf.relpath,
                        line=node.lineno,
                        ident=f"{norm}:{fn.name}:path-write",
                        message=f"{fn.name}() publishes via "
                                "Path.write_bytes/write_text — durable "
                                "files must go through an atomic "
                                "tmp+fsync+rename seam"))
            if not write_opens:
                continue
            if not (has_fsync and has_publish):
                missing = []
                if not has_fsync:
                    missing.append("os.fsync before publication")
                if not has_publish:
                    missing.append("os.replace/os.link publication")
                for node in write_opens:
                    findings.append(Finding(
                        checker="durability", path=sf.relpath,
                        line=node.lineno,
                        ident=f"{norm}:{fn.name}:bare-write",
                        message=f"{fn.name}() opens a file for writing "
                                "in a durable module but is not an "
                                "atomic-write seam — missing "
                                + " and ".join(missing)))
                continue
            # the function IS a seam: its temp name must be dot-prefixed
            for node in write_opens:
                target = _resolve_in_function(fn, node.args[0]) \
                    if node.args else None
                if target is None:
                    continue
                head = literal_head(target)
                if head is None:
                    # the name STARTS with runtime data.  If a later
                    # literal chunk says "tmp", this is suffix-style
                    # naming (`path + ".tmp"`, `f"{path}.tmp.{pid}"`)
                    # — the temp shares the real file's prefix, the
                    # exact shape of the prefix-scan race — flag it.  A bare
                    # parameter with no tmp evidence is unprovable
                    # here; its construction site is in scope instead.
                    if any("tmp" in s for s in _embedded_literals(target)):
                        findings.append(Finding(
                            checker="durability", path=sf.relpath,
                            line=node.lineno,
                            ident=f"{norm}:{fn.name}:tmp-name",
                            message=f"{fn.name}() builds its temp name "
                                    "as a SUFFIX of the real path — "
                                    "the temp shares the published "
                                    "file's prefix, so prefix scans "
                                    "match the in-flight write; use a "
                                    "dot-prefixed basename "
                                    "(.<name>.tmp.<pid>) instead"))
                    continue
                if not head.startswith("."):
                    findings.append(Finding(
                        checker="durability", path=sf.relpath,
                        line=node.lineno,
                        ident=f"{norm}:{fn.name}:tmp-name",
                        message=f"{fn.name}() writes its temp file "
                                f"under a name starting {head!r} — tmp "
                                "basenames must be dot-prefixed so no "
                                "prefix scan can ever match an "
                                "in-flight write (the "
                                "'part.*.tmp.<pid>' race)"))
        # directory scans
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            scans = []
            has_filter = False
            for node in _walk_shallow(fn):
                if isinstance(node, ast.Call):
                    name = call_name(node)
                    if name.endswith((".listdir", ".scandir")):
                        scans.append(node)
                    elif name.split(".")[-1] in _FILTER_ATTRS:
                        has_filter = True
                elif isinstance(node, ast.Compare) \
                        and any(isinstance(op, (ast.In, ast.NotIn))
                                for op in node.ops):
                    # explicit '".tmp." in name' style exclusion
                    if const_str(node.left) is not None or any(
                            const_str(c) is not None
                            for c in node.comparators):
                        has_filter = True
            for node in scans:
                if _listdir_is_probe(sf, node):
                    continue
                if not has_filter:
                    findings.append(Finding(
                        checker="durability", path=sf.relpath,
                        line=node.lineno,
                        ident=f"{norm}:{fn.name}:scan-unfiltered",
                        message=f"{fn.name}() iterates a durable "
                                "directory listing with no name filter "
                                "— in-flight (dot-prefixed) temp files "
                                "would be read; add a prefix/suffix/"
                                "regex test or an explicit dot "
                                "exclusion"))
    return findings
