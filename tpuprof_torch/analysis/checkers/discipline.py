"""Checker ``runtime-discipline`` — locked seams stay locked
(counterpart of ``tpuprof/analysis/checkers/discipline.py``).

Two disciplines, both postmortems turned invariants:

* **runner seam** — runner construction is a cache lookup
  (``serve/cache.acquire_runner``), never a direct call: a bypass
  rebuilds what the cache keeps warm (the loaded kernel libraries, the
  runner's device buffers) and — worse — escapes the process-wide
  dispatch lock's assumptions about who owns the devices.  In the port
  the cache hands out a ``MeshRunner`` over several devices or a
  one-device ``Runner`` (``serve/cache.py``), so the seam covers both
  classes.  Direct construction is legal only inside the cache itself
  and inside the definition modules, ``runtime/mesh.py`` (whose mesh
  holds one ``Runner`` a device) and ``runtime/runner.py``.  The
  reference has no ``Runner``: over ``package="tpuprof"`` the seam is
  its ``MeshRunner`` one.
* **fault sites** — every site-string literal handed to
  ``faults.hit``/``faults.mangle`` or passed as a ``site=`` keyword
  must be declared in the package's ``testing/faults.SITES``, and every
  declared site must still have a live use.  An undeclared site is
  invisible to the ``TPUPROF_FAULTS`` grammar's users (nothing
  documents it can be injected); a dead declaration documents an
  injection point that no longer exists.

Dynamic site expressions (``faults.hit(site, ...)`` inside the guard,
where the caller supplies the literal) are skipped — the caller's
literal is collected at ITS call site instead.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tpuprof_torch.analysis.context import (AnalysisContext, call_name,
                                      const_str)
from tpuprof_torch.analysis.model import Finding
from tpuprof_torch.analysis.registry import checker

#: modules allowed to construct a runner directly: the cache (the one
#: blessed seam) and the definition modules
RUNNER_SEAM_MODULES = ("serve/cache.py", "runtime/mesh.py",
                       "runtime/runner.py")

#: runner class -> the ident prefix of a direct construction
RUNNER_CLASSES = {"MeshRunner": "mesh-runner", "Runner": "runner"}

_FAULTS_MODULE = "testing/faults.py"


def _declared_sites(ctx: AnalysisContext
                    ) -> Tuple[Optional[Set[str]], str, int]:
    """(SITES members, faults.py relpath, assignment line) — None set
    when the registry is missing."""
    sf = ctx.file("/" + _FAULTS_MODULE)
    if sf is None:
        return None, f"{ctx.package}/{_FAULTS_MODULE}", 0
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "SITES"
                        for t in node.targets):
            value = node.value
            if isinstance(value, ast.Call) and value.args:
                value = value.args[0]   # frozenset({...})
            if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
                return ({v for e in value.elts
                         if (v := const_str(e)) is not None},
                        sf.relpath, node.lineno)
    return None, sf.relpath, 0


def _used_sites(ctx: AnalysisContext) -> Dict[str, Tuple[str, int]]:
    """site literal -> first (file, line) using it: faults.hit/mangle
    first args plus any ``site="..."`` keyword anywhere in the
    package (guards, watchdogs, deadline constructors)."""
    out: Dict[str, Tuple[str, int]] = {}
    for sf, node in ctx.iter_calls():
        if sf.relpath.replace("\\", "/").endswith(_FAULTS_MODULE):
            continue            # the registry module itself
        tail = call_name(node).split(".")[-1]
        if tail in ("hit", "mangle") and node.args:
            v = const_str(node.args[0])
            if v is not None:
                out.setdefault(v, (sf.relpath, node.lineno))
        for kw in node.keywords:
            if kw.arg == "site":
                v = const_str(kw.value)
                if v is not None:
                    out.setdefault(v, (sf.relpath, node.lineno))
    return out


@checker(
    "runtime-discipline",
    "MeshRunner construction only through serve/cache; every faults "
    "site literal declared in the central SITES registry, no dead "
    "declarations")
def check_discipline(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []

    for sf, node in ctx.iter_calls():
        cls = call_name(node).split(".")[-1]
        if cls in RUNNER_CLASSES:
            norm = sf.relpath.replace("\\", "/")
            if not any(norm.endswith(m) for m in RUNNER_SEAM_MODULES):
                findings.append(Finding(
                    checker="runtime-discipline", path=sf.relpath,
                    line=node.lineno,
                    ident=f"{RUNNER_CLASSES[cls]}:{norm}",
                    message=f"direct {cls} construction bypasses "
                            "the serve/cache.acquire_runner seam — "
                            "every profile path must draw runners "
                            "from the keyed compiled-program cache"))

    declared, faults_path, faults_line = _declared_sites(ctx)
    used = _used_sites(ctx)
    if declared is None:
        findings.append(Finding(
            checker="runtime-discipline", path=faults_path, line=0,
            ident="sites:missing-registry",
            message=f"{ctx.package}/testing/faults.py declares no SITES "
                    "registry — fault-site literals have no central "
                    "source of truth"))
        return findings
    for site, (path, line) in sorted(used.items()):
        if site not in declared:
            findings.append(Finding(
                checker="runtime-discipline", path=path, line=line,
                ident=f"site:{site}:undeclared",
                message=f"fault/guard site {site!r} is not declared "
                        "in faults.SITES — add it to the central "
                        "registry (and the faults.py site table) so "
                        "TPUPROF_FAULTS users can discover it"))
    for site in sorted(declared - set(used)):
        findings.append(Finding(
            checker="runtime-discipline", path=faults_path,
            line=faults_line, ident=f"site:{site}:dead",
            message=f"faults.SITES declares {site!r} but no call site "
                    "uses it — dead registry entry"))
    return findings
