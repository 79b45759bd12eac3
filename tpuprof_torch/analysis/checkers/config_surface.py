"""Checker ``config-surface`` — config ⇄ env ⇄ CLI ⇄ doc completeness
(counterpart of ``tpuprof/analysis/checkers/config_surface.py``).

Every runtime knob must be reachable four ways (the ROBUSTNESS.md
config-table contract grown from the ``resolve_*`` convention): the
``ProfilerConfig`` field, a ``resolve_*`` resolver, a ``TPUPROF_*``
env twin, a CLI flag, and a documentation row.  A knob missing a leg
is un-deployable somewhere: no env twin means wrappers cannot tune it,
no CLI flag means operators cannot, no doc row means nobody knows it
exists.

Scope rule (ANALYSIS.md): a field enters the contract when ANY leg
beyond the dataclass field exists — a matching ``TPUPROF_<FIELD>`` env
literal anywhere in the package, a name-matching ``resolve_*``
function, or a config-table row.  Once in scope, ALL legs are
required.  Pure constructor parity knobs (``bins``, ``corr_reject``
...) that never grew an env/resolver/doc surface stay out of scope —
they are the reference facade, not runtime knobs.

Leg matching is by name (``field`` ⇄ ``TPUPROF_FIELD`` ⇄ ``--field``,
each modulo a trailing ``_s`` unit suffix) plus the declared alias
tables below for historical flag names (``--every``, ``--keep``,
``--http``, ``--metrics-json``); a resolver also links when it reads —
or is called with — the field's env var.  Docs count from any of
README.md / ROBUSTNESS.md / OBSERVABILITY.md: a config-table row
naming the field, or the env var appearing in prose.

The reverse direction is drift too: a ROBUSTNESS config-table row
naming a field that no longer exists on ``ProfilerConfig`` reports as
``doc-dead``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from tpuprof_torch.analysis.context import (AnalysisContext, call_name,
                                      const_str)
from tpuprof_torch.analysis.model import Finding
from tpuprof_torch.analysis.registry import checker

#: fields whose CLI flag predates the field-name convention — the flag
#: is the public contract, the alias records it (ANALYSIS.md)
CLI_ALIASES: Dict[str, str] = {
    "watch_every_s": "--every",
    "artifact_keep": "--keep",
    "serve_http_port": "--http",
    "metrics_path": "--metrics-json",
    "metrics_enabled": "--progress",
    "checkpoint_path": "--checkpoint",
    "checkpoint_every_batches": "--checkpoint-every",
    "unique_track_total_rows": "--unique-track-total-rows",
    "artifact_path": "--artifact",
}

#: env twins that are not the mechanical TPUPROF_<FIELD> name
ENV_ALIASES: Dict[str, str] = {
    "metrics_enabled": "TPUPROF_METRICS",
}

_DOCS = ("README.md", "ROBUSTNESS.md", "OBSERVABILITY.md")


def _strip_unit(name: str) -> str:
    return name[:-2] if name.endswith("_s") else name


def _config_fields(ctx: AnalysisContext) -> Dict[str, int]:
    sf = ctx.file("/config.py")
    if sf is None:
        return {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) \
                and node.name == "ProfilerConfig":
            out = {}
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name) \
                        and not stmt.target.id.startswith("_"):
                    out[stmt.target.id] = stmt.lineno
            return out
    return {}


def _resolvers(ctx: AnalysisContext) -> Dict[str, Set[str]]:
    """resolver name -> env-var literals its body reads.  Resolvers
    live in config.py by convention, but a few legitimately sit next
    to their consumer (``obs.resolve_metrics_path``) — scan every
    package module."""
    out: Dict[str, Set[str]] = {}
    for sf in ctx.files:
        for node in sf.tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("resolve_"):
                envs = {c for n in ast.walk(node)
                        if (c := const_str(n))
                        and c.startswith("TPUPROF_")}
                out.setdefault(node.name, set()).update(envs)
    return out


def _resolve_call_envs(ctx: AnalysisContext) -> Set[str]:
    """Env literals handed to any ``resolve_*`` call anywhere in the
    package — the generic-resolver link (``resolve_watchdog_timeout
    (value, "TPUPROF_DRAIN_TIMEOUT_S")``)."""
    out: Set[str] = set()
    for _sf, node in ctx.iter_calls():
        if call_name(node).split(".")[-1].startswith("resolve_"):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                v = const_str(arg)
                if v and v.startswith("TPUPROF_"):
                    out.add(v)
    return out


def _cli_flags(ctx: AnalysisContext) -> Set[str]:
    sf = ctx.file("/cli.py")
    if sf is None:
        return set()
    flags: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and call_name(node).endswith("add_argument"):
            for arg in node.args:
                v = const_str(arg)
                if v and v.startswith("--"):
                    flags.add(v)
    return flags


_ROW_RE = re.compile(r"^\|\s*`([A-Za-z_][A-Za-z0-9_]*)`\s*\|")


def _table_fields(ctx: AnalysisContext, fields: Dict[str, int]
                  ) -> Dict[str, List[str]]:
    """doc name -> field names its config-table rows claim.  A table
    row is any markdown row whose first cell is a backticked
    snake_case name; rows naming error classes (the taxonomy table)
    are filtered by the caller against the field set."""
    out: Dict[str, List[str]] = {}
    for doc in _DOCS:
        text = ctx.doc_text(doc)
        if not text:
            continue
        rows = []
        for line in text.splitlines():
            m = _ROW_RE.match(line.strip())
            if m:
                rows.append(m.group(1))
        out[doc] = rows
    return out


@checker(
    "config-surface",
    "every runtime config knob has its resolve_*, TPUPROF_* env twin, "
    "CLI flag, and doc-table row; doc rows name only live fields")
def check_config_surface(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    fields = _config_fields(ctx)
    if not fields:
        return [Finding(
            checker="config-surface", path=f"{ctx.package}/config.py",
            line=0,
            ident="config:missing",
            message="no ProfilerConfig dataclass found — the config "
                    "surface cannot be checked")]
    resolvers = _resolvers(ctx)
    call_envs = _resolve_call_envs(ctx)
    flags = _cli_flags(ctx)
    pkg_literals = {v for _sf, v in ctx.string_literals()
                    if v.startswith("TPUPROF_")}
    tables = _table_fields(ctx, fields)
    config_sf = ctx.file("/config.py")
    config_rel = config_sf.relpath if config_sf \
        else f"{ctx.package}/config.py"

    for field, lineno in fields.items():
        env = ENV_ALIASES.get(field, "TPUPROF_" + field.upper())
        has_env = env in pkg_literals
        resolver = None
        for rname, renvs in resolvers.items():
            stem = rname[len("resolve_"):]
            if stem in (field, _strip_unit(field)) or env in renvs:
                resolver = rname
                break
        has_resolver = resolver is not None or env in call_envs
        doc_rows = [doc for doc, rows in tables.items()
                    if field in rows]
        doc_prose = [doc for doc in _DOCS
                     if env in (ctx.doc_text(doc) or "")]
        has_doc = bool(doc_rows or doc_prose)

        in_scope = has_env or resolver is not None or bool(doc_rows)
        if not in_scope:
            continue

        flag = CLI_ALIASES.get(field)
        candidates = [flag] if flag else [
            "--" + field.replace("_", "-"),
            "--" + _strip_unit(field).replace("_", "-")]
        has_cli = any(c in flags for c in candidates)

        if not has_env:
            findings.append(Finding(
                checker="config-surface", path=config_rel, line=lineno,
                ident=f"{field}:env",
                message=f"config field '{field}' has no {env} env twin "
                        "anywhere in the package — wrappers/CI cannot "
                        "set it without code"))
        if not has_resolver:
            findings.append(Finding(
                checker="config-surface", path=config_rel, line=lineno,
                ident=f"{field}:resolver",
                message=f"config field '{field}' has no resolve_* "
                        "resolver (none name-matches and none reads "
                        f"{env}) — the explicit-wins/env/default "
                        "resolution order is unimplemented"))
        if not has_cli:
            findings.append(Finding(
                checker="config-surface", path=config_rel, line=lineno,
                ident=f"{field}:cli",
                message=f"config field '{field}' has no CLI flag "
                        f"(looked for {', '.join(candidates)}; declare "
                        "an alias in CLI_ALIASES if the flag predates "
                        "the naming convention)"))
        if not has_doc:
            findings.append(Finding(
                checker="config-surface", path=config_rel, line=lineno,
                ident=f"{field}:doc",
                message=f"config field '{field}' has no doc leg — add "
                        "a ROBUSTNESS.md/README config-table row or "
                        f"document {env} in README/OBSERVABILITY"))

    # reverse: ROBUSTNESS config-table rows naming dead fields (the
    # taxonomy table's rows are CamelCase error classes — the
    # snake_case row regex already excludes them; anything else
    # snake_case in a ROBUSTNESS table must be a live field)
    for row in tables.get("ROBUSTNESS.md", []):
        if row not in fields and row == row.lower():
            findings.append(Finding(
                checker="config-surface", path="ROBUSTNESS.md",
                line=ctx.doc_line("ROBUSTNESS.md", f"`{row}`"),
                ident=f"doc-dead:{row}",
                message=f"ROBUSTNESS.md config table names '{row}' "
                        "but ProfilerConfig has no such field — stale "
                        "row"))
    return findings
