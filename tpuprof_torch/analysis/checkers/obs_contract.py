"""Checker ``obs-contract`` — metric and event names synced to docs
(counterpart of ``tpuprof/analysis/checkers/obs_contract.py``).  The
port registers the reference's metric names and emits its event kinds,
so the reference's OBSERVABILITY.md and EVENT_SCHEMA are its contract;
a series the port adds, which the reference has not, is catalogued in
the package's own ``<package>/OBSERVABILITY.md`` (read when it exists),
so neither package's doc names the other's dead series.

Two registries, two docs, four drift directions:

* every metric registered on the process registry
  (``metrics.counter/gauge/histogram("tpuprof_...")`` at module
  import) must appear in OBSERVABILITY.md or the package's own — an
  undocumented series is invisible to the operators the telemetry
  exists for;
* every ``tpuprof_*`` name either doc mentions must be a live
  registration — docs describing dead metrics send people grepping
  for series that never fire;
* every ``events.emit("<kind>", ...)`` call site must have an
  EVENT_SCHEMA entry (tests/test_obs_smoke.py — the runtime JSONL
  validator and this checker read the same dict, one contract);
* every EVENT_SCHEMA kind must have a live emit site — a dead schema
  entry validates events nobody produces.

Dynamic names (non-literal first args) are skipped: the contract is
about the declared names, and every registration/emit in the tree
today is a literal.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from tpuprof_torch.analysis.context import (AnalysisContext, call_name,
                                      const_str)
from tpuprof_torch.analysis.model import Finding
from tpuprof_torch.analysis.registry import checker

_METRIC_METHODS = ("counter", "gauge", "histogram")
_METRIC_TOKEN = re.compile(r"\btpuprof_[a-z0-9_]+\b")
_OBS_DOC = "OBSERVABILITY.md"
_SCHEMA_PATH = "tests/test_obs_smoke.py"


def _registrations(ctx: AnalysisContext) -> Dict[str, Tuple[str, int]]:
    out: Dict[str, Tuple[str, int]] = {}
    for sf, node in ctx.iter_calls():
        if call_name(node).split(".")[-1] not in _METRIC_METHODS:
            continue
        name = const_str(node.args[0]) if node.args else None
        if name and name.startswith("tpuprof_"):
            out.setdefault(name, (sf.relpath, node.lineno))
    return out


def _emits(ctx: AnalysisContext) -> Dict[str, Tuple[str, int]]:
    out: Dict[str, Tuple[str, int]] = {}
    for sf, node in ctx.iter_calls():
        if call_name(node).split(".")[-1] != "emit":
            continue
        kind = const_str(node.args[0]) if node.args else None
        if kind:
            out.setdefault(kind, (sf.relpath, node.lineno))
    return out


@checker(
    "obs-contract",
    "registered metric names ⇄ OBSERVABILITY.md and emitted event "
    "kinds ⇄ EVENT_SCHEMA, both directions")
def check_obs_contract(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []

    registered = _registrations(ctx)
    doc = ctx.doc_text(_OBS_DOC)
    if doc is None:
        findings.append(Finding(
            checker="obs-contract", path=_OBS_DOC, line=0,
            ident="doc:missing",
            message="OBSERVABILITY.md not found — the metric catalogue "
                    "cannot be checked"))
    own_doc = f"{ctx.package}/{_OBS_DOC}"
    named = {name: set(_METRIC_TOKEN.findall(text))
             for name, text in ((_OBS_DOC, doc),
                                (own_doc, ctx.doc_text(own_doc)))
             if text is not None}
    documented = set().union(*named.values())

    for name, (path, line) in sorted(registered.items()):
        if doc is not None and name not in documented:
            findings.append(Finding(
                checker="obs-contract", path=path, line=line,
                ident=f"metric:{name}:undocumented",
                message=f"metric '{name}' is registered here but "
                        "OBSERVABILITY.md never names it — add a "
                        "catalogue row"))
    for doc_name, names in named.items():
        for name in sorted(names - set(registered)):
            findings.append(Finding(
                checker="obs-contract", path=doc_name,
                line=ctx.doc_line(doc_name, name),
                ident=f"metric:{name}:dead-doc",
                message=f"{doc_name} names '{name}' but no "
                        "registration exists in the package — stale doc "
                        "(or the registration lost its literal name)"))

    emitted = _emits(ctx)
    schema = ctx.event_schema_keys()
    if schema is None:
        findings.append(Finding(
            checker="obs-contract", path=_SCHEMA_PATH, line=0,
            ident="event-schema:missing",
            message="EVENT_SCHEMA dict not found in "
                    "tests/test_obs_smoke.py — the JSONL event "
                    "contract cannot be checked"))
        return findings

    for kind, (path, line) in sorted(emitted.items()):
        if kind not in schema:
            findings.append(Finding(
                checker="obs-contract", path=path, line=line,
                ident=f"event:{kind}:unregistered",
                message=f"events.emit({kind!r}) has no EVENT_SCHEMA "
                        "entry — the JSONL validator would reject a "
                        "sink that recorded it; add the schema row"))
    for kind, line in sorted(schema.items()):
        # "metric" records are synthesized inside emit_snapshot (one
        # per live series) rather than through emit(kind, ...) — the
        # schema key is load-bearing for the validator even with no
        # emit literal
        if kind not in emitted and kind != "metric":
            findings.append(Finding(
                checker="obs-contract", path=_SCHEMA_PATH, line=line,
                ident=f"event:{kind}:dead-schema",
                message=f"EVENT_SCHEMA declares kind '{kind}' but no "
                        "events.emit site produces it — dead contract "
                        "entry"))
    return findings
