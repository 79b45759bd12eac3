"""The port's lint (``tpuprof_torch/analysis``, ``python -m tpuprof_torch
lint``) against the reference's (``tpuprof/analysis``).

Three layers, as in ``tests/test_analysis.py``:

* **synthetic trees** — every doctored tree of ``tests/test_analysis.py``
  (its own fixtures), written once under ``tpuprof/`` with the root
  ``LINT_SUPPRESSIONS`` and once under ``tpuprof_torch/`` with
  ``tpuprof_torch/LINT_SUPPRESSIONS``; the reference's ``run_lint`` over
  the first and the port's over the second give the same findings, the
  same suppressions and the same stale or malformed entries once
  ``tpuprof/`` is mapped to ``tpuprof_torch/`` in paths, idents and
  messages, and the port's meet the reference test's own expectation.
  Messages are compared with the reference's parenthesised history tags
  left out: the port's messages carry none;
* **the port-only runner seam** — the port's cache hands out a one-device
  ``Runner`` too, so a direct ``Runner(...)`` outside ``serve/cache.py``,
  ``runtime/mesh.py`` and ``runtime/runner.py`` is flagged;
* **the real tree** — the port's run over ``tpuprof_torch`` has no
  unsuppressed finding and exactly its one suppression; its run with
  ``package="tpuprof"`` is the reference's report; the CLI's exit codes,
  ``--json``, ``--strict``, ``--only``, ``--list``; the findings counter;
  and ``import tpuprof_torch.analysis`` loads neither ``jax`` nor any
  module of the reference.  No wall-clock assertion: the suite's time is
  the host's, and a loaded host is not a fault of the port.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import textwrap

import pytest

import test_analysis as ta
from tpuprof import analysis as ref_analysis
from tpuprof import cli as ref_cli
from tpuprof_torch import analysis, cli, errors
from tpuprof_torch.obs import metrics

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SUPPRESSIONS = "tpuprof_torch/LINT_SUPPRESSIONS"
SCHEDULER_IDENT = "tpuprof_torch/serve/scheduler.py:_body:bare-write"


# ---------------------------------------------------------------------------
# the cases of tests/test_analysis.py, each a tree under tpuprof/
# ---------------------------------------------------------------------------

def _config_files(**kw):
    """The files ``test_analysis._config_tree`` writes, read back."""
    with tempfile.TemporaryDirectory() as d:
        ta._config_tree(pathlib.Path(d), **kw)
        out = {}
        for dirpath, _, names in os.walk(d):
            for name in names:
                path = os.path.join(dirpath, name)
                with open(path) as fh:
                    out[os.path.relpath(path, d).replace(os.sep, "/")] = \
                        fh.read()
        return out


def _without(text, needle):
    return "\n".join(ln for ln in text.splitlines() if needle not in ln)


_STALE_TREE = {
    "tpuprof/x.py": "",
    "tests/test_obs_smoke.py": "EVENT_SCHEMA = {}\n",
    "OBSERVABILITY.md": "",
    "ROBUSTNESS.md": "",
    "tpuprof/errors.py": "_EXIT_CODES = ()\n",
    "tpuprof/config.py": "class ProfilerConfig:\n    pass\n",
    "tpuprof/testing/faults.py": "SITES = frozenset()\n",
    "LINT_SUPPRESSIONS":
        "durability gone:* the violation it excused was fixed\n"}

_OBS_DOC = "| `tpuprof_spam_total` | counter | spam |\n"


def _obs(obs_doc, schema):
    return {"tpuprof/spam.py": ta.TestObsContractChecker.MODULE,
            "OBSERVABILITY.md": obs_doc,
            "tests/test_obs_smoke.py": f"EVENT_SCHEMA = {schema!r}\n"}


# name -> (files, only, strict, expectation): the expectation is
# ("exact", [idents]) or ("has", ident) on the reference's unsuppressed
# idents, as tests/test_analysis.py asserts them
CASES = {
    # durability
    "clean_seam": ({"tpuprof/serve/server.py": ta.GOOD_SEAM},
                   "durability", False, ("exact", [])),
    "bare_write": (ta.TestSuppressions.BAD, "durability", False,
                   ("exact", ["tpuprof/serve/server.py:publish:bare-write"])),
    "suffix_tmp_name": ({"tpuprof/runtime/fleet.py": '''
import os

def almost_atomic(path, data):
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
'''}, "durability", False,
        ("exact", ["tpuprof/runtime/fleet.py:almost_atomic:tmp-name"])),
    "unfiltered_scan": ({"tpuprof/serve/watch.py": '''
import os

def sweep(d):
    out = []
    for name in os.listdir(d):
        out.append(os.path.join(d, name))
    return out
'''}, "durability", False,
        ("exact", ["tpuprof/serve/watch.py:sweep:scan-unfiltered"])),
    "emptiness_probe": ({"tpuprof/serve/server.py": '''
import os

def is_drained(d):
    return not os.listdir(d)
'''}, "durability", False, ("exact", [])),
    "non_durable_module": ({"tpuprof/report/render.py": '''
def write_html(path, html):
    with open(path, "w") as fh:
        fh.write(html)
'''}, "durability", False, ("exact", [])),
    "missing_fsync": ({"tpuprof/artifact/store.py": '''
import os

def write(path, data):
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)
'''}, "durability", False,
        ("exact", ["tpuprof/artifact/store.py:write:bare-write"])),
    # config-surface
    "config_complete": (_config_files(), "config-surface", False,
                        ("exact", [])),
    "config_missing_cli": (_config_files(cli_flag=False), "config-surface",
                           False, ("has", "spam_timeout_s:cli")),
    "config_missing_doc": (_config_files(doc_row=False), "config-surface",
                           False, ("has", "spam_timeout_s:doc")),
    "config_missing_env": (_config_files(env_in_resolver=False,
                                         doc_row=False),
                           "config-surface", False,
                           ("has", "spam_timeout_s:env")),
    "config_missing_resolver": ({
        "tpuprof/config.py": '''
import os
_E = os.environ.get("TPUPROF_LONELY_KNOB")

class ProfilerConfig:
    lonely_knob: int = 0
''',
        "tpuprof/cli.py": 'import argparse\n'
                          'p = argparse.ArgumentParser()\n'
                          'p.add_argument("--lonely-knob")\n',
        "ROBUSTNESS.md":
            "| `lonely_knob` | `TPUPROF_LONELY_KNOB` | 0 | "
            "`--lonely-knob` |\n"}, "config-surface", False,
        ("has", "lonely_knob:resolver")),
    "config_dead_doc_row": ({
        "tpuprof/config.py": "class ProfilerConfig:\n    x: int = 0\n",
        "tpuprof/cli.py": "",
        "ROBUSTNESS.md": "| `ghost_knob` | `TPUPROF_GHOST_KNOB` | "
                         "— | `--ghost` |\n"}, "config-surface", False,
        ("has", "doc-dead:ghost_knob")),
    "config_parity_knob": ({
        "tpuprof/config.py": "class ProfilerConfig:\n    bins: int = 10\n",
        "tpuprof/cli.py": 'import argparse\n'
                          'p = argparse.ArgumentParser()\n'
                          'p.add_argument("--bins")\n',
        "ROBUSTNESS.md": ""}, "config-surface", False, ("exact", [])),
    "config_no_config_module": ({"tpuprof/x.py": ""}, "config-surface",
                                False, ("exact", ["config:missing"])),
    # obs-contract
    "obs_synced": (_obs(_OBS_DOC, {"spam_event": {}}), "obs-contract",
                   False, ("exact", [])),
    "obs_undocumented_metric": (
        _obs("no metrics here\n", {"spam_event": {}}), "obs-contract",
        False, ("has", "metric:tpuprof_spam_total:undocumented")),
    "obs_dead_doc_metric": (
        _obs(_OBS_DOC + "| `tpuprof_ghost_total` | counter | gone |\n",
             {"spam_event": {}}), "obs-contract", False,
        ("has", "metric:tpuprof_ghost_total:dead-doc")),
    "obs_unregistered_event": (_obs(_OBS_DOC, {}), "obs-contract", False,
                               ("has", "event:spam_event:unregistered")),
    "obs_dead_schema_kind": (
        _obs(_OBS_DOC, {"spam_event": {}, "ghost_event": {}}),
        "obs-contract", False, ("has", "event:ghost_event:dead-schema")),
    # error-taxonomy
    "taxonomy_synced": ({"tpuprof/errors.py": ta.ERRORS_MOD,
                         "ROBUSTNESS.md": ta.TAXONOMY_DOC},
                        "error-taxonomy", False, ("exact", [])),
    "taxonomy_undocumented": (
        {"tpuprof/errors.py": ta.ERRORS_MOD,
         "ROBUSTNESS.md": _without(ta.TAXONOMY_DOC, "SpamError")},
        "error-taxonomy", False, ("has", "SpamError:undocumented")),
    "taxonomy_code_mismatch": (
        {"tpuprof/errors.py": ta.ERRORS_MOD,
         "ROBUSTNESS.md": ta.TAXONOMY_DOC.replace(
             "| `SpamError` | `RuntimeError` | spam | 5 |",
             "| `SpamError` | `RuntimeError` | spam | 7 |")},
        "error-taxonomy", False, ("has", "SpamError:code-mismatch")),
    "taxonomy_orphan_exit_code": (
        {"tpuprof/errors.py": ta.ERRORS_MOD.replace(
            "    (SpamError, 5),", "    (SpamError, 5),\n    (GhostError, 6),"),
         "ROBUSTNESS.md": ta.TAXONOMY_DOC},
        "error-taxonomy", False, ("has", "GhostError:orphan-exit-code")),
    "taxonomy_code_collision": (
        {"tpuprof/errors.py": ta.ERRORS_MOD.replace(
            "    (InputError, 2),", "    (InputError, 5),"),
         "ROBUSTNESS.md": ta.TAXONOMY_DOC.replace(
             "| `InputError` | `ValueError` | bad input | 2 |",
             "| `InputError` | `ValueError` | bad input | 5 |")},
        "error-taxonomy", False, ("has", "InputError:code-collision")),
    "taxonomy_subclass_shares_code": (
        {"tpuprof/errors.py": ta.ERRORS_MOD.replace(
            "TYPED_ERRORS",
            "class SpamSubError(SpamError):\n    pass\n\nTYPED_ERRORS"),
         "ROBUSTNESS.md": ta.TAXONOMY_DOC
            + "| `SpamSubError` | `SpamError` | worse spam | 5 |\n"},
        "error-taxonomy", False, ("exact", [])),
    "taxonomy_dead_doc_row": (
        {"tpuprof/errors.py": ta.ERRORS_MOD,
         "ROBUSTNESS.md": ta.TAXONOMY_DOC
            + "| `GoneError` | `ValueError` | removed long ago | 6 |\n"},
        "error-taxonomy", False, ("has", "GoneError:doc-dead")),
    "taxonomy_no_errors_module": ({"tpuprof/x.py": ""}, "error-taxonomy",
                                  False, ("exact", ["errors:missing"])),
    # runtime-discipline
    "discipline_clean": ({
        "tpuprof/testing/faults.py": ta.FAULTS_MOD,
        "tpuprof/serve/cache.py":
            "from tpuprof.runtime.mesh import MeshRunner\n"
            "def acquire_runner(cfg):\n"
            "    return MeshRunner(cfg)\n",
        "tpuprof/runtime/guard.py":
            "from tpuprof.testing import faults\n"
            "def run(site):\n"
            '    faults.hit("prep", key=0)\n'
            '    watched(site="serve_job")\n'
            "def watched(site=None):\n"
            "    pass\n"}, "runtime-discipline", False, ("exact", [])),
    "discipline_direct_meshrunner": ({
        "tpuprof/testing/faults.py": ta.FAULTS_MOD.replace(
            ', "serve_job"', ""),
        "tpuprof/backends/rogue.py":
            "from tpuprof.runtime.mesh import MeshRunner\n"
            "def collect(cfg):\n"
            "    runner = MeshRunner(cfg)\n"
            '    import tpuprof.testing.faults as faults\n'
            '    faults.hit("prep")\n'}, "runtime-discipline", False,
        ("has", "mesh-runner:tpuprof/backends/rogue.py")),
    "discipline_undeclared_site": ({
        "tpuprof/testing/faults.py": ta.FAULTS_MOD.replace(
            ', "serve_job"', ""),
        "tpuprof/runtime/guard.py":
            "from tpuprof.testing import faults\n"
            "def run():\n"
            '    faults.hit("prep")\n'
            '    faults.hit("rogue_site")\n'}, "runtime-discipline", False,
        ("has", "site:rogue_site:undeclared")),
    "discipline_dead_site": ({
        "tpuprof/testing/faults.py": ta.FAULTS_MOD,
        "tpuprof/runtime/guard.py":
            "from tpuprof.testing import faults\n"
            "def run():\n"
            '    faults.hit("prep")\n'}, "runtime-discipline", False,
        ("has", "site:serve_job:dead")),
    "discipline_no_registry": ({"tpuprof/x.py": ""}, "runtime-discipline",
                               False, ("exact", ["sites:missing-registry"])),
    # suppressions
    "suppression_absorbs": (dict(
        ta.TestSuppressions.BAD, LINT_SUPPRESSIONS="durability "
        "tpuprof/serve/server.py:publish:* known bare write, "
        "exporting user-owned path\n"), "durability", False, ("exact", [])),
    "suppression_strict": (dict(
        ta.TestSuppressions.BAD, LINT_SUPPRESSIONS="durability "
        "tpuprof/serve/server.py:publish:* excused\n"), "durability", True,
        ("exact", ["tpuprof/serve/server.py:publish:bare-write"])),
    "suppression_reasonless": ({
        "tpuprof/x.py": "",
        "LINT_SUPPRESSIONS": "durability some-glob\n"}, "durability", False,
        ("exact", ["malformed:1"])),
    "suppression_stale": (_STALE_TREE, None, False,
                          ("has", "stale:durability:gone:*")),
}


def _to_port(rel: str) -> str:
    if rel == "LINT_SUPPRESSIONS":
        return PORT_SUPPRESSIONS
    if rel.startswith("tpuprof/"):
        return "tpuprof_torch/" + rel[len("tpuprof/"):]
    return rel


def _port_files(files):
    """The same tree under ``tpuprof_torch/``: paths mapped, and the
    suppression file's globs naming the port's modules."""
    out = {}
    for rel, text in files.items():
        if rel == "LINT_SUPPRESSIONS":
            text = text.replace(" tpuprof/", " tpuprof_torch/")
        out[_to_port(rel)] = text
    return out


def _write(root, files) -> str:
    for rel, content in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    return str(root)


_HISTORY = re.compile(r" ?\(?PR[- ]\d+\)?")


def _message(msg: str) -> str:
    return _HISTORY.sub("", msg)


def _mapped(report, port: bool):
    """A report's findings and suppressions as comparable tuples; the
    reference's mapped to the port's names."""
    def one(f):
        path = f.path.replace(os.sep, "/")
        ident, msg = f.ident, _message(f.message)
        if not port:
            path = _to_port(path)
            ident = ident.replace("tpuprof/", "tpuprof_torch/")
            msg = msg.replace("tpuprof/", "tpuprof_torch/")
        return (f.checker, path, f.line, ident, f.severity, msg)
    return ([one(f) for f in report.findings],
            sorted((one(f), r) for f, r in report.suppressed.items()),
            [one(f)[3] for f in report.unsuppressed()],
            report.checkers_run)


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_tree_same_findings_as_the_reference(case, tmp_path):
    files, only, strict, (how, want) = CASES[case]
    only = [only] if only else None
    ref_root = _write(tmp_path / "ref", files)
    port_root = _write(tmp_path / "port", _port_files(files))
    ref = ref_analysis.run_lint(ref_root, only=only, strict=strict)
    mine = analysis.run_lint(port_root, only=only, strict=strict)
    ref_t, mine_t = _mapped(ref, port=False), _mapped(mine, port=True)
    assert mine_t == ref_t
    ref_idents = [f.ident for f in ref.unsuppressed()]
    port_want = [i.replace("tpuprof/", "tpuprof_torch/")
                 for i in (want if how == "exact" else [want])]
    if how == "exact":
        assert ref_idents == want
        assert mine_t[2] == port_want
    else:
        assert want in ref_idents
        assert port_want[0] in mine_t[2]


def test_synthetic_bare_write_location_and_suppression_reason(tmp_path):
    """The durability finding's file and line, and the absorbed finding's
    reason, as tests/test_analysis.py asserts them for the reference."""
    root = _write(tmp_path, _port_files(dict(
        ta.TestSuppressions.BAD, LINT_SUPPRESSIONS="durability "
        "tpuprof/serve/server.py:publish:* known bare write, "
        "exporting user-owned path\n")))
    (f,) = analysis.run_lint(root, only=["durability"], strict=True) \
        .unsuppressed()
    assert f.path == os.path.join("tpuprof_torch", "serve", "server.py")
    assert f.line == 3
    report = analysis.run_lint(root, only=["durability"])
    assert report.unsuppressed() == [] and len(report.suppressed) == 1
    (reason,) = report.suppressed.values()
    assert "user-owned" in reason


# ---------------------------------------------------------------------------
# the port-only runner seam
# ---------------------------------------------------------------------------

_SITES = {"tpuprof_torch/testing/faults.py":
          'SITES = frozenset({"prep"})\n',
          "tpuprof_torch/runtime/guard.py":
          "def run(faults):\n"
          '    faults.hit("prep")\n'}


def test_direct_runner_outside_the_seam_flagged(tmp_path):
    root = _write(tmp_path, dict(_SITES, **{
        "tpuprof_torch/backends/rogue.py":
            "from tpuprof_torch.runtime.runner import Runner\n"
            "from tpuprof_torch.runtime import runner as r\n"
            "def collect(cfg):\n"
            "    a = Runner(cfg, 2, 0, 'cuda:0')\n"
            "    return a, r.Runner(cfg, 2, 0, 'cuda:0')\n"}))
    found = [(f.ident, f.line) for f in analysis.run_lint(
        root, only=["runtime-discipline"]).unsuppressed()]
    assert found == [("runner:tpuprof_torch/backends/rogue.py", 4),
                     ("runner:tpuprof_torch/backends/rogue.py", 5)]
    (f, _) = analysis.run_lint(
        root, only=["runtime-discipline"]).unsuppressed()
    assert "direct Runner construction bypasses" in f.message


def test_runner_inside_the_seam_modules_clean(tmp_path):
    root = _write(tmp_path, dict(_SITES, **{
        "tpuprof_torch/serve/cache.py":
            "def _build_runner(config, devs):\n"
            "    if len(devs) > 1:\n"
            "        return MeshRunner(config, devs)\n"
            "    return Runner(config, devs[0])\n",
        "tpuprof_torch/runtime/mesh.py":
            "class MeshRunner:\n"
            "    def __init__(self, config, devs):\n"
            "        self.runners = [Runner(config, d) for d in devs]\n",
        "tpuprof_torch/runtime/runner.py":
            "class Runner:\n"
            "    def clone(self):\n"
            "        return Runner(self.config, self.device)\n"}))
    assert analysis.run_lint(
        root, only=["runtime-discipline"]).unsuppressed() == []


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    return analysis.run_lint(REPO)


def test_real_tree_clean_with_its_one_suppression(port_report):
    assert [f.format() for f in port_report.unsuppressed()] == []
    assert [f.ident for f in port_report.suppressed] == [SCHEDULER_IDENT]
    (reason,) = port_report.suppressed.values()
    assert len(reason.split()) >= 3
    assert port_report.checkers_run == ref_analysis.checker_ids()


def test_real_tree_strict_absorbs_nothing():
    report = analysis.run_lint(REPO, strict=True)
    assert report.suppressed == {}
    assert [f.ident for f in report.unsuppressed()] == [SCHEDULER_IDENT]


def test_port_suite_over_the_reference_is_the_references_report():
    mine = analysis.run_lint(REPO, package="tpuprof",
                             suppressions="LINT_SUPPRESSIONS")
    ref = ref_analysis.run_lint(REPO)
    assert _mapped(mine, port=True) == _mapped(ref, port=True)
    a, b = mine.to_dict(), ref.to_dict()
    for doc in (a, b):
        doc.pop("wall_s")
        for f in doc["findings"]:
            f["message"] = _message(f["message"])
    assert a == b


def test_list_gives_the_references_ids_and_docs():
    assert analysis.checker_ids() == ref_analysis.checker_ids()
    for cid in analysis.checker_ids():
        assert analysis.checker_doc(cid) == ref_analysis.checker_doc(cid)
    out, ref_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["lint", "--list"]) == 0
    with contextlib.redirect_stdout(ref_out):
        assert ref_cli.main(["lint", "--list"]) == 0
    assert out.getvalue() == ref_out.getvalue()
    assert len(out.getvalue().splitlines()) == 5


def test_cli_real_tree_exit_0_json_schema(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert cli.main(["lint", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "tpuprof-lint-v1" and doc["clean"] is True
    assert doc["root"] == REPO and len(doc["checkers"]) == 5
    assert doc["suppressed_count"] == 1
    (f,) = doc["findings"]
    assert f["suppressed"] and f["ident"] == SCHEDULER_IDENT and f["reason"]
    err = capsys.readouterr().err
    assert err.startswith("tpuprof_torch lint: clean — 5 checkers, 1 "
                          "suppressed finding(s) in ")


def test_cli_real_tree_strict_exit_2(capsys):
    assert cli.main(["lint", REPO, "--strict"]) == 2
    cap = capsys.readouterr()
    assert cap.out.count("[durability]") == 1
    assert "scheduler.py:" in cap.out
    assert cap.err.strip() == \
        "tpuprof_torch lint: 1 finding(s) across 1 checker(s)"


def test_cli_findings_exit_2_and_json_schema(tmp_path, capsys):
    root = _write(tmp_path, _port_files(ta.TestSuppressions.BAD))
    out = tmp_path / "lint.json"
    rc = cli.main(["lint", root, "--only", "durability", "--json", str(out)])
    assert rc == 2
    doc = json.loads(out.read_text())
    assert doc["schema"] == "tpuprof-lint-v1" and doc["clean"] is False
    (f,) = doc["findings"]
    assert f["checker"] == "durability"
    assert f["file"].endswith("server.py") and f["line"] == 3
    assert f["ident"] == "tpuprof_torch/serve/server.py:publish:bare-write"
    assert not f["suppressed"]
    assert capsys.readouterr().out.count("[durability]") == 1


def test_cli_clean_tree_exits_0(tmp_path):
    root = _write(tmp_path, {"tpuprof_torch/serve/server.py": ta.GOOD_SEAM})
    assert cli.main(["lint", root, "--only", "durability"]) == 0


def test_cli_suppressions_flag_names_the_file(tmp_path):
    root = _write(tmp_path, dict(_port_files(ta.TestSuppressions.BAD), **{
        "elsewhere.txt": "durability tpuprof_torch/serve/server.py:* "
                         "a reason in another file\n"}))
    assert cli.main(["lint", root, "--only", "durability"]) == 2
    assert cli.main(["lint", root, "--only", "durability",
                     "--suppressions", "elsewhere.txt"]) == 0


@pytest.mark.parametrize("only", ["bogus", "durability,bogus"])
def test_cli_unknown_checker_exits_2(only, capsys):
    assert cli.main(["lint", REPO, "--only", only]) == 2
    assert "tpuprof_torch: error: unknown checker id(s) ['bogus']" \
        in capsys.readouterr().err


def test_lint_findings_error_shares_input_error_exit():
    assert issubclass(errors.LintFindingsError, errors.InputError)
    assert errors.exit_code(errors.LintFindingsError("x")) == 2
    assert errors.LintFindingsError in errors.TYPED_ERRORS


def test_findings_counter_by_checker(tmp_path):
    files = dict(_port_files(ta.TestSuppressions.BAD),
                 **{"tpuprof_torch/runtime/guard.py":
                    "def run(faults):\n"
                    '    faults.hit("rogue_site")\n',
                    "tpuprof_torch/testing/faults.py":
                    "SITES = frozenset()\n"})
    report = analysis.run_lint(_write(tmp_path, files),
                               only=["durability", "runtime-discipline"])
    assert report.counts_by_checker() == {"durability": 1,
                                          "runtime-discipline": 1}
    reg = metrics.registry()
    was = reg.enabled
    reg.enabled = True
    before = {c: analysis.FINDINGS_TOTAL.value(checker=c)
              for c in ("durability", "runtime-discipline")}
    try:
        analysis.observe(report)
        analysis.observe(report)
    finally:
        reg.enabled = was
    after = {c: analysis.FINDINGS_TOTAL.value(checker=c) for c in before}
    assert after == {c: v + 2 for c, v in before.items()}
    assert metrics.registry()._instruments[
        "tpuprof_lint_findings_total"].kind == "counter"


def test_importing_the_suite_loads_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import sys
        import tpuprof_torch.analysis as a
        from tpuprof_torch.analysis import checkers  # noqa: F401
        report = a.run_lint(sys.argv[1])
        assert not report.unsuppressed(), report.unsuppressed()
        own = [m for m in sys.modules
               if m.startswith("tpuprof_torch.analysis")]
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "tpuprof" or m.startswith("tpuprof."))
        print("OWN", len(own), "LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def test_suite_modules_import_no_torch():
    """The suite is host code: none of its own modules imports torch (the
    package's ``__init__`` does, for the profiler)."""
    pkg = os.path.join(REPO, "tpuprof_torch", "analysis")
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    text = fh.read()
                assert not re.search(r"^\s*(import|from) torch\b", text,
                                     re.M), name
                assert not re.search(r"^\s*(import|from) (jax|tpuprof)\b",
                                     text, re.M), name
