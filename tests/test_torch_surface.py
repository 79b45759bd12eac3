"""The port's surface against the reference's: every ``ProfilerConfig``
field with the reference's default, ``NotImplementedError`` only for the
Pallas switches, every CLI verb, every error class of the taxonomy with
its exit code, every fault site; and the verbs this slice
ported (``describe(backend="cpu")``, ``serve --http``, ``watch``,
``history``, ``backtest``) load neither ``jax`` nor any module of the
reference in a fresh process.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest

from tpuprof import cli as ref_cli
from tpuprof import config as ref_config
from tpuprof import errors as ref_errors
from tpuprof.testing import faults as ref_faults
from tpuprof_torch import cli, config, errors
from tpuprof_torch.testing import faults

REPO = str(Path(__file__).resolve().parents[1])
REF_FIELDS = {f.name: f.default for f in dataclasses.fields(
    ref_config.ProfilerConfig)}


def _non_default(name):
    """A value other than the default for a field whose default is None or
    a mode string (None: the field is only checked for its default)."""
    if name == "backend":
        return "cpu"
    if name in ("use_pallas", "use_fused"):
        return True
    if name in ("warehouse_format",):
        return "off"
    if name in ("aot_cache", "read_cache"):
        return "off"
    return None


@pytest.mark.parametrize("name", sorted(REF_FIELDS))
def test_every_reference_field_with_its_default(name):
    mine = {f.name: f.default for f in dataclasses.fields(
        config.ProfilerConfig)}
    assert name in mine and mine[name] == REF_FIELDS[name]
    value = _non_default(name)
    if value is None:
        return
    if name in config._LATER:
        with pytest.raises(NotImplementedError, match=name):
            config.ProfilerConfig(**{name: value})
    else:
        assert getattr(config.ProfilerConfig(**{name: value}), name) \
            == value


def test_later_holds_only_the_pallas_switches():
    assert set(config._LATER) == {"use_pallas", "use_fused"}


def test_every_resolver_of_this_slice_like_reference(monkeypatch):
    names = ["resolve_serve_http_port", "resolve_serve_auth_file",
             "resolve_breaker_threshold", "resolve_breaker_cooldown",
             "resolve_serve_max_connections", "resolve_serve_conn_timeout",
             "resolve_serve_max_header_bytes",
             "resolve_serve_max_body_bytes", "resolve_watch_every",
             "resolve_artifact_keep", "resolve_warehouse_dir",
             "resolve_warehouse_format", "resolve_pass_b_kernel"]
    env = {"TPUPROF_SERVE_HTTP_PORT": "8123",
           "TPUPROF_SERVE_AUTH_FILE": "/t", "TPUPROF_BREAKER_THRESHOLD": "0",
           "TPUPROF_BREAKER_COOLDOWN_S": "-3",
           "TPUPROF_SERVE_MAX_CONNECTIONS": "7",
           "TPUPROF_SERVE_CONN_TIMEOUT_S": "0",
           "TPUPROF_SERVE_MAX_HEADER_BYTES": "10",
           "TPUPROF_SERVE_MAX_BODY_BYTES": "4096",
           "TPUPROF_WATCH_EVERY_S": "-1", "TPUPROF_ARTIFACT_KEEP": "9",
           "TPUPROF_WAREHOUSE_DIR": "/w", "TPUPROF_WAREHOUSE_FORMAT": "off",
           "TPUPROF_PASS_B_KERNEL": "legacy"}
    for var in env:
        monkeypatch.delenv(var, raising=False)
    for name in names:
        mine, ref = getattr(config, name), getattr(ref_config, name)
        assert mine() == ref(), name
        for v in (0, 1, 2048, 30.5):
            try:
                want = ref(v)
            except (TypeError, ValueError) as exc:
                with pytest.raises(type(exc)):
                    mine(v)
                continue
            assert mine(v) == want, (name, v)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    for name in names:
        assert getattr(config, name)() == getattr(ref_config, name)(), name


def _verbs(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return set(sub.choices)


def test_cli_verbs_are_the_references():
    assert _verbs(cli.build_parser()) == _verbs(ref_cli.build_parser())


def test_error_taxonomy_and_exit_codes():
    mine = {type(e).__name__ if not isinstance(e, type) else e.__name__
            for e in errors.TYPED_ERRORS}
    ref = {e.__name__ for e in ref_errors.TYPED_ERRORS}
    assert mine == ref
    for name in ("ServeUnavailableError", "WarehouseUnavailableError",
                 "CorruptWarehouseError", "LintFindingsError"):
        mine_cls, ref_cls = getattr(errors, name), getattr(ref_errors, name)
        assert [b.__name__ for b in mine_cls.__mro__[1:3]] \
            == [b.__name__ for b in ref_cls.__mro__[1:3]], name
        assert errors.exit_code(mine_cls("x")) \
            == ref_errors.exit_code(ref_cls("x")), name
    assert errors.exit_code(errors.ServeUnavailableError("x")) == 9
    assert errors.exit_code(errors.WarehouseUnavailableError("x")) == 10
    assert errors.exit_code(errors.CorruptWarehouseError("x")) == 6
    assert errors.exit_code(errors.LintFindingsError("x")) == 2


def test_fault_sites_are_the_references():
    assert faults.SITES == ref_faults.SITES
    for site in ("warehouse_write", "watch_cycle", "http_accept",
                 "http_write", "singlepass_rebin"):
        assert site in faults.SITES
        faults.FaultPlan.from_spec(f"{site}:1@1")


def test_ported_verbs_import_no_jax_and_no_reference(tmp_path):
    code = textwrap.dedent("""
        import os, sys
        import numpy as np, pandas as pd
        import tpuprof_torch
        from tpuprof_torch import cli
        tmp = sys.argv[1]
        df = pd.DataFrame({"x": np.arange(200.0), "c": ["a", "b"] * 100})
        stats = tpuprof_torch.describe(df, backend="cpu")
        assert stats["variables"]["x"]["count"] == 200
        src = os.path.join(tmp, "t.parquet")
        df.to_parquet(src)
        spool = os.path.join(tmp, "spool")
        auth = os.path.join(tmp, "tokens")
        with open(auth, "w") as fh:
            fh.write("tok t\\n")
        assert cli.main(["serve", spool, "--http", "0", "--device", "cpu",
                         "--serve-auth-file", auth, "--once"]) == 0
        assert cli.main(["watch", spool, src, "--device", "cpu",
                         "--every", "0", "--cycles", "2"]) == 0
        assert cli.main(["history", src, "--spool", spool, "--col",
                         "x"]) == 0
        assert cli.main(["backtest", src, "--spool", spool]) == 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "tpuprof" or m.startswith("tpuprof."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
