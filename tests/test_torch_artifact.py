"""Stats-only ``tpuprof-stats-v1`` artifacts of the PyTorch port
(``tpuprof_torch/artifact``, ``tpuprof_torch/report/export.py``) against
the JAX reference's: each package reads what the other writes, every
integrity failure is a typed ``CorruptArtifactError``, and the stats
export and the sealed ``bin_seeds`` agree with the reference's."""

import json
import os

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pytest

import tpuprof_torch
from tpuprof import ProfilerConfig as RefConfig
from tpuprof.artifact import read_artifact as ref_read_artifact
from tpuprof.artifact import write_artifact as ref_write_artifact
from tpuprof.backends.tpu import TPUStatsBackend
from tpuprof.report.export import stats_to_json as ref_stats_to_json
from tpuprof_torch.artifact import (build_sketches, read_artifact,
                                    write_artifact)
from tpuprof_torch.errors import CorruptArtifactError
from tpuprof_torch.report.export import SCHEMA_ID, stats_to_json
from torch_route import same_hash_route  # noqa: F401  (autouse)

BATCH = 512
FLOAT_RTOL = {"std": 1e-3, "variance": 2e-3, "mad": 1e-3, "skewness": 2e-2,
              "kurtosis": 5e-2, "cv": 1e-3}
DEFAULT_RTOL = 1e-4


def _frame(seed=21, n=2500):
    rng = np.random.default_rng(seed)
    x = rng.normal(50, 9, n).astype(np.float32)
    x[rng.random(n) < 0.1] = np.nan
    inf_col = rng.normal(0, 1, n).astype(np.float32)
    inf_col[rng.choice(n, 30, replace=False)] = np.inf
    return pd.DataFrame({
        "x": x,
        "y": rng.exponential(3.0, n),
        "ints": rng.integers(-20, 20, n).astype(np.int64),
        "with_inf": inf_col,
        "const": np.full(n, 7.0),
        "all_nan": np.full(n, np.nan),
        "flag": rng.random(n) < 0.4,
        "cat": rng.choice(["red", "green", "blue"], n),
        "when": pd.Timestamp("2021-03-01") + pd.to_timedelta(
            rng.integers(0, 86400 * 30, n), unit="s"),
    })


@pytest.fixture(scope="module")
def df():
    return _frame()


@pytest.fixture(scope="module")
def port_stats(df):
    return tpuprof_torch.describe(df, device="cpu", batch_rows=BATCH)


@pytest.fixture(scope="module")
def ref_stats(df):
    return TPUStatsBackend().collect(
        df, RefConfig(backend="tpu", batch_rows=BATCH))


@pytest.fixture
def port_art(tmp_path, port_stats):
    path = str(tmp_path / "port.json")
    write_artifact(path, stats=port_stats,
                   config=tpuprof_torch.ProfilerConfig(batch_rows=BATCH),
                   source="frame")
    return path


def test_port_reads_reference_artifact(tmp_path, ref_stats):
    path = str(tmp_path / "ref.json")
    meta = ref_write_artifact(path, stats=ref_stats,
                              config=RefConfig(batch_rows=BATCH))
    art = read_artifact(path)
    assert art.schema == SCHEMA_ID and art.crc32 == meta["crc32"]
    assert art.rows == ref_stats["table"]["n"]
    assert art.columns == {k: v["type"]
                           for k, v in ref_stats["variables"].items()}
    assert not art.foldable
    assert art.sketches["bin_seeds"] == ref_stats["_bin_seeds"]
    assert art.stats == json.loads(json.dumps(ref_stats_to_json(ref_stats)))


def test_reference_reads_port_artifact(port_art, port_stats):
    art = ref_read_artifact(port_art)
    assert art.schema == SCHEMA_ID
    assert art.meta["format"] == SCHEMA_ID
    assert art.meta["tpuprof_version"] == tpuprof_torch.__version__
    assert art.meta["source"] == "frame"
    assert art.meta["config"]["batch_rows"] == BATCH
    assert art.meta["config"]["fingerprint"] == \
        tpuprof_torch.ProfilerConfig(batch_rows=BATCH).fingerprint()
    assert art.sketches["bin_seeds"] == port_stats["_bin_seeds"]
    assert set(art.sketches["histograms"]) == {
        k for k, v in port_stats["variables"].items() if "histogram" in v}
    assert art.stats == json.loads(json.dumps(stats_to_json(port_stats)))
    mine = read_artifact(port_art)
    assert (mine.crc32, mine.meta, mine.sketches) == \
        (art.crc32, art.meta, art.sketches)


def test_write_returns_meta_and_leaves_no_temporary(tmp_path, port_stats):
    path = str(tmp_path / "a.json")
    meta = write_artifact(path, stats=port_stats)
    assert meta["rows"] == port_stats["table"]["n"]
    assert meta["config"] == {} and meta["foldable"] is False
    assert isinstance(meta["crc32"], int)
    assert os.listdir(tmp_path) == ["a.json"]
    # the document's own meta is what the CRC covered: no crc32 inside
    with open(path) as fh:
        assert "crc32" not in json.load(fh)["meta"]


@pytest.mark.parametrize("cut", [0, 1, 17, 0.25, 0.5, 0.9, -1])
def test_truncation_is_typed(tmp_path, port_art, cut):
    with open(port_art, "rb") as fh:
        blob = fh.read()
    n = int(len(blob) * cut) if isinstance(cut, float) else cut % len(blob)
    bad = str(tmp_path / "cut.json")
    with open(bad, "wb") as fh:
        fh.write(blob[:n])
    with pytest.raises(CorruptArtifactError):
        read_artifact(bad)


def test_flipped_byte_and_junk_are_typed(tmp_path, port_art):
    with open(port_art, "rb") as fh:
        blob = bytearray(fh.read())
    # a digit inside the stats body: still valid JSON, only the CRC sees it
    at = blob.index(b'"n": ') + 5
    blob[at] = ord("1") if blob[at] != ord("1") else ord("2")
    bad = str(tmp_path / "flip.json")
    with open(bad, "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(CorruptArtifactError, match="CRC"):
        read_artifact(bad)
    for junk in (b"[1, 2]", b"\x00\xff garbage", b'{"schema": 3}'):
        with open(bad, "wb") as fh:
            fh.write(junk)
        with pytest.raises(CorruptArtifactError):
            read_artifact(bad)


def test_foreign_schema_and_missing_envelope_are_typed(tmp_path, port_art):
    with open(port_art) as fh:
        doc = json.load(fh)
    bad = str(tmp_path / "foreign.json")
    with open(bad, "w") as fh:
        json.dump(dict(doc, schema="tpuprof-stats-v0"), fh)
    with pytest.raises(CorruptArtifactError, match="schema"):
        read_artifact(bad)
    del doc["integrity"]
    with open(bad, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(CorruptArtifactError, match="integrity"):
        read_artifact(bad)


def test_missing_file_is_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_artifact(str(tmp_path / "never-written.json"))


def test_fold_state_artifacts_are_a_later_slice(tmp_path, port_art,
                                                port_stats):
    """Fold-state artifacts came with the streaming slice
    (``test_torch_incremental.py``): a stats-only artifact carries no fold
    state, and ``write_artifact`` takes exactly one of ``stats=`` and
    ``profiler=``."""
    assert not read_artifact(port_art).foldable
    with pytest.raises(CorruptArtifactError, match="no fold state"):
        read_artifact(port_art).state_payload()
    with pytest.raises(ValueError, match="exactly one"):
        write_artifact(str(tmp_path / "s.json"))
    with pytest.raises(ValueError, match="exactly one"):
        write_artifact(str(tmp_path / "s.json"), stats=port_stats,
                       profiler=object())


def _walk(a, b, path=()):
    """Same structure; equal ints, strings and nulls; floats within the
    moment tolerances."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _walk(a[k], b[k], path + (k,))
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _walk(u, v, path + (i,))
    elif isinstance(b, float) and not isinstance(b, bool):
        rtol = FLOAT_RTOL.get(path[-1], DEFAULT_RTOL) \
            if path and isinstance(path[-1], str) else 5e-4
        assert isinstance(a, float), path
        assert a == pytest.approx(b, rel=rtol, abs=5e-4), path
    else:
        assert a == b, path


def test_stats_to_json_matches_reference(port_stats, ref_stats):
    mine = json.loads(json.dumps(stats_to_json(port_stats)))
    ref = json.loads(json.dumps(ref_stats_to_json(ref_stats)))
    # human formatting of floats (5 significant digits) may round apart
    # where the raw floats agree within tolerance
    for doc in (mine, ref):
        doc.pop("display")
    _walk(mine, ref)
    assert "_bin_seeds" not in json.dumps(mine)
    assert set(stats_to_json(port_stats)["display"]["variables"]) == \
        set(port_stats["variables"])


def test_corr_entry_matches_reference_on_non_finite():
    from tpuprof.report.export import _corr_entry as ref_corr_entry
    from tpuprof_torch.report.export import _corr_entry
    m = pd.DataFrame([[1.0, np.nan, 0.5], [np.nan, 1.0, -np.inf],
                      [0.5, 0.25, 1.0]], index=[3, "b", "c"],
                     columns=[3, "b", "c"])
    m.attrs["approx"] = True
    assert _corr_entry(m) == ref_corr_entry(m)
    assert _corr_entry(m)["matrix"]["3"] == {"3": 1.0, "b": None, "c": 0.5}


def test_bin_seeds_match_reference(port_stats, ref_stats):
    mine, ref = port_stats["_bin_seeds"], ref_stats["_bin_seeds"]
    assert list(mine) == list(ref)
    for name in ref:
        lo, hi, mean = np.float32(mine[name])
        rlo, rhi, rmean = np.float32(ref[name])
        assert (lo, hi) == (rlo, rhi), name
        # the port's exact triple forms the mean in float32 on the device,
        # the reference rounds a float64 mean once: one ulp apart.  Where
        # the mean is near 0 against the column's spread ("with_inf") the
        # centred sums cancel, and the two packages sum them in other
        # orders: there the float32 rounding of that sum, 1e-6 std, bounds it
        std = port_stats["variables"][name].get("std") or 0.0
        tol = max(np.spacing(np.abs(rmean)), 1e-6 * std)
        assert abs(mean - rmean) <= tol, name
        assert all(float(np.float32(v)) == v for v in mine[name])


def test_two_pass_stats_carry_bin_seeds_and_sketches_seal_them(port_stats):
    seeds = port_stats["_bin_seeds"]
    assert set(seeds) == {"x", "y", "ints", "with_inf", "const", "all_nan",
                          "flag"}
    assert seeds["all_nan"] == [0.0, 0.0, 0.0]
    assert seeds["const"] == [7.0, 7.0, 7.0]
    sk = build_sketches(port_stats)
    assert sk["bin_seeds"] == seeds
    assert sk["topk"]["cat"][0]["count"] == \
        int(port_stats["freq"]["cat"].iloc[0])
    no_num = tpuprof_torch.describe(pd.DataFrame({"c": ["a", "b"] * 10}),
                                    device="cpu")
    assert "_bin_seeds" not in no_num
    assert "bin_seeds" not in build_sketches(no_num)
