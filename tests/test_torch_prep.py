"""The port's host prepare: the shared prep pools, the parallel
``prepare_batch``, ``prefetch_prepared``, the plain-string row-hash path and
the fragment retry.

Mirrors ``tests/test_ingest.py`` (the fragment retry at ``:54-100``, the
row-hash path at ``:197``, the pipeline and determinism classes at
``:321-482``): the prepared planes are byte-identical at 1, 2 and 8 prep
workers, and so are the ordered folds downstream of them; the pipeline
delivers in stream order, raises a prepare's error in order and stops its
reader when the consumer leaves; the row-hash path gives the dictionary
path's plane and aggregation, and the reference's.
"""

import os
import threading
import time
import types

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import tpuprof_torch
from tpuprof import config as ref_config
from tpuprof.ingest import arrow as ref_arrow
from tpuprof_torch import config, native
from tpuprof_torch.ingest import arrow as port_arrow
from tpuprof_torch.ingest import prep
from tpuprof_torch.ingest.arrow import (ArrowIngest, prefetch_prepared,
                                        prepare_batch)
from tpuprof_torch.ingest.sample import RowSampler
from tpuprof_torch.kernels.hll import HostRegisters
from torch_route import same_hash_route  # noqa: F401  (autouse)

ROWS = 40_000           # > 2 * ROW_CHUNK_ROWS: the row-chunk split engages
BATCH = 1 << 15


def _mixed_df():
    rng = np.random.default_rng(7)
    n = ROWS
    nf = rng.normal(size=n).astype(np.float32)
    nf[rng.random(n) < 0.3] = np.nan
    ni = pd.array(rng.integers(0, 50, n), dtype="Int64")
    ni[rng.random(n) < 0.2] = pd.NA
    hicard = np.char.add("id", rng.integers(0, 10**9, n).astype(str)) \
        .astype(object)
    hicard[rng.random(n) < 0.05] = None
    return pd.DataFrame({
        "f32": rng.normal(50, 10, n).astype(np.float32),
        "f64": rng.normal(size=n),
        "i64": rng.integers(-2**40, 2**40, n),
        "i8": rng.integers(0, 100, n).astype(np.int8),
        "nullable_int": ni,
        "flag": rng.random(n) < 0.5,
        "cat": pd.Series(rng.choice(["a", "b", "c", None], n)),
        "hicard": hicard,
        "when": pd.Timestamp("2021-01-01") + pd.to_timedelta(
            rng.integers(0, 10**6, n), unit="s"),
        "nullable_f32": nf,
    })


def _prep_stream(df, workers):
    ing = ArrowIngest(df, batch_rows=BATCH)
    out = [prepare_batch(rb, ing.plan, BATCH, 11, dict_cache=ing.dict_cache,
                         col_stats=ing.col_stats, decode_threads=workers)
           for rb in ing.raw_batches()]
    return ing.plan, out


def _same_batch(a, b, label):
    assert a.x.tobytes() == b.x.tobytes(), label
    assert a.hll.tobytes() == b.hll.tobytes(), label
    assert np.array_equal(a.row_valid, b.row_valid), label
    for k in a.date_ints:
        for i in (0, 1):
            assert np.array_equal(a.date_ints[k][i], b.date_ints[k][i])
    assert set(a.cat_codes) == set(b.cat_codes), label
    for k in a.cat_codes:
        assert np.array_equal(a.cat_codes[k][0], b.cat_codes[k][0]), label
        assert list(a.cat_codes[k][1]) == list(b.cat_codes[k][1]), label
    assert set(a.cat_hashed or {}) == set(b.cat_hashed or {}), label
    for k, pa_ in (a.cat_hashed or {}).items():
        pb = b.cat_hashed[k]
        for i in range(4):
            assert np.array_equal(pa_[i], pb[i]), (label, k, i)
    assert a.col_nbytes == b.col_nbytes and \
        a.col_dict_nbytes == b.col_dict_nbytes, label


def test_planes_byte_identical_across_worker_counts():
    df = _mixed_df()
    _, ref = _prep_stream(df, workers=1)
    if native.available():
        # the second batch takes the row-hash path for the id column
        assert "hicard" in (ref[1].cat_hashed or {})
    for w in (2, 8):
        _, got = _prep_stream(df, workers=w)
        assert len(got) == len(ref) == 2
        for i, (a, b) in enumerate(zip(ref, got)):
            _same_batch(a, b, (w, i))


def test_sampler_and_hll_registers_identical():
    """The ordered folds consume completed batches, so their state is a
    function of the byte-identical planes."""
    df = _mixed_df()
    states = {}
    for w in (1, 2, 8):
        plan, stream = _prep_stream(df, workers=w)
        sampler = RowSampler(256, plan.n_num, seed=0)
        regs = HostRegisters(plan.n_hash, 11)
        for hb in stream:
            sampler.update(hb.x, hb.nrows)
            regs.update(hb.hll, hb.nrows)
        states[w] = (sampler.values.tobytes(), sampler.prio.tobytes(),
                     regs.regs.tobytes())
    assert states[1] == states[2] == states[8]


def test_profile_identical_at_any_prep_width():
    from tpuprof_torch.report.export import stats_to_json
    df = _mixed_df()
    docs = [stats_to_json(tpuprof_torch.describe(
        df, device="cpu", batch_rows=BATCH, prep_workers=w,
        prepare_workers=p)) for w, p in ((1, 1), (2, 4), (8, 2))]
    assert docs[0] == docs[1] == docs[2]


def _dataset(tmp_path, n_frags=3, rows=2000):
    rng = np.random.default_rng(1)
    d = tmp_path / "ds"
    d.mkdir()
    for f in range(n_frags):
        df = pd.DataFrame({
            "x": rng.normal(size=rows),
            "s": rng.choice(["p", "q", "r"], rows),
            "u": [f"k{f}_{i:05d}" for i in range(rows)],
        })
        pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                       str(d / f"part{f}.parquet"), row_group_size=700)
    return str(d)


def _stream(src, workers, **kw):
    ing = ArrowIngest(src, batch_rows=512)
    return [(hb.nrows, hb.x[:hb.nrows].tobytes(),
             hb.hll[:hb.nrows].tobytes())
            for hb in prefetch_prepared(ing, 512, 11, workers=workers, **kw)]


def test_parallel_stream_identical_to_serial(tmp_path):
    src = _dataset(tmp_path)
    serial = _stream(src, workers=1, prep_workers=1)
    piped = _stream(src, workers=4, prep_workers=8)
    assert len(serial) == len(piped) > 4 and serial == piped


def test_skipped_keys_do_not_arrive(tmp_path):
    src = _dataset(tmp_path)
    whole = _stream(src, workers=2)
    some = _stream(src, workers=2, skip_keys=frozenset({0, 3}))
    assert some == [b for k, b in enumerate(whole) if k not in (0, 3)]


def test_prepare_error_propagates_in_order(tmp_path, monkeypatch):
    src = _dataset(tmp_path)
    ing = ArrowIngest(src, batch_rows=512)
    real = port_arrow.prepare_batch

    def first_of_fragment_1(rb):
        return rb.column("u")[0].as_py() == "k1_00000"

    before = next(k for k, rb in enumerate(ing.raw_batches())
                  if first_of_fragment_1(rb))
    assert before > 1

    def poisoned(rb, *a, **k):
        # by the batch's identity, not call order (prepares race)
        if first_of_fragment_1(rb):
            raise ValueError("poisoned batch")
        return real(rb, *a, **k)

    monkeypatch.setattr(port_arrow, "prepare_batch", poisoned)
    got = 0
    with pytest.raises(ValueError, match="poisoned batch"):
        for _hb in prefetch_prepared(ing, 512, 11, workers=4):
            got += 1
    assert got == before     # everything before the poison arrived


def test_abandoned_consumer_stops_the_reader(tmp_path):
    src = _dataset(tmp_path, n_frags=4, rows=4000)
    ing = ArrowIngest(src, batch_rows=256)
    gen = prefetch_prepared(ing, 256, 11, workers=4)
    next(gen)
    gen.close()              # the consumer walks away mid-stream
    # the reader notices within its 0.5 s put timeout; allow 10 s
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name == "tpuprof-torch-prep-reader"
            for t in threading.enumerate()):
        time.sleep(0.1)
    assert not any(t.name == "tpuprof-torch-prep-reader"
                   for t in threading.enumerate())


def test_run_tasks_raises_first_error_after_every_task():
    done, lock = [], threading.Lock()

    def task(i):
        def run():
            time.sleep(0.02 * (8 - i))      # later tasks finish first
            with lock:
                done.append(i)
            if i in (2, 5):
                raise KeyError(f"task {i}")
        return run

    with pytest.raises(KeyError, match="task 2"):
        prep.run_tasks([task(i) for i in range(8)], workers=4)
    assert sorted(done) == list(range(8))
    with pytest.raises(KeyError, match="task 2"):      # serial: the same
        prep.run_tasks([task(i) for i in range(8)], workers=1)


def test_ordered_map_delivers_in_order():
    def slow_square(i):
        time.sleep(0.001 * ((7 * i) % 5))
        return i * i
    for workers in (1, 4):
        assert list(prep.ordered_map(range(40), slow_square, workers,
                                     depth=3)) == [i * i for i in range(40)]


def test_plain_string_rowhash_path_matches_dictionary_path():
    """Past ROWHASH_MIN_DISTINCT a plain string column is hashed row by row
    from its buffers and grouped by hash: the same packed HLL plane as the
    dictionary path (both xxHash64 of the bytes), the same (value, count)
    aggregation, and the reference's row-hash payload."""
    if not native.available():
        pytest.skip("the native hash library is needed for the row-hash "
                    "path; without it every batch takes the dictionary path")
    rng = np.random.default_rng(5)
    vals = np.array([f"k{z:06d}" for z in rng.integers(0, 4000, 8192)],
                    dtype=object)
    vals[rng.choice(8192, 300, replace=False)] = None
    table = pa.Table.from_pandas(pd.DataFrame({"s": vals}),
                                 preserve_index=False)
    ing = ArrowIngest(table, 8192)
    rb = next(iter(ing.raw_batches()))

    hb_dict = prepare_batch(rb, ing.plan, 8192, 11)
    assert "s" in hb_dict.cat_codes and not hb_dict.cat_hashed
    primed = {"s": port_arrow.ROWHASH_MIN_DISTINCT + 1}
    hb_hash = prepare_batch(rb, ing.plan, 8192, 11, col_stats=primed)
    assert "s" in hb_hash.cat_hashed and "s" not in hb_hash.cat_codes
    np.testing.assert_array_equal(hb_hash.hll, hb_dict.hll)

    codes, dvals = hb_dict.cat_codes["s"]
    want = pd.Series(dvals[codes[codes >= 0]]).value_counts().to_dict()
    uniq, cnts, first_row, row_hashes, valid, arr = hb_hash.cat_hashed["s"]
    got = {arr[int(fr)].as_py(): int(c) for c, fr in zip(cnts, first_row)}
    assert got == want and len(uniq) == len(want)
    assert primed["s"] == len(uniq)      # the memo learned the cardinality

    ref_plan = ref_arrow.ColumnPlan.from_schema(table.schema)
    ref_hb = ref_arrow.prepare_batch(
        rb, ref_plan, 8192, 11,
        col_stats={"s": ref_arrow.ROWHASH_MIN_DISTINCT + 1})
    np.testing.assert_array_equal(hb_hash.hll, ref_hb.hll)
    for i in range(5):
        ri = ref_hb.cat_hashed["s"][i]
        if ri is None:
            assert hb_hash.cat_hashed["s"][i] is None
        else:
            np.testing.assert_array_equal(hb_hash.cat_hashed["s"][i], ri)


def test_low_cardinality_stays_on_dictionary_path():
    table = pa.table({"s": ["u", "v", "w"] * 100})
    ing = ArrowIngest(table, 512)
    rb = next(iter(ing.raw_batches()))
    hb = prepare_batch(rb, ing.plan, 512, 11, col_stats={"s": 3})
    assert "s" in hb.cat_codes and not hb.cat_hashed


def test_rowhash_profile_equals_reference():
    """An id column past the threshold in every batch after the first: the
    profile's counts and top-k equal the reference's."""
    from tpuprof import ProfilerConfig as RefConfig
    from tpuprof.backends.tpu import TPUStatsBackend
    rng = np.random.default_rng(9)
    n = 3 * 20_000
    df = pd.DataFrame({"uid": [f"u{v:09d}" for v in
                               rng.integers(0, 10**9, n)],
                       "city": rng.choice(["x", "y", "z"], n)})
    port = tpuprof_torch.describe(df, device="cpu", batch_rows=20_000,
                                  topk_capacity=64)
    ref = TPUStatsBackend().collect(df, RefConfig(
        backend="tpu", batch_rows=20_000, topk_capacity=64))
    for name, rv in ref["variables"].items():
        for fld in ("type", "count", "distinct_count", "is_unique"):
            assert port["variables"][name][fld] == rv[fld], (name, fld)
    for name, rf in ref["freq"].items():
        pd.testing.assert_series_equal(port["freq"][name].sort_index(),
                                       rf.sort_index(), check_names=False)


def _table(n):
    rng = np.random.default_rng(0)
    return pa.Table.from_pandas(pd.DataFrame({
        "x": rng.normal(size=n), "s": rng.choice(["u", "v", "w"], n)}),
        preserve_index=False)


def test_fragment_retry_resumes_without_duplicates():
    table = _table(90)

    class FlakyFragment:
        def __init__(self):
            self.calls = 0

        def to_batches(self, batch_size, columns=None):
            self.calls += 1
            batches = table.to_batches(max_chunksize=30)
            if self.calls == 1:
                yield batches[0]
                raise OSError("transient read failure")
            yield from batches

    def scanner_batches(batch_size, columns=None):
        # the scanner delivers one batch then dies: the fragment path takes
        # over and skips what was delivered
        yield table.to_batches(max_chunksize=30)[0]
        raise OSError("scanner failure")

    ingest = ArrowIngest(table, batch_rows=30)
    frag = FlakyFragment()
    ingest._table = None
    ingest._dataset = types.SimpleNamespace(
        to_batches=scanner_batches, get_fragments=lambda: [frag],
        schema=table.schema)
    got = list(ingest.raw_batches())
    assert sum(rb.num_rows for rb in got) == 90 and frag.calls == 2
    assert pa.Table.from_batches(got).equals(table)


def test_fragment_retry_exhaustion_raises():
    class DeadFragment:
        calls = 0

        def to_batches(self, batch_size, columns=None):
            DeadFragment.calls += 1
            raise OSError("gone")
            yield  # pragma: no cover

    def dead_scanner(batch_size, columns=None):
        raise OSError("gone")
        yield  # pragma: no cover

    ingest = ArrowIngest(_table(10), batch_rows=10, max_retries=1)
    ingest._table = None
    ingest._dataset = types.SimpleNamespace(
        to_batches=dead_scanner, get_fragments=lambda: [DeadFragment()],
        schema=_table(1).schema)
    with pytest.raises(OSError, match="gone"):
        list(ingest.raw_batches())
    assert DeadFragment.calls == 2          # the read and one retry


@pytest.mark.parametrize("var,fn", [
    ("TPUPROF_PREPARE_WORKERS", "resolve_prepare_workers"),
    ("TPUPROF_PREP_WORKERS", "resolve_prep_workers"),
    ("TPUPROF_DECODE_THREADS", "resolve_prep_workers")])
def test_worker_env_vars_as_the_reference(monkeypatch, var, fn):
    for v in ("TPUPROF_PREPARE_WORKERS", "TPUPROF_PREP_WORKERS",
              "TPUPROF_DECODE_THREADS"):
        monkeypatch.delenv(v, raising=False)
    mine, ref = getattr(config, fn), getattr(ref_config, fn)
    assert mine(None) == ref(None)
    monkeypatch.setenv(var, "3")
    assert mine(None) == ref(None) == 3
    assert mine(7) == ref(7) == 7       # the config value beats the env
    assert mine(0) == ref(0) == 1
    assert os.environ[var] == "3"


def test_rowhash_in_memory_equals_parquet_dictionary_path(tmp_path,
                                                         monkeypatch):
    """In memory an id column takes the row-hash path from its second
    batch; read from Parquet it arrives dictionary-encoded and never does.
    The two profiles are equal but for ``memorysize`` (the Arrow layout)."""
    from tpuprof_torch.report.export import stats_to_json
    real, calls = port_arrow._row_hashed, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_arrow, "_row_hashed", counted)
    rng = np.random.default_rng(4)
    n, batch = 3 * 20_000, 20_000
    table = pa.table({
        "uid": pa.array(np.char.add("u", rng.integers(0, 10**12, n)
                                    .astype(str))),
        "city": pa.array(np.array(["a", "b", "c"])[rng.integers(0, 3, n)]),
        "x": pa.array(rng.normal(size=n)),
    })
    path = str(tmp_path / "ids.parquet")
    pq.write_table(table, path, row_group_size=batch)
    docs = []
    for source in (table, path):
        doc = stats_to_json(tpuprof_torch.describe(
            source, device="cpu", batch_rows=batch, prepare_workers=1))
        for section in (doc, doc["display"]):
            section["table"].pop("memorysize")
            for var in section["variables"].values():
                var.pop("memorysize")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["variables"]["uid"]["type"] == "UNIQUE"
    assert len(calls) == 2          # batches 2 and 3 of the in-memory run


def test_column_pool_defaults_to_serial_beside_batch_prepares(monkeypatch):
    """With several batches prepared at once the default column width is
    1; a config value or an env var still sets it, and with one prepare at
    a time the default is the reference's."""
    for v in ("TPUPROF_PREP_WORKERS", "TPUPROF_DECODE_THREADS"):
        monkeypatch.delenv(v, raising=False)
    assert config.resolve_prep_workers(None, batch_workers=4) == 1
    assert config.resolve_prep_workers(None, batch_workers=1) == \
        ref_config.resolve_prep_workers(None)
    assert config.resolve_prep_workers(6, batch_workers=4) == 6
    monkeypatch.setenv("TPUPROF_PREP_WORKERS", "5")
    assert config.resolve_prep_workers(None, batch_workers=4) == 5
