"""The port's row sampler folds a batch by priority first.

``RowSampler.update`` decides the surviving rows from the batch's
priorities and the sample's own, then copies only those rows out of the
batch plane.  The sample must stay the reference's
(``tpuprof/ingest/sample.py``) byte for byte and in the same row order
after every ``update`` and ``merge``, whatever the plane's layout, and a
fold must never allocate anything like a copy of the whole batch.
"""

import tracemalloc

import numpy as np
import pytest

from tpuprof.ingest.sample import RowSampler as RefSampler
from tpuprof_torch.ingest import sample
from tpuprof_torch.ingest.sample import RowSampler

# name -> (k, n_num, process_index, batches); a batch is (nrows, plane
# rows, fill): rows past nrows are padding, fill plants NaN and infinities
CASES = {
    "first_batch_over_k": (64, 5, 0, [(300, 300, None), (300, 300, None),
                                      (120, 120, None)]),
    "small_batches_cross_k": (64, 3, 0, [(20, 20, None), (30, 30, None),
                                         (25, 25, None), (40, 40, None)]),
    "padded_last_batch": (48, 4, 0, [(64, 64, None), (64, 64, None),
                                     (37, 64, None)]),
    "nan_and_inf_rows": (32, 4, 0, [(50, 50, "nonfinite"),
                                    (50, 50, "nonfinite"),
                                    (16, 16, "nonfinite")]),
    "no_candidate_beats_the_threshold": (8, 3, 0, [(10_000, 10_000, None)]
                                         + [(5, 5, None)] * 12),
    "process_index_2": (40, 6, 2, [(70, 70, None), (33, 50, None),
                                   (90, 90, None)]),
}


def _plane(rng, rows, n_num, fill, layout):
    x = rng.standard_normal((rows, n_num)).astype(np.float32)
    if fill == "nonfinite":
        x[rng.random((rows, n_num)) < 0.2] = np.nan
        x[::7, 0] = np.inf
        x[3::11, -1] = -np.inf
        x[5] = np.nan                          # a row with no finite value
    return np.asfortranarray(x) if layout == "F" else x


def _same(mine, ref):
    assert mine.values.flags.c_contiguous
    assert mine.values.dtype == ref.values.dtype
    assert mine.values.shape == ref.values.shape
    assert mine.values.tobytes() == ref.values.tobytes()
    assert mine.prio.tobytes() == ref.prio.tobytes()
    assert mine.step == ref.step


def _feed(mine, ref, batches, rng, layout):
    """Fold each batch into both samplers, comparing after every fold;
    returns the rows each fold copied out of its batch."""
    copied = []
    for nrows, rows, fill in batches:
        x = _plane(rng, rows, mine.n_num, fill, layout)
        before = sample.rows_copied
        mine.update(x, nrows)
        ref.update(x, nrows)
        copied.append(sample.rows_copied - before)
        _same(mine, ref)
    return copied


@pytest.mark.parametrize("layout", ["C", "F"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_is_the_reference_byte_for_byte(case, layout):
    k, n_num, pi, batches = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    mine = RowSampler(k, n_num, seed=2**31 + 5, process_index=pi)
    ref = RefSampler(k, n_num, seed=2**31 + 5, process_index=pi)
    offered = sample.rows_offered
    copied = _feed(mine, ref, batches, rng, layout)
    assert sample.rows_offered - offered == sum(b[0] for b in batches)
    assert all(c <= min(b[0], k) for c, b in zip(copied, batches))
    if case == "no_candidate_beats_the_threshold":
        assert copied.count(0) >= 6

    # a second part, on another process's stream, merged both ways round
    other = RowSampler(k, n_num, seed=2**31 + 5, process_index=pi + 1)
    other_ref = RefSampler(k, n_num, seed=2**31 + 5, process_index=pi + 1)
    _feed(other, other_ref, batches[:2], rng, layout)
    _same(mine.merge(other), ref.merge(other_ref))

    # a part still filling, which merges without compacting
    small = RowSampler(k, n_num, seed=7, process_index=pi + 3)
    small_ref = RefSampler(k, n_num, seed=7, process_index=pi + 3)
    _feed(small, small_ref, [(k // 4, k // 4, None)], rng, layout)
    empty = RowSampler(k, n_num)
    empty_ref = RefSampler(k, n_num)
    _same(empty.merge(small), empty_ref.merge(small_ref))
    _same(small.merge(mine), small_ref.merge(ref))


def test_a_fold_copies_only_the_surviving_rows():
    k, n_num, rows = 4096, 256, 65_536
    x = np.asfortranarray(np.random.default_rng(11).standard_normal(
        (rows, n_num), dtype=np.float32))
    mine = RowSampler(k, n_num, seed=3)
    offered, copied = sample.rows_offered, sample.rows_copied
    tracemalloc.start()
    try:
        mine.update(x, rows)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # the whole-batch copy alone would be 67 MB, 16 times the sample
    assert peak < 4 * k * n_num * 4
    assert sample.rows_offered - offered == rows
    assert sample.rows_copied - copied == k    # every kept row is new
    ref = RefSampler(k, n_num, seed=3)
    ref.update(x, rows)
    _same(mine, ref)
