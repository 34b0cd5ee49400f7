"""The reference's answers on a small hand-built trace set, against
answers worked out by hand."""

import numpy as np

from portbench.generator import Pool, PoolBatch
from portbench.reference import sketch
from portbench.reference.model import NEVER, Reference

AGG = dict(hll_precision=4, ring_capacity=32, link_buckets=2, bucket_minutes=2,
           hist_slices=2, hist_slice_minutes=3, time_buckets=2, time_bucket_minutes=1)
MIX = dict(batch_spans=8, pool_batches=1, services=3, names_per_service=2, hops=2,
           svc_zipf=0.9, name_zipf=1.2, error_rate=0.0, dur_median_us=100.0, dur_sigma=0.5,
           client_factor=1.0, batches_per_minute=1, base_minute=600)


def fmix32_py(x):
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def hand_pool():
    """Two traces of two hops: 1 -> 2 -> 3 (the second hop fails) and
    2 -> 1 -> 3; each hop a client span in the caller and a server span
    in the callee."""
    pool = Pool(MIX, 3)
    chain = np.array([[1, 2, 3], [2, 1, 3]])
    hop_err = np.array([[False, True], [False, False]])
    n = 8
    cols = {c: np.zeros(n, np.uint32) for c in ("trace_h", "tl0", "tl1", "s0", "s1", "p0", "p1")}
    cols["trace_h"][:4], cols["trace_h"][4:] = 0x1234, 0xBEEF
    svc = np.array([1, 2, 2, 3, 2, 1, 1, 3])
    rsvc = np.array([2, 0, 3, 0, 1, 0, 3, 0])
    key = svc * 2 + np.array([0, 1, 0, 0, 1, 1, 0, 0])
    dur = np.array([70, 65, 400, 300, 70, 66, 500, 4000], np.uint32)
    err = np.array([0, 0, 1, 1, 0, 0, 0, 0], bool)
    cols.update(shared=np.array([0, 1] * 4, bool), kind=np.array([1, 2] * 4, np.int32),
                svc=svc.astype(np.int32), rsvc=rsvc.astype(np.int32), key=key.astype(np.int32),
                err=err, dur=dur, has_dur=np.ones(n, bool), valid=np.ones(n, bool))
    pool.batches = [PoolBatch(cols, chain, hop_err)]
    pool._stamps = {}
    return pool


def test_fmix32_and_buckets_by_hand():
    for x in (0, 1, 0x1234, 0xFFFFFFFF, 123456789):
        assert int(sketch.fmix32(np.array([x]))[0]) == fmix32_py(x)
    got = sketch.hist_bucket(np.array([1, 63, 64, 65, 4000]))
    np.testing.assert_array_equal(got, [1, 63, 64, 64, 254])
    lo, width = sketch.hist_bucket_bounds(np.array([65, 4000]))
    np.testing.assert_array_equal(lo, [64, 3968])
    np.testing.assert_array_equal(width, [2, 64])


def test_hll_registers_by_hand():
    ref = Reference(hand_pool(), AGG)
    regs, snaps, _ = ref.replay(1, snapshots=[0])
    want = np.zeros((5, 16), np.uint8)
    th = [int(t) for t in ref.pool.trace_hashes(0)]
    for lane, s in enumerate([1, 2, 2, 3, 2, 1, 1, 3]):
        h = fmix32_py(th[lane // 4])
        bucket, rest = h >> 28, h & ((1 << 28) - 1)
        rho = 29 if rest == 0 else 28 - (rest.bit_length() - 1)
        want[s, bucket] = max(want[s, bucket], rho)
        want[4, bucket] = max(want[4, bucket], rho)
    np.testing.assert_array_equal(regs, want)
    assert not snaps[0].any()
    est = sketch.hll_estimate(regs)
    # two distinct traces: linear counting over 16 registers
    assert abs(est[4] - 16 * np.log(16 / (16 - 2))) < 1e-9


def test_links_counts_and_fold_schedule_by_hand():
    ref = Reference(hand_pool(), AGG)
    calls, errs = ref.links(1, 0, 10 ** 6)
    want = np.zeros((4, 4), int)
    want[1, 2] = want[2, 3] = want[2, 1] = want[1, 3] = 1
    np.testing.assert_array_equal(calls, want)
    assert errs[2, 3] == 1 and errs.sum() == 1
    # a ring of 4 batches folds its older half before batch 4 (batches 0
    # and 1) and before batch 6 (batches 2 and 3)
    np.testing.assert_array_equal(ref.rolled_at(10), [5, 5, 7, 7, 9, 9] + [NEVER] * 4)
    # after 10 batches (minutes 600..609): batches 0..5 folded into 2-minute
    # buckets 300, 301, 302, of which the 2 newest are live; 6..9 fresh
    calls, _ = ref.links(10, 0, 10 ** 6)
    assert calls[1, 2] == 8
    calls, _ = ref.links(10, 606, 607)
    assert calls[1, 2] == 2
    # a fold's bucket counts whole: minute 603 brings bucket 301 (602-603)
    calls, _ = ref.links(10, 603, 603)
    assert calls[1, 2] == 2
    total = ref.key_total(3)
    assert total[2] == 3 * 2 and total[5] == 3 * 2 and total[6] == 3 * 2 and total.sum() == 3 * 8
    assert ref.counters(3) == {"spans": 24, "spansWithDuration": 24, "spansWithError": 6,
                               "batches": 3}


def test_windows_and_time_tier_by_hand():
    ref = Reference(hand_pool(), AGG)
    # 3-minute slices, 2 live: after 7 batches (minutes 600..606) slices
    # 200 (600-602), 201 (603-605), 202 (606) -> 201 and 202 live
    np.testing.assert_array_equal(ref.window_batches(7, 0, 10 ** 6), [3, 4, 5, 6])
    np.testing.assert_array_equal(ref.window_batches(7, 603, 604), [3, 4, 5])
    regs, counts, calls, errs = ref.tt(7, 605, 606)
    assert counts.sum() == 16 and calls.sum() == 8 and errs.sum() == 2
