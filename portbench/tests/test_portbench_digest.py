"""The reference digest's rules by hand, their agreement with the
program's digest on the CPU, and the rank distances the comparison holds
the quantiles to."""

import numpy as np
import torch

from portbench import compare
from portbench.reference import digest


def test_fold_groups_by_hand():
    # batches of 2 into a buffer of 4: folds before batch 2 (it would
    # overflow), at the read after batch 3, and the rest at the end
    assert digest.fold_groups(5, 2, 4, [3]) == [(0, 2), (2, 3), (3, 5)]
    assert digest.fold_groups(4, 2, 4, []) == [(0, 2), (2, 4)]
    # a read fold with nothing pending still reclusters
    assert digest.fold_groups(2, 2, 4, [2, 2]) == [(0, 2), (2, 2)]


def test_compact_and_quantiles_by_hand():
    keys = torch.tensor([0, 0, 0, 1, -1])
    values = torch.tensor([3.0, 1.0, 2.0, 5.0, 9.0])
    d = digest.compact(keys, values, 2, 64)
    # three points a key: quantile positions 1/6, 1/2, 5/6 fall in k1
    # clusters 17, 32 and 46 of 64
    live = d[0, :, 1] > 0
    assert torch.nonzero(live).ravel().tolist() == [17, 32, 46]
    assert d[0, live, 0].tolist() == [1.0, 2.0, 3.0]
    assert d[1, 32].tolist() == [5.0, 1.0] and d[1, :, 1].sum() == 1
    q = digest.quantiles(digest.merge(torch.zeros_like(d), d), (0.5, 0.99))
    assert q[0].tolist() == [2.0, 3.0] and q[1].tolist() == [5.0, 5.0]


def test_the_reference_digest_agrees_with_the_program_on_the_cpu():
    from zipkin_tpu_torch.ops import tdigest

    g = torch.Generator().manual_seed(7)
    rows, c = 5, 64
    mine = torch.zeros((rows, c, 2))
    port = torch.zeros((rows, c, 2))
    for _ in range(40):
        keys = torch.randint(-1, rows, (4096,), generator=g)
        values = torch.exp(torch.randn(4096, generator=g) + 8.0).round()
        mine = digest.merge(mine, digest.compact(keys, values, rows, c))
        w = (keys >= 0).to(torch.float32)
        port = tdigest.row_merge(port, tdigest.compact_points(keys.clamp(min=0), values, w,
                                                              rows, c))
    assert torch.equal(mine[..., 1], port[..., 1])
    torch.testing.assert_close(mine[..., 0], port[..., 0], rtol=1e-6, atol=0)
    qs = torch.tensor([0.5, 0.99])
    torch.testing.assert_close(digest.quantiles(mine, (0.5, 0.99)), tdigest.quantile(port, qs),
                               rtol=1e-6, atol=0)


def test_lower_precision_moves_the_quantiles():
    g = torch.Generator().manual_seed(3)
    keys = torch.randint(0, 4, (20000,), generator=g)
    values = torch.exp(torch.randn(20000, generator=g) + 8.0).round()
    exact = digest.quantiles(digest.compact(keys, values, 4, 64), (0.5, 0.99))
    low = digest.quantiles(digest.compact(keys, values, 4, 64, lower=True), (0.5, 0.99))
    assert not torch.equal(exact, low)
    torch.testing.assert_close(low, exact, rtol=2 ** -7, atol=0)


def test_rank_distances_by_hand():
    # one key, durations 1..10: the port's median 5 covers rank 0.4-0.5,
    # a reference median of 7.5 covers 0.7-0.7; they lie 0.2 apart
    values = np.array([[5.0], [10.0], [7.5], [10.0]])
    below = np.array([[4], [9], [7], [9]])
    upto = np.array([[5], [10], [7], [10]])
    gap, readings = compare.digest_gaps(values, below, upto, np.array([10]), 10)
    assert abs(gap - 0.2) < 1e-12
    assert readings["port_rank_p50"] == 0.0 and abs(readings["reference_rank_p50"] - 0.2) < 1e-12
    assert compare.digest_gaps(values, below, upto, np.array([10]), 11) == (0.0, {})


class _Pool:
    size = 1

    def stamp(self, g):
        return np.array([0, 0, 0, g], np.uint32)


def test_rank_ranges_count_each_keys_durations():
    class B:  # durations 10..13, each moved by the pass offset within a bucket of 4
        dur_lo = np.array([8, 8, 12, 12], np.uint32)
        dur_rel = np.array([2, 3, 0, 1], np.uint32)
        dur_mask = np.array([3, 3, 3, 3], np.uint32)

    pool = _Pool()
    pool.batches = [B]
    lanes = digest.Lanes(pool, [np.array([0, 0, 1, -1])], torch.device("cpu"))
    assert lanes.batch(0)[1].tolist() == [10.0, 11.0, 12.0, 13.0]
    assert lanes.batch(1)[1].tolist() == [11.0, 8.0, 13.0, 14.0]
    below, upto = digest.rank_ranges(lanes, 2, torch.tensor([[11.0, 13.0]]))
    assert below.tolist() == [[2, 1]] and upto.tolist() == [[4, 2]]
