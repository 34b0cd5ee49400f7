"""The generator repeats by seed and keeps the workload's rules."""

import numpy as np

from portbench.generator import Pool
from portbench.reference.sketch import hist_bucket
from portbench.tests.small import small_cell


def mix():
    return small_cell("default.feed")[3]


def test_same_seed_same_stream():
    a, b = Pool(mix(), 2_147_483_701), Pool(mix(), 2_147_483_701)
    for g in (0, 3, 4, 9):
        for k, v in a.columns(g).items():
            np.testing.assert_array_equal(v, b.columns(g)[k], err_msg=k)


def test_other_seed_other_stream():
    a, b = Pool(mix(), 5), Pool(mix(), 6)
    assert not np.array_equal(a.columns(0)["trace_h"], b.columns(0)["trace_h"])


def test_a_pass_restamps_ids_and_keeps_the_rest():
    p = Pool(mix(), 2 ** 33 + 7)
    first, again = p.columns(1), p.columns(1 + p.size)
    assert not np.intersect1d(first["trace_h"], again["trace_h"]).size
    for k in ("svc", "rsvc", "key", "err", "kind", "shared", "valid", "tl1", "s1", "p1"):
        np.testing.assert_array_equal(first[k], again[k], err_msg=k)
    np.testing.assert_array_equal(hist_bucket(first["dur"]), hist_bucket(again["dur"]))
    assert not np.array_equal(first["dur"], again["dur"])
    # roots stay roots and children keep pointing at their parent's span
    roots = (first["p0"] | first["p1"]) == 0
    np.testing.assert_array_equal(roots, (again["p0"] | again["p1"]) == 0)
    child = np.nonzero(~roots)[0]
    np.testing.assert_array_equal(again["p0"][child] ^ first["p0"][child],
                                  again["s0"][child] ^ first["s0"][child])
    assert again["ts_min"][0] == first["ts_min"][0] + p.size


def test_traces_are_chains_of_rpc_pairs():
    p = Pool(mix(), 11)
    c = p.columns(0)
    per = p.per_trace
    assert (c["kind"][0::2] == 1).all() and (c["kind"][1::2] == 2).all()
    assert (c["svc"][0::2] != c["rsvc"][0::2]).all()
    np.testing.assert_array_equal(c["rsvc"][0::2], c["svc"][1::2])
    assert len(np.unique(c["trace_h"][::per])) == p.traces
