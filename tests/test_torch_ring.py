"""The port's span ring (``zipkin_tpu_torch.tpu.ring``) against the JAX
package's (``zipkin_tpu.tpu.ring``), on the CPU.

The reference's own cases (``tests/test_ring.py``) run against the port:
wraparound under sustained load, the peek-ahead run, a producer SIGKILLed
mid-write leaving a torn slot that the pid-guarded reclaim resets, the
discard of a dead worker's published slots, the blocking claim and the
oversized-sidecar guard. Across packages: the header layout constants are
equal, and a slot written by one package's ``RingProducer`` reads back
through the other's ``SpanRing`` word for word (image, header, sidecar).
Everything compared is integer or bytes: exact.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.tpu import ring as ref_ring
from zipkin_tpu_torch.tpu import ring as ring_mod
from zipkin_tpu_torch.tpu.ring import RingProducer, SpanRing, pack_aux, unpack_aux


def _drain_one(ring, w: int = 0, mod=ring_mod):
    got = ring.peek(w)
    assert got is not None
    hdr, seq = got
    per = int(hdr[mod._S_PER])
    img = np.array(ring.image(w, seq, per))
    aux_len = int(hdr[mod._S_AUX_LEN])
    aux = mod.unpack_aux(ring.aux(w, seq, aux_len)) if aux_len else None
    ring.free_next(w)
    return hdr, img, aux


def _publish(prod, pidx, per=4, aux=b"", **kw):
    fields = dict(pidx=pidx, wseq=prod.next_wseq(), per=per, n_spans=1, n_dur=0, n_err=0,
                  dropped=0, ts_min=0, ts_max=0, parse_ns=0, pack_ns=0, route_ns=0, aux=aux)
    fields.update(kw)
    prod.publish(**fields)


def test_wraparound_under_sustained_load():
    """Sequence numbers wrap the stripe many times over; every publish is
    consumed intact (payload id, image, sidecar) in publish order."""
    ring = SpanRing(1, stripe_slots=4, img_cap_u32=64, aux_cap=4096)
    prod = RingProducer(ring.params(), 0)
    try:
        for i in range(37):  # 9+ full wraps of a 4-slot stripe
            prod.claim()
            # a transient view: a retained one would pin the segment
            prod.image(8)[:] = np.arange(8, dtype=np.uint32) + i
            _publish(prod, i, per=8, n_spans=5, n_dur=4, n_err=1, ts_min=i, ts_max=i + 1,
                     aux=pack_aux([f"s{i}"], [], [], [], None))
            if ring.stripe_full(0):
                # drain two, so the next claims land on wrapped indices
                for _ in range(2):
                    hdr, img_out, aux = _drain_one(ring)
                    j = int(hdr[ring_mod._S_PIDX])
                    np.testing.assert_array_equal(img_out, np.arange(8, dtype=np.uint32) + j)
                    assert aux[0] == [f"s{j}"]
        drained = 0
        while ring.stripe_depth(0) > 0:
            _drain_one(ring)
            drained += 1
        assert drained > 0
        assert ring.occupancy() == 0
        assert prod.next_wseq() == 37
    finally:
        prod.close()
        ring.close()


def test_peek_ahead_reads_ready_run_in_order():
    ring = SpanRing(1, stripe_slots=8, img_cap_u32=16, aux_cap=1024)
    prod = RingProducer(ring.params(), 0)
    try:
        for i in range(5):
            prod.claim()
            prod.image(4)[:] = i
            _publish(prod, 100 + i)
        for ahead in range(5):
            hdr, _seq = ring.peek(0, ahead)
            assert int(hdr[ring_mod._S_PIDX]) == 100 + ahead
            assert int(hdr[ring_mod._S_WSEQ]) == ahead
        assert ring.peek(0, 5) is None  # past the published run
        for _ in range(5):
            ring.free_next(0)
        assert ring.peek(0) is None
    finally:
        prod.close()
        ring.close()


def _torn_writer(params, barrier):
    """Child: claim a slot, write half an image, then SIGKILL itself."""
    prod = RingProducer(params, 0)
    prod.claim()
    img = prod.image(16)
    img[:8] = 0xDEAD
    barrier.wait()
    os.kill(os.getpid(), signal.SIGKILL)


def test_sigkill_mid_write_reclaims_torn_slot():
    """A producer SIGKILLed between claim and publish leaves a torn WRITING
    slot: reclaim reports it torn, resets it with an even generation, and
    a successor producer runs a full cycle through it."""
    ring = SpanRing(1, stripe_slots=4, img_cap_u32=64, aux_cap=1024)
    ctx = mp.get_context("spawn")
    barrier = ctx.Barrier(2)
    child = ctx.Process(target=_torn_writer, args=(ring.params(), barrier), daemon=True)
    child.start()
    try:
        barrier.wait(timeout=30)
        child.join(timeout=30)
        assert not child.is_alive()
        assert ring.peek(0) is None  # never READY
        hdr = ring._hdr(ring._slot_base(0, 0))
        assert int(hdr[ring_mod._S_GEN]) % 2 == 1
        assert int(hdr[ring_mod._S_PID]) == child.pid
        del hdr
        assert ring.reclaim_stripe(0, child.pid) == {"discarded": 0, "torn": 1}
        prod = RingProducer(ring.params(), 0)
        try:
            prod.claim()
            prod.image(4)[:] = 7
            _publish(prod, 1)
            hdr, img, _aux = _drain_one(ring)
            assert int(hdr[ring_mod._S_PIDX]) == 1
            assert int(hdr[ring_mod._S_GEN]) % 2 == 0
            np.testing.assert_array_equal(img, np.full(4, 7, np.uint32))
        finally:
            prod.close()
    finally:
        if child.is_alive():  # pragma: no cover - hang safety
            child.terminate()
        ring.close()


def test_reclaim_discards_published_but_unconsumed_slots():
    ring = SpanRing(2, stripe_slots=4, img_cap_u32=16, aux_cap=1024)
    prod = RingProducer(ring.params(), 1)
    try:
        for i in range(3):
            prod.claim()
            prod.image(2)[:] = i
            _publish(prod, i, per=2)
        assert ring.reclaim_stripe(1) == {"discarded": 3, "torn": 0}
        assert ring.stripe_depth(1) == 0
        assert ring.peek(1) is None
        assert ring.stripe_depth(0) == 0  # the sibling stripe is untouched
    finally:
        prod.close()
        ring.close()


def test_claim_blocks_until_slot_freed():
    ring = SpanRing(1, stripe_slots=2, img_cap_u32=8, aux_cap=256)
    prod = RingProducer(ring.params(), 0)
    try:
        for i in range(2):
            prod.claim()
            _publish(prod, i, per=0, n_spans=0)
        assert ring.stripe_full(0)
        assert not prod.try_claim()
        t0 = time.perf_counter()
        ring.free_next(0)
        waited = prod.claim()
        assert time.perf_counter() - t0 < 5.0
        assert waited >= 0.0
    finally:
        prod.close()
        ring.close()


def test_oversized_sidecar_and_image_are_refused():
    """A sidecar past ``aux_cap`` or an image past ``img_cap_u32`` raises
    instead of truncating (the worker routes such a chunk through the
    result queue before it claims)."""
    ring = SpanRing(1, stripe_slots=2, img_cap_u32=8, aux_cap=64)
    prod = RingProducer(ring.params(), 0)
    try:
        big = pack_aux(["x" * 1024], [], [], [], None)
        assert len(big) > prod.aux_cap
        prod.claim()
        with pytest.raises(ValueError):
            prod.publish(pidx=0, wseq=0, per=0, n_spans=0, n_dur=0, n_err=0, dropped=0,
                         ts_min=0, ts_max=0, parse_ns=0, pack_ns=0, route_ns=0, aux=big)
        with pytest.raises(ValueError):
            prod.image(9)
    finally:
        prod.close()
        ring.close()


# -- across packages -----------------------------------------------------------


def test_layout_constants_equal_the_reference():
    names = [n for n in dir(ref_ring) if n.startswith("_S_") or n.startswith("ST_")]
    names += ["RING_MAGIC", "SLOT_HDR_WORDS", "_HDR_WORDS", "_CTL_WORDS", "_ALIGN"]
    assert len(names) > 20
    for n in names:
        assert getattr(ring_mod, n) == getattr(ref_ring, n), n


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_slot_written_by_one_package_reads_back_in_the_other(writer):
    """Three slots (a multi-word image, a sidecar with a vocab journal and
    archive slices, a continuation chunk) published by one package's
    producer into a ring the other package owns: every header word, the
    image and the unpickled sidecar come back equal."""
    owner, prod_mod = (ref_ring, ring_mod) if writer == "port" else (ring_mod, ref_ring)
    ring = owner.SpanRing(2, stripe_slots=4, img_cap_u32=11 * 256, aux_cap=1 << 14)
    prod = prod_mod.RingProducer(ring.params(), 1)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 1 << 32, (1, 11, 256), dtype=np.uint32) for _ in range(3)]
    sidecars = [(["svc-a", "svc-b"], ["get /"], [(1, 1), (2, 1)], [b'{"id":"1"}'], None),
                ([], [], [], [], None), (["svc-c"], [], [(3, 0)], [], None)]
    try:
        for i, (img, side) in enumerate(zip(images, sidecars)):
            prod.claim()
            prod.image(img.size)[:] = img.reshape(-1)
            prod.publish(pidx=40 + i, wseq=prod.next_wseq(), per=256, n_spans=200 + i,
                         n_dur=100, n_err=i, dropped=-1 if i == 2 else i, cslot=-1,
                         ts_min=1000 + i, ts_max=2000 + i, parse_ns=11, pack_ns=22, route_ns=33,
                         aux=prod_mod.pack_aux(*side))
        assert ring.stripe_depth(1) == 3 and ring.stripe_depth(0) == 0
        for i, (img, side) in enumerate(zip(images, sidecars)):
            hdr, seq = ring.peek(1)
            got = {n: int(hdr[getattr(owner, n)]) for n in (
                "_S_PIDX", "_S_WSEQ", "_S_PER", "_S_NSPANS", "_S_NDUR", "_S_NERR", "_S_DROPPED",
                "_S_CSLOT", "_S_TS_MIN", "_S_TS_MAX", "_S_PARSE_NS", "_S_PACK_NS", "_S_ROUTE_NS",
                "_S_TENANT", "_S_STATE")}
            assert got == {"_S_PIDX": 40 + i, "_S_WSEQ": i, "_S_PER": 256, "_S_NSPANS": 200 + i,
                           "_S_NDUR": 100, "_S_NERR": i, "_S_DROPPED": -1 if i == 2 else i,
                           "_S_CSLOT": -1, "_S_TS_MIN": 1000 + i, "_S_TS_MAX": 2000 + i,
                           "_S_PARSE_NS": 11, "_S_PACK_NS": 22, "_S_ROUTE_NS": 33,
                           "_S_TENANT": 0, "_S_STATE": owner.ST_READY}
            np.testing.assert_array_equal(np.array(ring.image(1, seq, img.size)), img.reshape(-1))
            assert owner.unpack_aux(ring.aux(1, seq, int(hdr[owner._S_AUX_LEN]))) == side
            ring.free_next(1)
        assert ring.occupancy() == 0
    finally:
        prod.close()
        ring.close()


def test_reclaim_of_a_torn_slot_left_by_the_other_package():
    """A slot claimed (odd generation, WRITING, this pid) by the reference's
    producer and never published is reset by the port's pid-guarded reclaim
    exactly as the reference's own reclaim resets it."""
    results = []
    for owner in (ring_mod, ref_ring):
        ring = owner.SpanRing(1, stripe_slots=2, img_cap_u32=8, aux_cap=64)
        prod = ref_ring.RingProducer(ring.params(), 0)
        try:
            prod.claim()
            prod.image(4)[:] = 9
            results.append(ring.reclaim_stripe(0, os.getpid()))
            hdr = ring._hdr(ring._slot_base(0, 0))
            results.append((int(hdr[owner._S_GEN]), int(hdr[owner._S_STATE])))
            del hdr
        finally:
            prod.close()
            ring.close()
    assert results[0] == results[2] == {"discarded": 0, "torn": 1}
    assert results[1] == results[3] == (2, ring_mod.ST_FREE)
