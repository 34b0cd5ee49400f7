"""Device-resident aggregate state (port of ``zipkin_tpu/tpu/state.py``).

:class:`AggState` has the reference's leaf names in the reference's
order. Leaf dtypes follow :mod:`zipkin_tpu_torch.u32`: u32 and i32
leaves are int64, u8 registers stay uint8, bool and float32 as they are.
:data:`LEAF_DTYPES` records the reference dtype of every leaf, which
:mod:`zipkin_tpu_torch.convert` uses to cross between the two.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from zipkin_tpu_torch import u32
from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.ops import histogram
from zipkin_tpu_torch.tpu.columnar import MAX_WIRE_KEYS, MAX_WIRE_SERVICES

CTR_SPANS, CTR_SPANS_DROPPED, CTR_WITH_DURATION, CTR_ERRORS, CTR_BATCHES = range(5)
CTR_SAMPLED_KEPT = 5
CTR_SAMPLED_DROPPED = 6
NUM_COUNTERS = 8


@dataclasses.dataclass(frozen=True)
class AggConfig:
    """Static shapes of the device state (same fields and defaults as the
    reference's AggConfig)."""

    max_services: int = 1024
    max_keys: int = 8192
    hll_precision: int = 11
    digest_centroids: int = 64
    digest_buffer: int = 1 << 17
    ring_capacity: int = 1 << 18
    link_buckets: int = 16
    bucket_minutes: int = 60
    hist_slices: int = 8
    hist_slice_minutes: int = 60
    sampling: bool = False
    sample_rare_min: int = 4
    time_buckets: int = 4
    time_bucket_minutes: int = 5
    time_digest_centroids: int = 32

    def __post_init__(self) -> None:
        # the packed wire image gives service ids 16 bits and sketch keys
        # 24; a config beyond that would silently alias ids on device
        if self.max_services > MAX_WIRE_SERVICES:
            raise ValueError(
                f"max_services ({self.max_services}) exceeds the packed "
                f"wire limit ({MAX_WIRE_SERVICES})"
            )
        if self.max_keys > MAX_WIRE_KEYS:
            raise ValueError(
                f"max_keys ({self.max_keys}) exceeds the packed wire "
                f"limit ({MAX_WIRE_KEYS})"
            )

    @property
    def hll_rows(self) -> int:
        return self.max_services + 1

    @property
    def global_hll_row(self) -> int:
        return self.max_services

    @property
    def timetier_enabled(self) -> bool:
        return self.time_buckets > 0

    @property
    def rollup_segment(self) -> int:
        """Ring slots linked per rollup: half the ring."""
        return self.ring_capacity // 2


# reference dtype of every leaf, in AggState order
LEAF_DTYPES = {
    "hll": np.uint8, "hist": np.uint32, "hist_t": np.uint32,
    "hist_t_epoch": np.int32, "digest": np.float32,
    "pend_key": np.int32, "pend_val": np.float32, "pend_pos": np.int32,
    "r_trace_h": np.uint32, "r_tl0": np.uint32, "r_tl1": np.uint32,
    "r_s0": np.uint32, "r_s1": np.uint32, "r_p0": np.uint32, "r_p1": np.uint32,
    "r_shared": np.bool_, "r_kind": np.int32, "r_svc": np.int32,
    "r_rsvc": np.int32, "r_err": np.bool_, "r_ts_min": np.uint32,
    "r_valid": np.bool_, "r_keep": np.bool_, "r_rolled": np.bool_,
    "ring_pos": np.int32,
    "rollup_calls": np.uint32, "rollup_errs": np.uint32, "rollup_epoch": np.int32,
    "tb_epoch": np.int32, "tb_hll": np.uint8, "tb_digest": np.float32,
    "tb_calls": np.uint32, "tb_errs": np.uint32, "pend_ep": np.int32,
    "s_rate": np.uint32, "s_tail": np.uint32, "s_link": np.uint32,
    "ctx_order": np.int32, "ctx_keys": np.uint32, "ctx_rid_c": np.int32,
    "ctx_rid_f": np.int32, "ctx_inv": np.int32, "ctx_safe_sh": np.int32,
    "ctx_safe_ns": np.int32, "ctx_safe_fsh": np.int32, "ctx_parent": np.int32,
    "ctx_anc": np.int32, "ctx_root": np.bool_, "ctx_pos": np.int32,
    "ctx_delta": np.int32, "counters": np.uint32,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The port's dtype for a leaf of reference dtype ``np_dtype``."""
    return {
        np.uint8: torch.uint8, np.bool_: torch.bool, np.float32: torch.float32,
        np.uint32: u32.DTYPE, np.int32: torch.int64,
    }[np_dtype]


class AggState(NamedTuple):
    hll: torch.Tensor  # u8 [services+1, m]
    hist: torch.Tensor  # u32 [keys, BUCKETS] (all-time)
    hist_t: torch.Tensor  # u32 [T, keys, BUCKETS] (time slices)
    hist_t_epoch: torch.Tensor  # [T] absolute slice epoch, -1 empty
    digest: torch.Tensor  # f32 [keys, C, 2]
    pend_key: torch.Tensor  # [P] -1 = empty lane
    pend_val: torch.Tensor  # f32 [P]
    pend_pos: torch.Tensor  # scalar
    r_trace_h: torch.Tensor  # ring columns, all [R]
    r_tl0: torch.Tensor
    r_tl1: torch.Tensor
    r_s0: torch.Tensor
    r_s1: torch.Tensor
    r_p0: torch.Tensor
    r_p1: torch.Tensor
    r_shared: torch.Tensor
    r_kind: torch.Tensor
    r_svc: torch.Tensor
    r_rsvc: torch.Tensor
    r_err: torch.Tensor
    r_ts_min: torch.Tensor
    r_valid: torch.Tensor
    r_keep: torch.Tensor  # tail-sampling verdict (all False: sampling off)
    r_rolled: torch.Tensor  # lanes already folded into the rollups
    ring_pos: torch.Tensor  # scalar
    rollup_calls: torch.Tensor  # u32 [D, S, S]
    rollup_errs: torch.Tensor  # u32 [D, S, S]
    rollup_epoch: torch.Tensor  # [D] absolute bucket, -1 empty
    tb_epoch: torch.Tensor  # [W] time-tier bucket epoch, -1 empty
    tb_hll: torch.Tensor  # u8 [W, services+1, m]
    tb_digest: torch.Tensor  # f32 [W, keys, Cw, 2]
    tb_calls: torch.Tensor  # u32 [W, S, S]
    tb_errs: torch.Tensor  # u32 [W, S, S]
    pend_ep: torch.Tensor  # [P] bucket epoch per pending point, -1 empty
    s_rate: torch.Tensor  # u32 [S] sampler tables (read only when sampling)
    s_tail: torch.Tensor  # u32 [K]
    s_link: torch.Tensor  # u32 [S, S]
    ctx_order: torch.Tensor  # [2R] incremental link ctx (ops/delta_linker.py)
    ctx_keys: torch.Tensor  # u32 [4, 2R]
    ctx_rid_c: torch.Tensor
    ctx_rid_f: torch.Tensor
    ctx_inv: torch.Tensor
    ctx_safe_sh: torch.Tensor
    ctx_safe_ns: torch.Tensor
    ctx_safe_fsh: torch.Tensor
    ctx_parent: torch.Tensor  # [R]
    ctx_anc: torch.Tensor  # [R]
    ctx_root: torch.Tensor  # bool [R]
    ctx_pos: torch.Tensor  # scalar
    ctx_delta: torch.Tensor  # scalar
    counters: torch.Tensor  # u32 [NUM_COUNTERS]


def init_state(config: AggConfig, device=None) -> AggState:
    """Fresh state with the reference's load-bearing sentinels, on the
    card unless ``device`` names another."""
    device = resolve_device(device)
    r = config.ring_capacity
    s, k = config.max_services, config.max_keys
    m = 1 << config.hll_precision
    w = config.time_buckets

    def z(shape, name):
        return torch.zeros(shape, dtype=torch_dtype(LEAF_DTYPES[name]), device=device)

    def full(shape, value, name):
        return torch.full(shape, value, dtype=torch_dtype(LEAF_DTYPES[name]), device=device)

    def ar(size, name):
        return torch.arange(size, dtype=torch_dtype(LEAF_DTYPES[name]), device=device)

    ring = {f"r_{c}": z((r,), f"r_{c}") for c in (
        "trace_h", "tl0", "tl1", "s0", "s1", "p0", "p1", "shared", "kind",
        "svc", "rsvc", "err", "ts_min", "valid", "keep", "rolled")}
    return AggState(
        hll=z((config.hll_rows, m), "hll"),
        hist=z((k, histogram.BUCKETS), "hist"),
        hist_t=z((config.hist_slices, k, histogram.BUCKETS), "hist_t"),
        hist_t_epoch=full((config.hist_slices,), -1, "hist_t_epoch"),
        digest=z((k, config.digest_centroids, 2), "digest"),
        pend_key=full((config.digest_buffer,), -1, "pend_key"),
        pend_val=z((config.digest_buffer,), "pend_val"),
        pend_pos=z((), "pend_pos"),
        **ring,
        ring_pos=z((), "ring_pos"),
        rollup_calls=z((config.link_buckets, s, s), "rollup_calls"),
        rollup_errs=z((config.link_buckets, s, s), "rollup_errs"),
        rollup_epoch=full((config.link_buckets,), -1, "rollup_epoch"),
        tb_epoch=full((w,), -1, "tb_epoch"),
        tb_hll=z((w, config.hll_rows, m), "tb_hll"),
        tb_digest=z((w, k, config.time_digest_centroids, 2), "tb_digest"),
        tb_calls=z((w, s, s), "tb_calls"),
        tb_errs=z((w, s, s), "tb_errs"),
        pend_ep=full((config.digest_buffer if w else 0,), -1, "pend_ep"),
        # sampler tables boot in "keep everything" posture
        s_rate=full((s,), 65536, "s_rate"),
        s_tail=full((k,), u32.SENTINEL, "s_tail"),
        s_link=z((s, s), "s_link"),
        # incremental link ctx of the all-invalid ring: identity order,
        # every key 0xFFFFFFFF, one run, no candidates
        ctx_order=ar(2 * r, "ctx_order"),
        ctx_keys=full((4, 2 * r), u32.SENTINEL, "ctx_keys"),
        ctx_rid_c=full((2 * r,), 1, "ctx_rid_c"),
        ctx_rid_f=full((2 * r,), 1, "ctx_rid_f"),
        ctx_inv=ar(2 * r, "ctx_inv"),
        ctx_safe_sh=full((2 * r,), -1, "ctx_safe_sh"),
        ctx_safe_ns=full((2 * r,), -1, "ctx_safe_ns"),
        ctx_safe_fsh=full((2 * r,), -1, "ctx_safe_fsh"),
        ctx_parent=full((r,), -1, "ctx_parent"),
        ctx_anc=full((r,), -1, "ctx_anc"),
        ctx_root=full((r,), True, "ctx_root"),
        ctx_pos=z((), "ctx_pos"),
        ctx_delta=z((), "ctx_delta"),
        counters=z((NUM_COUNTERS,), "counters"),
    )


def state_bytes(state: AggState) -> int:
    """Device bytes held by a state's leaves."""
    return int(sum(t.numel() * t.element_size() for t in state))
