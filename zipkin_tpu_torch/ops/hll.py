"""HyperLogLog registers (port of ``zipkin_tpu/ops/hll.py``).

``uint8 [rows, 2**p]`` register files; :func:`update` raises registers by
scatter-max and :func:`update_step` raises all of an ingest step's
registers (per-service and global rows of ``hll`` and of the time tier's
flat view) in one launch — both through the Hopper kernel on the card, see
:mod:`zipkin_tpu_torch.ops.hll_kernel`. :func:`merge` is element-wise
max, :func:`estimate` the bias-corrected harmonic mean with linear
counting below 2.5m (no 32-bit large-range correction, as in the
reference — its docstring gives the measured reason). The host half,
:func:`standard_error`, :func:`bias_fraction` and :func:`envelope_max`,
says where an estimate stops being one: the store flags rows past the
envelope.
"""

from __future__ import annotations

import math

import torch

from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.ops import hll_kernel


def new_registers(rows: int, precision: int = 11, device=None) -> torch.Tensor:
    """Zeroed registers on the card unless ``device`` names another."""
    return torch.zeros((rows, 1 << precision), dtype=torch.uint8, device=resolve_device(device))


def update(registers, row_ids, hashes, valid) -> torch.Tensor:  # zt-in-place: registers — scatter-max into the file
    """Scatter-max ``rho`` of each hash into ``registers[row, bucket]``,
    IN PLACE (the reference returns a new array; the port saves the copy
    of the register file). Invalid lanes are inert."""
    return hll_kernel.update(registers, row_ids, hashes, valid)


def update_step(hll, tb_flat, hashes, svc, valid, tb_keep, slot, *,
                max_services: int, hll_rows: int, global_row: int):  # zt-in-place: hll — every register file of the step is raised in place
    """The ingest step's four register updates in one pass, IN PLACE:
    ``hll`` at ``clamp(svc, 0, max_services-1)`` (lanes ``valid & svc > 0``)
    and at ``global_row`` (``valid``); with the time tier (``tb_flat``
    not None) the same two rows of slot ``slot`` (``tb_keep``). Integer
    max is order-free, so the registers equal the four separate updates."""
    return hll_kernel.update_step(hll, tb_flat, hashes, svc, valid, tb_keep, slot,
                                  max_services=max_services, hll_rows=hll_rows,
                                  global_row=global_row)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lossless sketch union."""
    return torch.maximum(a, b)


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate(registers: torch.Tensor) -> torch.Tensor:
    """Cardinality estimate per row, ``[rows]`` float32."""
    m = registers.shape[-1]
    alpha = _alpha(m)
    regs = registers.to(torch.float32)
    harm = torch.sum(torch.exp2(-regs), dim=-1)
    raw = alpha * m * m / harm
    zeros = torch.sum(registers == 0, dim=-1).to(torch.float32)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_linear, linear, raw)


def standard_error(precision: int) -> float:
    return 1.04 / math.sqrt(1 << precision)


# |bias| / n of the raw estimator against the distinct count n, as the
# reference measured it: 32-bit hash-space saturation drives it, so the
# curve depends on n and not on m up to the 4e9 hash boundary
BIAS_CURVE = (
    (5.0e8, 0.004),
    (1.0e9, 0.012),
    (2.0e9, 0.044),
    (4.0e9, 0.140),
)


def bias_fraction(n: float) -> float:
    """|bias|/n of the raw estimator at ``n`` distinct values: log-log
    interpolation of :data:`BIAS_CURVE`, clamped to the measured range."""
    pts = BIAS_CURVE
    if n <= pts[0][0]:
        return pts[0][1]
    if n >= pts[-1][0]:
        return pts[-1][1]
    for (n0, b0), (n1, b1) in zip(pts, pts[1:]):
        if n <= n1:
            t = (math.log(n) - math.log(n0)) / (math.log(n1) - math.log(n0))
            return math.exp(math.log(b0) + t * (math.log(b1) - math.log(b0)))
    return pts[-1][1]  # pragma: no cover - the loop always returns


def envelope_max(precision: int = 11) -> float:
    """Largest cardinality the estimator serves inside its operating
    envelope: where |bias| crosses half the 3-sigma noise gate (the inverse
    of :func:`bias_fraction` over the same segments; about 1.8e9 at p=11).
    Only the gate moves with ``precision``; past 4e9 every precision is out
    of its envelope."""
    gate = 1.5 * standard_error(precision)
    pts = BIAS_CURVE
    if gate <= pts[0][1]:
        return pts[0][0]
    for (n0, b0), (n1, b1) in zip(pts, pts[1:]):
        if gate <= b1:
            t = (math.log(gate) - math.log(b0)) / (math.log(b1) - math.log(b0))
            return math.exp(math.log(n0) + t * (math.log(n1) - math.log(n0)))
    return pts[-1][0]
