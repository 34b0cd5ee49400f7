"""The one module that pins u32 semantics for the port.

The JAX package keeps ids, hashes, counts and sort keys as ``uint32`` and
relies on wraparound multiply, logical right shift and unsigned ordering.
PyTorch has almost no uint32 arithmetic, so the port holds every u32
value as ``torch.int64`` in ``[0, 2**32)``:

- shifts, masks and xor of non-negative int64 are the u32 ones (a right
  shift of a non-negative value is logical);
- ordering and comparisons of int64 in ``[0, 2**32)`` are the unsigned
  ones, so the linker's ``0xFFFFFFFF`` invalid-lane sentinel sorts last
  and ``ts_min`` window compares stay unsigned;
- a multiply wraps through :func:`mul`, which splits the constant so no
  intermediate leaves int64 (no reliance on signed overflow);
- a count that JAX keeps as u32 is reduced with :func:`wrap` after every
  addition, so it reads back as the reference's wrapped value.

int32 leaves of the reference are int64 here too (torch indexes with
int64); they never leave the int32 range on this path. The reference's
one int32 overflow (``histogram.bucket_bounds`` in the top octave) is
reproduced explicitly with :func:`as_int32` where it happens.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

DTYPE = torch.int64
MASK = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Reduce mod 2**32 (the u32 view of an int64 value)."""
    return x & MASK


def add(x: torch.Tensor, y) -> torch.Tensor:
    """u32 wraparound add."""
    return (x + y) & MASK


def index_add_(plane: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``plane[idx] += vals`` in place, then the touched cells wrapped —
    a u32 scatter-add without a pass over the whole plane."""
    plane.index_add_(0, idx, vals)
    plane[idx] = wrap(plane[idx])


def mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """u32 wraparound multiply of ``x`` (int64 in [0, 2**32)) by the
    constant ``c`` < 2**32: ``x*c_lo`` < 2**48 and the high half only
    contributes its low 16 bits shifted by 16, so nothing overflows."""
    lo = c & 0xFFFF
    hi = (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret the low 32 bits as a signed int32 value (still int64):
    what an int32 computation in the reference would have wrapped to."""
    return ((x + (1 << 31)) & MASK) - (1 << 31)


def bits32(x: torch.Tensor) -> torch.Tensor:
    """The int32 tensor holding the bits of ``x``'s u32 values — the form
    the HLL kernel reads (4 B a hash)."""
    return as_int32(x).to(torch.int32)


def stage_bits(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy ``uint32`` array -> the int32 tensor of its bits on the
    host, staged for a copy to ``device``: in pinned memory for a card (the
    copy then queues behind the stream's work; a pageable one would wait
    for that work before it returns), a copy of its own otherwise."""
    a = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    if torch.device(device).type == "cuda":
        return torch.empty(a.shape, dtype=torch.int32, pin_memory=True).copy_(torch.from_numpy(a))
    return torch.from_numpy(a.copy())


def upload_bits(arr: np.ndarray, device, out=None) -> torch.Tensor:
    """A numpy ``uint32`` array -> the int32 tensor of its bits on
    ``device`` (4 bytes a value), or written into ``out`` (an int32 tensor
    of the same shape there) and returned."""
    t = stage_bits(arr, device)
    if out is None:
        return t.to(device, non_blocking=True)
    return out.copy_(t, non_blocking=True)


def widen(bits: torch.Tensor) -> torch.Tensor:
    """The int64 u32 values of an int32 tensor of bits."""
    return bits.to(DTYPE) & MASK


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy ``uint32`` array -> int64 tensor on ``device``. The copy to
    the card moves 4 bytes a value (the bits travel as int32) and widens
    there."""
    return widen(upload_bits(arr, device))


def pack_order_lanes(lanes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pack u32 key lanes pairwise into int64 lanes whose lexicographic
    (signed) order equals the unsigned lexicographic order of the input:
    ``(a - 2**31) * 2**32 + b`` for each pair, a lone last lane as is."""
    out = []
    for i in range(0, len(lanes) - 1, 2):
        out.append((lanes[i] - (1 << 31)) * (1 << 32) + lanes[i + 1])
    if len(lanes) % 2:
        out.append(lanes[-1])
    return out


def lexsort(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting by ``lanes`` (most significant first,
    u32 values) with the original index as the final tie-break — the
    order of XLA's stable multi-key ``lax.sort``. Chained stable sorts,
    least significant packed lane first."""
    packed = pack_order_lanes(lanes)
    perm = None
    for key in reversed(packed):
        k = key if perm is None else key[perm]
        o = torch.sort(k, stable=True).indices
        perm = o if perm is None else perm[o]
    return perm


def lex_lt(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise lexicographic ``a < b`` over parallel lane lists."""
    lt = a[-1] < b[-1]
    for k in range(len(a) - 2, -1, -1):
        lt = (a[k] < b[k]) | ((a[k] == b[k]) & lt)
    return lt


def lex_eq(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    eq = a[0] == b[0]
    for k in range(1, len(a)):
        eq = eq & (a[k] == b[k])
    return eq
