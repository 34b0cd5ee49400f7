"""Pointer-doubling ancestor chase: the hand-written Hopper kernel and its
plain twin.

Counterpart of ``zipkin_tpu/ops/linker.py:320-379`` (``chase_ancestors``,
whose passes the reference runs in a ``lax.while_loop`` on the device).
Over ``parent`` ``[n]`` (-1 for a root) and ``kind`` ``[n]`` (0 for a
kindless span): ``jump`` (nearest kinded ancestor-or-self) and ``root``
(toward the sentinel ``n``) are squared until a pass changes neither or
``ceil(log2(n+1))`` passes ran; then ``anc`` is the nearest strict
ancestor with a kind (-1 for none) and ``root_ok`` whether the chain ends
at a root. The CUDA source is ``csrc/link_chase.cu``; its note says what
bounds it on the card and how the design answers that.

:func:`chase` launches the kernel for CUDA tensors and runs
:func:`chase_plain` for CPU tensors: the CPU is the only reason it takes
the plain path; there is no switch and no fallback. Neither reads a value
back to the host. ``chase.launches`` counts kernel launches
(:func:`zipkin_tpu_torch.kernels.count_launch`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from zipkin_tpu_torch import kernels

MAX_PASSES = 64  # kMaxPasses in csrc/link_chase.cu (int32 pointers need <= 31)
THREADS = 1024  # kThreads: one cooperative block of this many threads an SM
MAX_OWNED = 16  # kMaxOwned: lanes a thread keeps in registers
MAX_LANES = (1 << 31) - 1  # n + 1 lanes, the sentinel's included, as int32 pointers


def doubling_passes(n: int) -> int:
    """Pointer-doubling passes that resolve chains of any depth in an
    n-lane window: ceil(log2(n+1)). Also the cap that makes malformed
    parent cycles terminate."""
    return max((n).bit_length(), 1)


def chase_plain(parent: torch.Tensor, kind: torch.Tensor,
                passes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: every pass of the cap runs (a converged pass changes
    nothing, so the result is the loop's); ``passes`` (a 0-d int32 tensor,
    when given) receives the passes the loop would have run, counted on the
    device: each pass up to and including the first that changed nothing."""
    n = parent.shape[0]
    dev = parent.device
    sent = n
    par = torch.where(parent >= 0, parent, sent)
    kind_ext = torch.cat([kind.to(torch.int64), torch.zeros(1, dtype=torch.int64, device=dev)])
    par_ext = torch.cat([par, torch.full((1,), sent, dtype=torch.int64, device=dev)])
    jump = torch.where(kind_ext != 0, torch.arange(n + 1, device=dev), par_ext)
    root = par_ext
    ran = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(doubling_passes(n)):
        j2 = jump[jump]
        r2 = root[root]
        ran += (~done).to(torch.int32)
        done |= ~((j2 != jump).any() | (r2 != root).any())
        jump, root = j2, r2
    if passes is not None:
        passes.copy_(ran)
    anc = jump[par]
    anc = torch.where(anc == sent, -1, anc)
    anc = torch.where((anc >= 0) & (kind_ext[torch.where(anc >= 0, anc, 0)] != 0), anc, -1)
    return anc, root[:n] == sent


_fn = []  # the bound C entry points, loaded at the first launch
_capacity = []  # lanes one launch holds on this process's cards


def _entry():
    if not _fn:
        lib = kernels.load("link_chase")
        fn = lib.link_chase
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [
            ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        cap = lib.link_chase_capacity
        cap.argtypes = []
        cap.restype = ctypes.c_longlong
        _capacity.append(int(cap()))
        _fn.append(fn)
    return _fn[0]


def check_lanes(n: int, capacity: Optional[int] = None) -> None:
    """Refuse a chase the kernel cannot take: ``n + 1`` lanes (the
    sentinel's included) must fit its int32 pointers, and, where
    ``capacity`` is given, the lanes one launch holds in registers
    (``MAX_OWNED`` a thread, one ``THREADS``-thread block an SM)."""
    if n + 1 > MAX_LANES:
        raise ValueError(f"link chase: {n} lanes, the kernel's int32 pointers take n + 1 <= {MAX_LANES}")
    if capacity is not None and n + 1 > capacity:
        raise ValueError(f"link chase: {n} lanes, one launch holds n + 1 <= {capacity} on this card")


def chase(parent: torch.Tensor, kind: torch.Tensor,
          passes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(anc [n] int64, root_ok [n] bool)`` of ``parent`` and ``kind``
    (each a contiguous int64 ``[n]`` on one device). ``passes``, a 0-d
    int32 tensor on that device when given, receives the passes run."""
    if parent.device.type == "cpu":
        return chase_plain(parent, kind, passes)
    if parent.device.type != "cuda":
        raise ValueError(f"link chase: unsupported device {parent.device}")
    dev, n = parent.device, parent.shape[0]
    for name, t in (("parent", parent), ("kind", kind)):
        if t.device != dev or t.dtype != torch.int64 or t.dim() != 1 or t.shape[0] != n \
                or not t.is_contiguous():
            raise ValueError(f"link chase: {name} must be a contiguous int64 [{n}] on {dev}")
    if passes is not None and (passes.device != dev or passes.dtype != torch.int32
                               or passes.numel() != 1):
        raise ValueError(f"link chase: passes must be one int32 on {dev}")
    check_lanes(n)
    anc = torch.empty(n, dtype=torch.int64, device=dev)
    root_ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return anc, root_ok
    fn = _entry()
    check_lanes(n, _capacity[0])
    bar = kernels.device_words("link_chase", dev, 2)  # the barrier words
    scratch = torch.empty(4 * (n + 1), dtype=torch.int32, device=dev)
    ran = torch.empty(1, dtype=torch.int32, device=dev) if passes is None else passes
    with torch.cuda.device(dev):
        err = fn(parent.data_ptr(), kind.data_ptr(), n, doubling_passes(n), scratch.data_ptr(),
                 ran.data_ptr(), anc.data_ptr(), root_ok.data_ptr(), bar.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"link_chase kernel launch failed: CUDA error {err}")
    kernels.count_launch(chase)
    return anc, root_ok


chase.launches = 0
