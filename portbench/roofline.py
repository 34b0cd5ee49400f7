"""The bytes each hand kernel of the port must move for the data the
benchmark handed it, the card's published peak, and the card's power
limit, which stands beside every share.

The byte counts follow ``chip_smoke.py`` (phase a2's HLL step,
``ring_bound_bytes`` and phase p1's chase): each input byte read once
and each output byte written once, and where the work depends on the
data, what these inputs need.
"""

from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the 700 W limit

# the step's HLL lane columns as the kernel reads them: int32 hash bits,
# int32 service, bool valid, and with the time tier bool tb_keep and the
# u8 slot
HLL_LANE_BYTES = 4 + 4 + 1
HLL_TT_LANE_BYTES = 1 + 1

# the ring's columns a step appends to, and ``rolled``, which the append
# only writes
RING_COLUMNS = ("trace_h", "tl0", "tl1", "s0", "s1", "p0", "p1", "shared", "kind",
                "svc", "rsvc", "err", "ts_min", "valid")


def hll_step_bytes(lanes: int, words: int, written: int, timetier: bool) -> int:
    """One step's register update: each lane's columns read once, one
    4-byte word read for each distinct register word a live target names
    and one written for each word that rises."""
    per_lane = HLL_LANE_BYTES + (HLL_TT_LANE_BYTES if timetier else 0)
    return lanes * per_lane + 4 * (words + written)


def ring_lane_bytes(state):
    """(source, destination) bytes of one appended lane: the batch's
    columns, of the ring's dtypes, and the ring cells written."""
    src = sum(getattr(state, f"r_{c}").element_size() for c in RING_COLUMNS)
    return src, src + state.r_rolled.element_size()


def ring_append_bytes(n: int, live: int, src: int, dst: int) -> int:
    """The valid flags of every lane, a live lane's columns read and its
    ring cells written once, and the cursor."""
    return n + live * src + live * dst + 8


def link_chase_bytes(n: int) -> int:
    """Parent and kind (int64) read once, the ancestor (int64) and the
    root flag (bool) written once, and the pass count."""
    return n * (8 + 8 + 8 + 1) + 4


def share(nbytes: float, seconds: float) -> float:
    """Percent of the peak bandwidth that moving ``nbytes`` in
    ``seconds`` of kernel time reaches."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
