"""Tail-sampling tier (port of ``zipkin_tpu/sampling``).

Sketches see every span; retention (what the WAL and archives keep) sees
only spans a deterministic verdict keeps: every error span, every span at
or above its key's published tail cut, every span on a rare dependency
edge, and the rest with probability ``rate / RATE_ONE`` per service by a
salted trace hash, so a trace is kept or dropped as a unit.

The verdict is a pure u32 function of the span's fields and the PUBLISHED
tables (``s_rate``, ``s_tail``, ``s_link``). :func:`device_verdict` runs it
in the ingest step over the state's table leaves; :func:`host_verdict` and
:class:`HostSampler` run it with numpy over the same tables, bit for bit;
:class:`RateController` computes new tables on the host and publishes them
to both under the aggregator lock.
"""

from __future__ import annotations

# folded into the trace hash before the keep compare: decorrelates the
# verdict from the HLL register hash (both start from fmix32(trace_h))
VERDICT_SALT = 0x53414D50  # "SAMP"

# rate fixed point: keep probability = rate / RATE_ONE against the top 16
# bits of the mixed id, so RATE_ONE keeps everything and 0 keeps only the
# error, tail and rare-edge spans
RATE_ONE = 65536

from zipkin_tpu_torch.sampling.controller import RateController  # noqa: E402
from zipkin_tpu_torch.sampling.device import device_verdict  # noqa: E402
from zipkin_tpu_torch.sampling.reference import HostSampler, host_verdict  # noqa: E402

__all__ = [
    "VERDICT_SALT",
    "RATE_ONE",
    "device_verdict",
    "HostSampler",
    "host_verdict",
    "RateController",
]
