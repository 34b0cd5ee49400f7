"""Device half of the sampling tier: the keep verdict over torch tensors
(port of ``zipkin_tpu/sampling/device.py``).

u32 values are int64 in ``[0, 2**32)`` (:mod:`zipkin_tpu_torch.u32`), so
every compare below is the unsigned one: ``dur`` up to ``0xFFFFFFFF``
against the ``s_tail`` sentinel ``0xFFFFFFFF`` included. Must stay bit
for bit equal to :func:`zipkin_tpu_torch.sampling.reference.host_verdict`.
"""

from __future__ import annotations

import torch

from zipkin_tpu_torch.ops import hashing
from zipkin_tpu_torch.sampling import VERDICT_SALT


def device_verdict(trace_h, svc, rsvc, key, dur, has_dur, err, valid,
                   s_rate, s_tail, s_link, rare_min: int) -> torch.Tensor:
    """[n] bool keep verdicts from the span fields and the published
    tables; the hash term reads ``trace_h`` only (trace-affine)."""
    h16 = hashing.fmix32(trace_h ^ VERDICT_SALT) >> 16
    s = s_rate.shape[0]
    svc_c = torch.clamp(svc, 0, s - 1)
    rsvc_c = torch.clamp(rsvc, 0, s - 1)
    key_c = torch.clamp(key, 0, s_tail.shape[0] - 1)
    tail = has_dur & (dur >= s_tail[key_c])
    rare = (rsvc > 0) & (s_link[svc_c, rsvc_c] < rare_min)
    return valid & (err | tail | rare | (h16 < s_rate[svc_c]))
