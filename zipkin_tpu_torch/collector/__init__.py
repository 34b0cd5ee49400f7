"""The collector: decode, sample, count, hand to storage (the port's copy
of ``zipkin_tpu/collector``, HTTP's path only)."""

from zipkin_tpu_torch.collector.core import (  # noqa: F401
    Collector,
    CollectorMetrics,
    CollectorSampler,
    InMemoryCollectorMetrics,
)
