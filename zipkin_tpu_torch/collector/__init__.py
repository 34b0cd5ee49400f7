"""The collector: decode, sample, count, hand to storage (the port's copy
of ``zipkin_tpu/collector``): the core every transport shares, the broker
transports (:mod:`.transports`) and scribe (:mod:`.scribe`)."""

from zipkin_tpu_torch.collector.core import (  # noqa: F401
    Collector,
    CollectorComponent,
    CollectorMetrics,
    CollectorSampler,
    InMemoryCollectorMetrics,
)
