"""The storage SPI and the in-memory store (the port's copies of
``zipkin_tpu/storage``); the device-backed store is
:class:`zipkin_tpu_torch.tpu.store.TorchStorage`."""

from zipkin_tpu_torch.storage.spi import (  # noqa: F401
    AutocompleteTags,
    QueryRequest,
    ServiceAndSpanNames,
    SpanConsumer,
    SpanStore,
    StorageComponent,
    Traces,
)
