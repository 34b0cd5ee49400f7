"""Host-side runtime services of the port (port of ``zipkin_tpu/runtime``)."""
