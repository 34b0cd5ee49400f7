"""Port of zipkin_tpu/parallel."""
