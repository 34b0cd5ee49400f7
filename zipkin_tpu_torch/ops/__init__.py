"""Port of zipkin_tpu/ops."""
