"""The BASELINE.json eval configs on the port (``python -m
zipkin_tpu_torch.evals.run_configs``), the counterpart of the reference's
``evals/`` harness."""
