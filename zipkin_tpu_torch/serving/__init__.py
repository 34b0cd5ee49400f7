"""Scale-out read serving (the port of ``zipkin_tpu/serving``).

The ingest process's mirror publisher serializes each epoch into a
shared-memory segment (`segment.py`, `publisher.py`); stateless reader
processes map it read-only and serve the query API without ever entering
the ingest process (`shape.py`, `reader.py`); a small supervisor spawns
and respawns them (`supervisor.py`, ``python -m zipkin_tpu_torch.serving``).

Everything a reader process imports is numpy and the standard library
(the HTTP front ends run on ``http.server``): no torch, no store, no
aggregator.
"""
