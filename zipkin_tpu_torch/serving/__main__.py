"""``python -m zipkin_tpu_torch.serving``: the multi-process reader front end
(the port of ``zipkin_tpu/serving/__main__.py``, on ``http.server``).

Attaches the ingest process's mirror segment by name and runs the reader
supervisor in the foreground, plus a small aggregate HTTP surface
(``/metrics``, ``/prometheus``, ``/statusz``) on ``TPU_READER_PORT_BASE - 1``
that fans out to the reader-labeled per-reader families. SIGTERM stops the
readers, closes the segment and exits 0.

Environment (validated by `server/config.py` when launched with the
ingest server; re-read here for the standalone front end):

- ``TPU_MIRROR_SEGMENT``      shm name the ingest server exposes in its
                              ``/api/v2/tpu/statusz`` serving block
                              (required)
- ``TPU_READERS``             reader process count (default 2)
- ``TPU_READER_PORT_BASE``    first reader port (default 9512)
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading

from zipkin_tpu_torch.serving.reader import _json, _text, handler_for, serve_until_signalled
from zipkin_tpu_torch.serving.reader import _Listener
from zipkin_tpu_torch.serving.segment import MirrorSegment
from zipkin_tpu_torch.serving.supervisor import ReaderSupervisor

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    seg_name = os.environ.get("TPU_MIRROR_SEGMENT", "").strip()
    if not seg_name:
        print("TPU_MIRROR_SEGMENT is required: the shm segment name the ingest server "
              'exposes in /api/v2/tpu/statusz under "serving.name"', file=sys.stderr)
        return 2
    readers = max(1, min(64, _env_int("TPU_READERS", 2)))
    port_base = _env_int("TPU_READER_PORT_BASE", 9512)
    segment = MirrorSegment(name=seg_name)
    sup = ReaderSupervisor(segment, readers, port_base)
    sup.start()
    stop = threading.Event()
    poller = threading.Thread(target=sup.run, kwargs={"poll_s": 0.5, "stop": stop.is_set},
                              name="reader-supervisor", daemon=True)
    poller.start()
    routes = {
        "/metrics": lambda q: _json(sup.scrape_metrics()),
        "/prometheus": lambda q: _text(200, sup.scrape_prometheus()),
        "/statusz": lambda q: _json(json.loads(json.dumps(sup.status()))),
    }
    logger.info("serving front end: %d readers on %d.., aggregate on %d",
                readers, port_base, port_base - 1)
    try:
        serve_until_signalled(_Listener(("127.0.0.1", port_base - 1), handler_for(routes)))
    finally:
        stop.set()
        poller.join(timeout=5)
        sup.stop()
        segment.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
