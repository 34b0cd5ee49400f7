"""``python -m zipkin_tpu_torch.server [--port P] [--storage mem|tpu]``:
boot the server from the environment (the port's copy of
``zipkin_tpu/server/__main__.py``). The flags beat ``QUERY_PORT`` and
``STORAGE_TYPE``; the store is the card's unless ``mem`` is named, and
with no card the server refuses to start. SIGTERM and SIGINT shut it
down cleanly (exit code 0).
"""

import argparse
import dataclasses
import logging
import signal
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m zipkin_tpu_torch.server")
    parser.add_argument("--port", type=int, default=None,
                        help="HTTP port (default: $QUERY_PORT or 9411; 0 picks a free one)")
    parser.add_argument("--storage", choices=("mem", "tpu"), default=None,
                        help="storage backend: mem, or tpu for the device store on the card "
                             "(default: $STORAGE_TYPE or tpu)")
    args = parser.parse_args(argv)

    from zipkin_tpu_torch.server.app import run_server
    from zipkin_tpu_torch.server.config import ServerConfig

    config = ServerConfig.from_env()
    if args.port is not None:
        config = dataclasses.replace(config, port=args.port)
    if args.storage is not None:
        config = dataclasses.replace(config, storage_type=args.storage)
    logging.basicConfig(level=logging.INFO)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    run_server(config, stop)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
