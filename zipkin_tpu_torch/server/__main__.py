"""``python -m zipkin_tpu_torch.server [--port P] [--storage mem|tpu]
[--resume-dir D]``: boot the server from the environment (the port's copy
of ``zipkin_tpu/server/__main__.py``). The flags beat ``QUERY_PORT``,
``STORAGE_TYPE`` and ``TPU_RESUME_DIR``; the store is the card's unless
``mem`` is named, and with no card the server refuses to start. With a
resume dir, boot restores ``D/snap``, replays ``D/wal`` and logs new batches
back under it. SIGTERM and SIGINT shut it down cleanly (a final snapshot,
exit code 0).
"""

import argparse
import dataclasses
import logging
import os
import signal
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m zipkin_tpu_torch.server")
    parser.add_argument("--port", type=int, default=None,
                        help="HTTP port (default: $QUERY_PORT or 9411; 0 picks a free one)")
    parser.add_argument("--storage", choices=("mem", "tpu"), default=None,
                        help="storage backend: mem, or tpu for the device store on the card "
                             "(default: $STORAGE_TYPE or tpu)")
    parser.add_argument("--resume-dir", default=None,
                        help="durable state root: boot restores <dir>/snap, replays <dir>/wal and "
                             "resumes; new batches persist back under it (default: $TPU_RESUME_DIR)")
    args = parser.parse_args(argv)
    if args.resume_dir is not None:
        # before the config is read: the dirs derive from it
        os.environ["TPU_RESUME_DIR"] = args.resume_dir

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
