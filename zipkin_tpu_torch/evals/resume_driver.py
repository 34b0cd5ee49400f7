"""Relaunch loop for the crash-resumable config4 run (port of
``evals/resume_driver.py``).

Runs ``python -m zipkin_tpu_torch.evals.run_configs config4`` with
``EVAL_RESUME_DIR`` set, so each window ingests under a
:class:`~zipkin_tpu_torch.runtime.supervisor.ResumeSupervisor`: a degraded
window (the wire rate collapsing against its rolling baseline) or the
window deadline drains, snapshots, records ``eval_cursor.json`` and exits
``EX_RESTART`` (75). This loop relaunches on 75: the next window restores
the snapshot, replays the WAL tail and resumes batch indexing from the
cursor, so distinct trace ids and span counts accumulate across windows
toward EVAL_REPLAY_SPANS. The default window deadline makes at least one
real mid-run restore happen on a card that never degrades. The last line
is ``{"artifact": "config4_resume_driver", ...}``.

Run: python -m zipkin_tpu_torch.evals.resume_driver [--device cpu]
``--device`` is passed on to each window. Without it the windows run on
the card, and the loop refuses to start when there is none.
Env: EVAL_RESUME_DIR (default ./eval_resume_state),
     EVAL_WINDOW_DEADLINE_S (default 600; set it above the whole run's
     wall to make restores degraded-only),
     EVAL_MAX_WINDOWS (default 64), EVAL_REQUIRE_RESTORE (default 1),
     plus everything config4 honors (EVAL_REPLAY_SPANS, EVAL_SMALL, ...).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from zipkin_tpu_torch.runtime.supervisor import EX_RESTART


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="the device each window runs on (default the card; 'cpu' runs the "
                             "plain path)")
    args = parser.parse_args(argv)
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("resume_driver: no CUDA device is available; pass --device cpu to run on the "
                  "CPU", file=sys.stderr)
            return 2
    resume_dir = os.path.abspath(os.environ.get("EVAL_RESUME_DIR") or "eval_resume_state")
    os.makedirs(resume_dir, exist_ok=True)
    env = dict(os.environ, EVAL_RESUME_DIR=resume_dir)
    env.setdefault("EVAL_WINDOW_DEADLINE_S", "600")
    max_windows = int(os.environ.get("EVAL_MAX_WINDOWS", 64))
    require_restore = os.environ.get("EVAL_REQUIRE_RESTORE", "1") != "0"
    cmd = [sys.executable, "-m", "zipkin_tpu_torch.evals.run_configs", "config4"]
    if args.device is not None:
        cmd[3:3] = ["--device", args.device]

    windows = 0
    restores = 0
    rc = EX_RESTART
    t0 = time.monotonic()
    while windows < max_windows:
        rc = subprocess.call(cmd, env=env)
        windows += 1
        if rc == 0:
            break
        if rc != EX_RESTART:
            print(json.dumps({"artifact": "config4_resume_driver", "completed": False,
                              "windows": windows, "failed_rc": rc}), flush=True)
            return rc
        restores += 1  # the next launch performs a real restore

    cursor = {}
    cursor_path = os.path.join(resume_dir, "eval_cursor.json")
    if os.path.exists(cursor_path):
        with open(cursor_path) as f:
            cursor = json.load(f)
    completed = rc == 0
    ok = completed and (restores >= 1 or not require_restore)
    print(json.dumps({
        "artifact": "config4_resume_driver",
        "completed": completed,
        "windows": windows,
        "restores": restores,
        "cumulative_spans": cursor.get("spans"),
        "distinct_trace_ids": cursor.get("distinct_traces"),
        "wall_s": round(time.monotonic() - t0, 1),
        "passed": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
