"""A cell of the benchmark cut to a size the CPU runs in seconds: the
configuration's and the mix's own files with the sizes below, for the
tests. Every rule stays the configuration's; only the scale changes."""

from __future__ import annotations

import json
import time

from portbench import run

AGG = dict(max_services=64, max_keys=512, hll_precision=8, digest_centroids=64,
           digest_buffer=4096, ring_capacity=8192, link_buckets=4, bucket_minutes=10,
           hist_slices=3, hist_slice_minutes=5, sample_rare_min=4,
           time_buckets=4, time_bucket_minutes=3, time_digest_centroids=8)
MIX = dict(batch_spans=2048, pool_batches=4, services=8, names_per_service=2, warmup_batches=6)


def bench() -> dict:
    return run.load_json(run.ROOT / "BENCHMARK.json")


def shrink(config: dict, mix: dict) -> None:
    """Cut a configuration and a mix to the sizes above, in place."""
    config["agg_config"] = dict(AGG, sampling=False)
    mix.update(MIX)
    if mix["reads"]["clients"]:
        mix["reads"].update(clients=2, per_client_per_s=5.0, checked=12)
        mix["feed_batches_per_s"] = 20.0


# a cell kept out of BENCHMARK.json (PERF.md, Open questions) whose files
# stay for a later benchmark change; its read path is tested all the same
LENS = {"name": "default.lens", "config": "zipkin-default", "traffic": "lens", "chips": 1}


def small_cell(name: str):
    if name == LENS["name"]:
        b, _, config, mix = run.load_cell(run.ROOT, "default.feed")
        cell = LENS
        mix = run.load_json(run.HERE / "traffic" / "lens.json")
    else:
        b, cell, config, mix = run.load_cell(run.ROOT, name)
    shrink(config, mix)
    return b, cell, config, mix


def run_small(name: str, seconds: float = 2.0, seed: int = 2_147_483_659, control=False):
    b, cell, config, mix = small_cell(name)
    return run.run_cell(cell, config, mix, seed, seconds, False, "cpu",
                        run.cell_metrics(b, name, False), control=control,
                        t_process=time.perf_counter())


def line(result: dict) -> dict:
    """The result as the last line carries it."""
    return json.loads(json.dumps(result))
