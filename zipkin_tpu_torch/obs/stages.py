"""Fixed stage taxonomy for the pipeline flight recorder.

Every ``obs.record(stage, dur_s)`` call site must name one of the
stages below with a string literal (``tests/test_torch_obs_recorder.py``
scans the package for it). The taxonomy is deliberately closed: a fixed, ordered tuple
lets the recorder preallocate flat per-thread arrays indexed by stage,
and dashboards can rely on the label set being stable across builds.

To add a stage: append the name here, give it a budget in
``DEFAULT_BUDGETS_US``, and instrument the host-side call site —
never inside a device program. The catalogue equals the reference's,
so ``/prometheus`` label sets match across packages.

Budgets are the slow-span thresholds in µs: an observation exceeding
its stage budget lands in the recorder's slow-event ring and, when the
self-span emitter is installed (``TPU_OBS_SELFSPANS=1``), is published
as an internal span for service ``zipkin-tpu-pipeline``. Defaults are
intentionally generous — they flag genuine stalls, not first-use
kernel builds in tests; scale them with ``TPU_OBS_BUDGET_SCALE``.
"""

STAGES = (
    "http_boundary",     # request body read → collector hand-off (server side)
    "grpc_boundary",     # gRPC Report: request bytes → collector hand-off
    "parse",             # wire bytes → columnar/object spans (C parser or codec)
    "pack",              # parsed spans → packed device wire image
    "route",             # shard routing of a fused batch
    "device_dispatch",   # host wall of the ingest step (its host work + async launches)
    "rollup",            # fused rollup dispatch wall (pre-eviction linking)
    "ctx_advance",       # incremental link-context advance at query time
    "wal_append",        # WAL record write incl. buffer flush
    "wal_fsync",         # the fsync portion of a WAL append
    "snapshot",          # device-state snapshot save + WAL truncate
    "sampler_tick",      # RateController control-loop tick
    "archive_write",     # disk archive / fast-sample append
    "query_fresh",       # read-path cache miss: full device read program
    "query_cached",      # read-path cache hit under the version check
    "readpack_transfer",  # the single packed device→host pull per query
    "mp_record",         # MP dispatcher: shm copy + remap + device feed
    "mp_shm_copy",       # mp_record substage: shm slot → host array copy
    "mp_vocab_replay",   # mp_record substage: worker vocab journal replay
    "mp_lut_remap",      # mp_record substage: worker-local → global LUT remap
    "mp_device_feed",    # mp_record substage: fused batch → device ingest feed
    "coalesce",          # multi-chunk concat+remap gather into one bucketed image
    "accuracy_rollup",   # shadow drain + device reads + error estimators
    "wire_to_durable",   # stitched critical path: wire receipt → WAL-durable ack
    "query_lock_wait",   # outermost wait on the aggregator lock (per acquire)
    "query_wall",        # stitched query critical path: request begin → result
    "query_mirror",      # lock-free serve from the epoch-published read mirror
    "mirror_publish",    # one mirror publish: lock once, packed reads, swap
    "reader_serve",      # reader-process serve from the shm mirror segment
)

NUM_STAGES = len(STAGES)
STAGE_INDEX = {name: i for i, name in enumerate(STAGES)}

# Slow-span budgets, µs, scaled by TPU_OBS_BUDGET_SCALE at install time.
DEFAULT_BUDGETS_US = {
    "http_boundary": 500_000,
    "grpc_boundary": 500_000,
    "parse": 250_000,
    "pack": 250_000,
    "route": 250_000,
    "device_dispatch": 250_000,
    "rollup": 1_000_000,
    "ctx_advance": 500_000,
    "wal_append": 100_000,
    "wal_fsync": 100_000,
    "snapshot": 5_000_000,
    "sampler_tick": 100_000,
    "archive_write": 250_000,
    "query_fresh": 150_000,
    "query_cached": 50_000,
    "readpack_transfer": 100_000,
    "mp_record": 500_000,
    "mp_shm_copy": 250_000,
    "mp_vocab_replay": 250_000,
    "mp_lut_remap": 250_000,
    "mp_device_feed": 500_000,
    "coalesce": 250_000,
    "accuracy_rollup": 1_000_000,
    "wire_to_durable": 5_000_000,
    "query_lock_wait": 50_000,
    "query_wall": 150_000,
    "query_mirror": 10_000,
    "mirror_publish": 1_000_000,
    "reader_serve": 10_000,
}

assert set(DEFAULT_BUDGETS_US) == set(STAGES)
