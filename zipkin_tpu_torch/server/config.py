"""Server configuration from the environment (the port's copy of the part
of ``zipkin_tpu/server/config.py:58-458`` that its routes read).

The environment names and defaults are the reference's, but for one:
``STORAGE_TYPE`` defaults to ``tpu``, which builds a
:class:`~zipkin_tpu_torch.tpu.store.TorchStorage` on the card and raises
without one, as every entry point of the port does; ``mem`` is the
in-memory store, taken only when asked for by name. The others are
``QUERY_PORT``,
``COLLECTOR_SAMPLE_RATE``, the wire collectors' ``COLLECTOR_HTTP_ENABLED``,
``COLLECTOR_GRPC_ENABLED``, ``COLLECTOR_GRPC_PORT``,
``COLLECTOR_SCRIBE_ENABLED`` and ``COLLECTOR_SCRIBE_PORT``
(``zipkin_tpu/server/config.py:69-73,325-329``), ``QUERY_LOOKBACK``, ``QUERY_LIMIT``,
``MEM_MAX_SPANS``, ``STORAGE_THROTTLE_*``, ``TPU_FAST_INGEST``,
``TPU_FAST_ARCHIVE_SAMPLE``, ``TPU_SAMPLING*``, ``TPU_MAX_DEVICE_BATCH``,
``TPU_DEPS_MAX_STALE_MS``, the ``TPU_<AggConfig field>`` sizes and the
durable boot's ``TPU_RESUME_DIR``, ``TPU_CHECKPOINT_DIR``, ``TPU_WAL_DIR``,
``TPU_WAL_FSYNC``, ``TPU_SNAPSHOT_INTERVAL_S`` and ``TPU_SNAPSHOT_KEEP``, the
disk archive's ``TPU_ARCHIVE_DIR``, ``TPU_ARCHIVE_MAX_BYTES`` and
``TPU_ARCHIVE_SEGMENT_BYTES``, the scrubber's ``TPU_SCRUB_INTERVAL_S``
and ``TPU_SCRUB_BYTES_PER_S``, and the multi-process ingest tier's
``TPU_MP_WORKERS`` (0: off), ``TPU_MP_QUEUE_DEPTH``, ``TPU_MP_RING_SLOTS``
and ``TPU_MP_COALESCE_MAX``, and the observability plane's
``SELF_TRACING_ENABLED``, ``SELF_TRACING_SAMPLE_RATE``, ``TPU_OBS_SELFSPANS``,
``TPU_OBS_BUDGET_SCALE``, ``TPU_OBS_WINDOWS``, ``TPU_OBS_TICK_S``,
``TPU_SLO``, ``TPU_SLO_SHORT_S``, ``TPU_SLO_LONG_S``, ``TPU_SLO_BURN``,
``TPU_OBS_SHADOW*``, ``TPU_OBS_QUERY``, ``TPU_OBS_INCIDENT_*`` and the
critical-path tracer's ``TPU_OBS_CRITPATH``, ``TPU_OBS_CRITPATH_SLOTS`` and
``TPU_OBS_CRITPATH_RECLAIM_S``, and the read mirror's ``TPU_READ_MIRROR``
and ``TPU_MIRROR_MAX_STALE_MS`` with scale-out serving's
``TPU_MIRROR_SEGMENT_BYTES`` (0: no segment), ``TPU_READERS`` and
``TPU_READER_PORT_BASE``, whose bounds refuse a boot, and admission's
``TPU_OVERLOAD``, ``TPU_OVERLOAD_ENTER_B1``/``_B2``/``_B3``,
``TPU_OVERLOAD_EXIT_MARGIN``, ``TPU_OVERLOAD_DWELL_TICKS``,
``TPU_OVERLOAD_MAX_STALE_MS``, ``TPU_OVERLOAD_RETRY_BASE_S``, ``TPU_TENANT``,
``TPU_TENANT_MAX``, ``TPU_TENANT_INGEST_BYTES_PER_S``,
``TPU_TENANT_INGEST_BURST_S``, ``TPU_TENANT_RETAINED_SPANS_PER_S``,
``TPU_TENANT_FLOOD_RATIO``, ``TPU_TENANT_DWELL_TICKS``, ``TPU_TENANT_SLO``
and ``TPU_DEADLINES``
(``zipkin_tpu/server/config.py:78-145,151,166-204,205-234,236-264,280-313,332-357,362-389,390-428``).
``TPU_OBS``, ``TPU_OBS_DEVICE`` and ``TPU_OBS_QUERY`` are also read where
the recorder, the device observatory and the query plane are made.

The disk archive's directory, as the reference resolves it: ``TPU_ARCHIVE_DIR``
when set (``off``, ``none`` or ``0``: no archive), else ``<TPU_RESUME_DIR>/archive``,
else ``./zipkin-tpu-archive`` (made absolute) when ``TPU_FAST_INGEST`` is on,
else none: an object-path server keeps every span in its bounded host store.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

DAY_MS = 86_400_000


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw else default


def _bounded(name: str, value: int, lo: int, hi: int, *, allow_zero: bool = False) -> int:
    """Refuse to boot on a structural setting out of bounds: a reader fleet
    or a segment sized from a typo fails at config time, not at run time."""
    if allow_zero and value == 0:
        return value
    if not (lo <= value <= hi):
        raise ValueError(f"{name}={value} out of bounds [{lo}, {hi}]"
                         + (" (0 = disabled)" if allow_zero else ""))
    return value


def _env_list(name: str) -> Tuple[str, ...]:
    raw = os.environ.get(name, "")
    return tuple(x.strip() for x in raw.split(",") if x.strip())


# AggConfig fields sizable from the environment (TPU_MAX_SERVICES=256 etc.;
# TPU_TIME_BUCKETS=0 turns the time tier off)
_AGG_ENV_FIELDS = (
    "max_services", "max_keys", "hll_precision", "digest_centroids",
    "digest_buffer", "ring_capacity", "link_buckets", "bucket_minutes",
    "hist_slices", "hist_slice_minutes",
    "time_buckets", "time_bucket_minutes", "time_digest_centroids",
)


def _env_agg() -> dict:
    out = {}
    for field in _AGG_ENV_FIELDS:
        raw = os.environ.get("TPU_" + field.upper())
        if raw:
            out[field] = int(raw)
    return out


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 9411  # 0 binds an ephemeral port
    storage_type: str = "tpu"  # tpu (the card) | mem
    strict_trace_id: bool = True
    search_enabled: bool = True
    autocomplete_keys: Sequence[str] = ()
    mem_max_spans: int = 500_000
    default_lookback: int = 7 * DAY_MS  # QUERY_LOOKBACK, ms
    query_limit: int = 10
    sample_rate: float = 1.0
    http_collector_enabled: bool = True
    grpc_collector_enabled: bool = False
    grpc_port: int = 9412  # 0 binds an ephemeral port
    scribe_enabled: bool = False
    scribe_port: int = 9410  # 0 binds an ephemeral port
    throttle_enabled: bool = False
    throttle_max_concurrency: int = 8
    # self-tracing: one SERVER span per request, stored through the
    # collector (B3 headers join the caller's trace)
    self_tracing_enabled: bool = False
    self_tracing_sample_rate: float = 1.0
    # slow-stage self-spans: over-budget recorder stages become spans of
    # service zipkin-tpu-pipeline; TPU_OBS_BUDGET_SCALE scales every
    # stage budget (0.0: every observation is slow)
    obs_selfspans_enabled: bool = False
    obs_budget_scale: float = 1.0
    # the windowed plane: a ticker takes per-tick deltas of the recorder
    # and the store's counters (the time tier's seal rides it, at most once
    # the server's seal_interval_s)
    obs_windows_enabled: bool = True
    obs_windows_tick_s: float = 1.0
    # the SLO burn-rate watchdog over the windowed plane
    obs_slo_enabled: bool = True
    obs_slo_short_s: float = 60.0
    obs_slo_long_s: float = 300.0
    obs_slo_burn_threshold: float = 2.0
    # the accuracy plane: a bounded host shadow of the ingest stream and
    # its estimator, rolled up on the ticker at most every rollup_s
    obs_shadow_enabled: bool = True
    obs_shadow_reservoir_k: int = 512
    obs_shadow_distinct_k: int = 4096
    obs_shadow_link_rate: float = 0.125
    obs_shadow_rollup_s: float = 5.0
    obs_shadow_pending_max: int = 512
    # per-query traces and the aggregator lock's ledger; an SLO trip writes
    # an incident bundle into obs_incident_dir ("" = off), newest N kept
    obs_query_enabled: bool = True
    obs_incident_dir: str = ""
    obs_incident_retention: int = 16
    # the ingest critical-path tracer (obs/critpath.py), active only with
    # the multi-process tier: ledger slots (payloads past them go untraced,
    # counted critpathSkipped) and the age past which an open slot a dead
    # worker left is reclaimed
    obs_critpath_enabled: bool = True
    obs_critpath_slots: int = 256
    obs_critpath_reclaim_s: float = 60.0
    # the epoch-published read mirror (tpu/mirror.py): the ticker publishes
    # an epoch each tick and the four aggregate reads serve from it without
    # the aggregator lock, at most this stale (a request's staleness_ms
    # sets its own bound; <= 0 forces a fresh read); off: every read takes
    # the lock
    tpu_read_mirror: bool = True
    tpu_mirror_max_stale_ms: int = 5000
    # scale-out serving (serving/): with segment bytes > 0 each epoch is
    # also serialized into a shared-memory segment with a stripe for each
    # of tpu_readers reader processes (python -m zipkin_tpu_torch.serving),
    # reader rN listening on port base + N, the aggregate surface on base - 1
    tpu_readers: int = 4
    tpu_mirror_segment_bytes: int = 0
    tpu_reader_port_base: int = 9512
    # the overload plane (runtime/overload.py): the brownout ladder folds the
    # windowed signals (queue saturation, occupancy, wire-to-ack / WAL fsync /
    # query p99s, lock waiters, snapshot age, card memory), each over its
    # design limit, into an EMA load index each tick. B1 sheds self-spans and
    # serves reads cache first within max_stale_ms, B2 sheds bulk payloads
    # with a falling admit probability, B3 admits the error class only and
    # serves reads cache only. Up is immediate; down is one level a dwell,
    # below the level's enter threshold less the exit margin. A shed is a 429
    # whose Retry-After grows with the load from retry_base_s
    overload_enabled: bool = True
    overload_enter_b1: float = 0.70
    overload_enter_b2: float = 0.85
    overload_enter_b3: float = 0.95
    overload_exit_margin: float = 0.10
    overload_dwell_ticks: int = 5
    overload_max_stale_ms: int = 5000
    overload_retry_base_s: float = 0.25
    # tenant admission (runtime/tenant.py): each payload is attributed to
    # its X-Tenant-Id (absent or hostile ids: "default"). With a byte budget
    # > 0 each tenant has a token bucket (burst = rate x burst_s) and a level
    # of its own, so a flooding tenant sheds with tenant-scoped guidance
    # while the others and the global ladder stay B0; 0 counts without
    # enforcing. A retained-spans budget > 0 adds the sampling tier's table.
    # The table is an LRU of tenant_max rows; tenant_slo_tenants get their
    # own shed-ratio SLO
    tenant_enabled: bool = True
    tenant_max: int = 64
    tenant_ingest_bytes_per_s: float = 0.0
    tenant_ingest_burst_s: float = 2.0
    tenant_retained_spans_per_s: float = 0.0
    tenant_flood_ratio: float = 2.0
    tenant_dwell_ticks: int = 3
    tenant_slo_tenants: Tuple[str, ...] = ()
    # X-Request-Timeout-Ms: work already past its deadline answers 504
    # before its dispatch (counted deadlineExpired)
    deadline_propagation_enabled: bool = True
    # the shard mesh: the first N visible cards, a shard each (None: every
    # visible card); more than the machine has refuses to boot
    tpu_devices: Optional[int] = None
    # line-rate path: JSON v2 and proto3 bytes through the native parser,
    # with a trace-affine 1/N archive sample (0: none)
    tpu_fast_ingest: bool = False
    tpu_fast_archive_sample: int = 64
    # the multi-process ingest tier (tpu/mp_ingest.py), the line-rate
    # path's scale-out: parse workers (0: off), the payloads each worker's
    # queue holds before the boundary answers 429, ring slots a worker
    # (0: the tier's default) and the chunks one device step may coalesce
    tpu_mp_workers: int = 0
    tpu_mp_queue_depth: int = 2
    tpu_mp_ring_slots: int = 0
    tpu_mp_coalesce_max: int = 8
    # largest device batch before the state's own bounds, and how stale a
    # cached dependency answer may be served under ingest (0: always fresh)
    tpu_max_device_batch: int = 65536
    tpu_deps_max_stale_ms: float = 5000.0
    # tail sampling: device verdicts gate what the archive keeps while the
    # sketches see every span; a budget > 0 runs the rate controller
    tpu_sampling: bool = False
    tpu_sampling_budget: float = 0.0
    tpu_sampling_interval_s: float = 5.0
    tpu_sampling_min_rate: int = 256
    tpu_sampling_tail_quantile: float = 0.99
    tpu_sampling_rare_min: int = 4
    # durable boot: TPU_RESUME_DIR=<dir> puts the snapshots under
    # <dir>/snap, the WAL under <dir>/wal and the disk archive under
    # <dir>/archive, so boot restores, replays and resumes;
    # TPU_CHECKPOINT_DIR, TPU_WAL_DIR and TPU_ARCHIVE_DIR override their piece
    tpu_checkpoint_dir: Optional[str] = None
    tpu_wal_dir: Optional[str] = None
    # fsync each WAL append: durable past a host or power failure, at a
    # per-batch cost (off: past a process crash)
    tpu_wal_fsync: bool = False
    # periodic snapshots bound the WAL and the replay after a crash; only
    # with a checkpoint dir, 0 = off
    tpu_snapshot_interval_s: float = 300.0
    # intact snapshot generations a commit retains (the fallback depth)
    tpu_snapshot_keep: int = 2
    # the disk archive: every ingested span's raw bytes behind a trace-id
    # index, the oldest segments dropped whole past the byte budget
    tpu_archive_dir: Optional[str] = None
    tpu_archive_max_bytes: int = 2 << 30
    tpu_archive_segment_bytes: int = 64 << 20
    # the at-rest scrubber's gap between passes (0 = off) and read pacing
    tpu_scrub_interval_s: float = 300.0
    tpu_scrub_bytes_per_sec: int = 8 << 20
    # device state shape (AggConfig fields); absent = AggConfig's default
    tpu_agg: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_env() -> "ServerConfig":
        fast_ingest = _env_bool("TPU_FAST_INGEST", False)
        raw_resume = os.environ.get("TPU_RESUME_DIR") or None
        resume_dir = os.path.abspath(raw_resume) if raw_resume else None
        raw_archive = os.environ.get("TPU_ARCHIVE_DIR")
        if raw_archive and raw_archive.lower() in ("off", "none", "0"):
            archive_dir = None
        elif raw_archive:
            archive_dir = raw_archive
        elif resume_dir:
            # everything durable lives under the resume dir, so a restarted
            # server serves complete traces of the ids acked before
            archive_dir = os.path.join(resume_dir, "archive")
        elif fast_ingest:
            # absolute, so a restart from another cwd finds the same archive
            archive_dir = os.path.abspath("zipkin-tpu-archive")
        else:
            archive_dir = None
        return ServerConfig(
            host=os.environ.get("QUERY_HOST", "0.0.0.0"),
            port=_env_int("QUERY_PORT", 9411),
            storage_type=os.environ.get("STORAGE_TYPE", "tpu"),
            strict_trace_id=_env_bool("STRICT_TRACE_ID", True),
            search_enabled=_env_bool("SEARCH_ENABLED", True),
            autocomplete_keys=_env_list("AUTOCOMPLETE_KEYS"),
            mem_max_spans=_env_int("MEM_MAX_SPANS", 500_000),
            default_lookback=_env_int("QUERY_LOOKBACK", 7 * DAY_MS),
            query_limit=_env_int("QUERY_LIMIT", 10),
            sample_rate=_env_float("COLLECTOR_SAMPLE_RATE", 1.0),
            http_collector_enabled=_env_bool("COLLECTOR_HTTP_ENABLED", True),
            grpc_collector_enabled=_env_bool("COLLECTOR_GRPC_ENABLED", False),
            grpc_port=_env_int("COLLECTOR_GRPC_PORT", 9412),
            scribe_enabled=_env_bool("COLLECTOR_SCRIBE_ENABLED", False),
            scribe_port=_env_int("COLLECTOR_SCRIBE_PORT", 9410),
            throttle_enabled=_env_bool("STORAGE_THROTTLE_ENABLED", False),
            throttle_max_concurrency=_env_int("STORAGE_THROTTLE_MAX_CONCURRENCY", 8),
            self_tracing_enabled=_env_bool("SELF_TRACING_ENABLED", False),
            self_tracing_sample_rate=_env_float("SELF_TRACING_SAMPLE_RATE", 1.0),
            obs_selfspans_enabled=_env_bool("TPU_OBS_SELFSPANS", False),
            obs_budget_scale=_env_float("TPU_OBS_BUDGET_SCALE", 1.0),
            obs_windows_enabled=_env_bool("TPU_OBS_WINDOWS", True),
            obs_windows_tick_s=_env_float("TPU_OBS_TICK_S", 1.0),
            obs_slo_enabled=_env_bool("TPU_SLO", True),
            obs_slo_short_s=_env_float("TPU_SLO_SHORT_S", 60.0),
            obs_slo_long_s=_env_float("TPU_SLO_LONG_S", 300.0),
            obs_slo_burn_threshold=_env_float("TPU_SLO_BURN", 2.0),
            obs_shadow_enabled=_env_bool("TPU_OBS_SHADOW", True),
            obs_shadow_reservoir_k=_env_int("TPU_OBS_SHADOW_RESERVOIR", 512),
            obs_shadow_distinct_k=_env_int("TPU_OBS_SHADOW_DISTINCT", 4096),
            obs_shadow_link_rate=_env_float("TPU_OBS_SHADOW_LINK_RATE", 0.125),
            obs_shadow_rollup_s=_env_float("TPU_OBS_SHADOW_ROLLUP_S", 5.0),
            obs_shadow_pending_max=_env_int("TPU_OBS_SHADOW_PENDING", 512),
            obs_query_enabled=_env_bool("TPU_OBS_QUERY", True),
            obs_incident_dir=os.environ.get("TPU_OBS_INCIDENT_DIR", ""),
            obs_incident_retention=_env_int("TPU_OBS_INCIDENT_RETENTION", 16),
            obs_critpath_enabled=_env_bool("TPU_OBS_CRITPATH", True),
            obs_critpath_slots=_env_int("TPU_OBS_CRITPATH_SLOTS", 256),
            obs_critpath_reclaim_s=_env_float("TPU_OBS_CRITPATH_RECLAIM_S", 60.0),
            tpu_read_mirror=_env_bool("TPU_READ_MIRROR", True),
            tpu_mirror_max_stale_ms=_env_int("TPU_MIRROR_MAX_STALE_MS", 5000),
            tpu_readers=_bounded("TPU_READERS", _env_int("TPU_READERS", 4), 1, 64),
            tpu_mirror_segment_bytes=_bounded(
                "TPU_MIRROR_SEGMENT_BYTES", _env_int("TPU_MIRROR_SEGMENT_BYTES", 0),
                64 << 10, 1 << 30, allow_zero=True),
            tpu_reader_port_base=_bounded(
                # base - 1 hosts the aggregate surface: keep it unprivileged
                "TPU_READER_PORT_BASE", _env_int("TPU_READER_PORT_BASE", 9512), 1025, 65000),
            overload_enabled=_env_bool("TPU_OVERLOAD", True),
            overload_enter_b1=_env_float("TPU_OVERLOAD_ENTER_B1", 0.70),
            overload_enter_b2=_env_float("TPU_OVERLOAD_ENTER_B2", 0.85),
            overload_enter_b3=_env_float("TPU_OVERLOAD_ENTER_B3", 0.95),
            overload_exit_margin=_env_float("TPU_OVERLOAD_EXIT_MARGIN", 0.10),
            overload_dwell_ticks=_env_int("TPU_OVERLOAD_DWELL_TICKS", 5),
            overload_max_stale_ms=_env_int("TPU_OVERLOAD_MAX_STALE_MS", 5000),
            overload_retry_base_s=_env_float("TPU_OVERLOAD_RETRY_BASE_S", 0.25),
            tenant_enabled=_env_bool("TPU_TENANT", True),
            tenant_max=_env_int("TPU_TENANT_MAX", 64),
            tenant_ingest_bytes_per_s=_env_float("TPU_TENANT_INGEST_BYTES_PER_S", 0.0),
            tenant_ingest_burst_s=_env_float("TPU_TENANT_INGEST_BURST_S", 2.0),
            tenant_retained_spans_per_s=_env_float("TPU_TENANT_RETAINED_SPANS_PER_S", 0.0),
            tenant_flood_ratio=_env_float("TPU_TENANT_FLOOD_RATIO", 2.0),
            tenant_dwell_ticks=_env_int("TPU_TENANT_DWELL_TICKS", 3),
            tenant_slo_tenants=_env_list("TPU_TENANT_SLO"),
            deadline_propagation_enabled=_env_bool("TPU_DEADLINES", True),
            tpu_devices=_env_int("TPU_DEVICES", 0) or None,
            tpu_fast_ingest=fast_ingest,
            tpu_fast_archive_sample=_env_int("TPU_FAST_ARCHIVE_SAMPLE", 64),
            tpu_mp_workers=_env_int("TPU_MP_WORKERS", 0),
            tpu_mp_queue_depth=_env_int("TPU_MP_QUEUE_DEPTH", 2),
            tpu_mp_ring_slots=_env_int("TPU_MP_RING_SLOTS", 0),
            tpu_mp_coalesce_max=_env_int("TPU_MP_COALESCE_MAX", 8),
            tpu_max_device_batch=_env_int("TPU_MAX_DEVICE_BATCH", 65536),
            tpu_deps_max_stale_ms=_env_float("TPU_DEPS_MAX_STALE_MS", 5000.0),
            tpu_sampling=_env_bool("TPU_SAMPLING", False),
            tpu_sampling_budget=_env_float("TPU_SAMPLING_BUDGET", 0.0),
            tpu_sampling_interval_s=_env_float("TPU_SAMPLING_INTERVAL_S", 5.0),
            tpu_sampling_min_rate=_env_int("TPU_SAMPLING_MIN_RATE", 256),
            tpu_sampling_tail_quantile=_env_float("TPU_SAMPLING_TAIL_QUANTILE", 0.99),
            tpu_sampling_rare_min=_env_int("TPU_SAMPLING_RARE_MIN", 4),
            tpu_checkpoint_dir=os.environ.get("TPU_CHECKPOINT_DIR")
            or (os.path.join(resume_dir, "snap") if resume_dir else None),
            tpu_wal_dir=os.environ.get("TPU_WAL_DIR")
            or (os.path.join(resume_dir, "wal") if resume_dir else None),
            tpu_wal_fsync=_env_bool("TPU_WAL_FSYNC", False),
            tpu_snapshot_interval_s=_env_float("TPU_SNAPSHOT_INTERVAL_S", 300.0),
            tpu_snapshot_keep=_env_int("TPU_SNAPSHOT_KEEP", 2),
            tpu_archive_dir=archive_dir,
            tpu_archive_max_bytes=_env_int("TPU_ARCHIVE_MAX_BYTES", 2 << 30),
            tpu_archive_segment_bytes=_env_int("TPU_ARCHIVE_SEGMENT_BYTES", 64 << 20),
            tpu_scrub_interval_s=_env_float("TPU_SCRUB_INTERVAL_S", 300.0),
            tpu_scrub_bytes_per_sec=_env_int("TPU_SCRUB_BYTES_PER_S", 8 << 20),
            tpu_agg=_env_agg(),
        )
