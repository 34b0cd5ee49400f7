"""The port's tenant admission (``zipkin_tpu_torch.runtime.tenant``) against
the JAX package's (``zipkin_tpu.runtime.tenant``), on the CPU.

The reference's cases (tests/test_tenant.py) run against the port: tenant
ids normalized onto the bounded alphabet; the token buckets, the error
class's lifeline, flood escalation and exit hysteresis, the LRU that never
evicts the default tenant; the sampling tier's retained-spans table; a
flooding tenant contained while the others and the global ladder stay B0;
tenant-scoped resource faults (explicit, ambient and from ``ZT_RESOURCE``);
bounded tenant mirror keys; the per-tenant SLO (which also proves
``obs/slo.py``'s import of ``runtime.tenant`` resolves); the ``{tenant=}``
exposition families; and the fan-out tier attributing each acked payload to
its tenant. Parity: the same seeded admissions, ticks and retained-span
charges through both packages' tables on one injected clock give equal
verdicts, retry delays, levels, counters and status. At the port's HTTP
boundary a tenant over its budget is shed with ``X-Shed-Scope: tenant`` and
``X-Shed-Tenant`` while another tenant is admitted and the ladder stays B0.

Tolerances: none (integer and deterministic float code).
"""

from __future__ import annotations

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_overload import JSON_CT, _raw, bulk_payload
from tests.test_torch_server import serve
from zipkin_tpu import faults as ref_faults
from zipkin_tpu.runtime.tenant import TenantAdmission as RefTenantAdmission
from zipkin_tpu.sampling.controller import TenantBudgetTable as RefBudgetTable
from zipkin_tpu_torch import faults, native
from zipkin_tpu_torch.runtime.overload import B0, B3, CLASS_ERROR, OverloadController
from zipkin_tpu_torch.runtime.tenant import (CURRENT_TENANT, DEFAULT_TENANT, TenantAdmission,
                                             normalize_tenant, tenant_slug)
from zipkin_tpu_torch.sampling.controller import TenantBudgetTable
from zipkin_tpu_torch.storage.memory import InMemoryStorage


class Clock:
    """An injectable monotonic clock: the refill arithmetic is deterministic."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


# -- identity --------------------------------------------------------------------


class TestNormalizeTenant:
    def test_valid_ids_pass_through(self):
        for raw in ("acme", "team-a", "a.b_c-9", "X" * 64):
            assert normalize_tenant(raw) == raw

    def test_missing_and_hostile_collapse_to_default(self):
        for raw in (None, "", "   ", "a" * 65, 'ten"ant', "ten{ant}", "a/b", "a b", "t\nx",
                    "café", "\x00"):
            assert normalize_tenant(raw) == DEFAULT_TENANT

    def test_whitespace_stripped(self):
        assert normalize_tenant("  acme  ") == "acme"

    def test_slug_is_counter_safe(self):
        assert tenant_slug("team-a.eu") == "team_a_eu"
        assert tenant_slug("simple") == "simple"


# -- TenantAdmission ----------------------------------------------------------------


class TestTenantAdmission:
    def test_accounting_only_always_admits(self):
        ta = TenantAdmission(bytes_per_s=0.0, clock=Clock())
        for _ in range(50):
            assert ta.admit("a", 10_000) == (True, 0.0)
        c = ta.counters()
        assert (c["tenantOffered_a"], c["tenantAdmitted_a"], c["tenantShedTotal"]) == (50, 50, 0)

    def test_bucket_shed_with_per_tenant_retry(self):
        ta = TenantAdmission(bytes_per_s=100.0, burst_s=1.0, clock=Clock())
        assert ta.admit("a", 60) == (True, 0.0)
        ok, retry = ta.admit("a", 60)  # 40 tokens left < 60
        assert not ok
        assert retry == pytest.approx(0.6)  # a 20 B deficit at 100 B/s, level 2: 0.2 x 3
        assert ta.level_of("a") == 2
        ok, _ = ta.admit("b", 60)  # b's bucket is its own
        assert ok and ta.level_of("b") == 0

    def test_error_class_lifeline_below_level3(self):
        ta = TenantAdmission(bytes_per_s=100.0, burst_s=1.0, clock=Clock())
        assert ta.admit("a", 100)[0]
        assert not ta.admit("a", 50)[0]
        assert ta.admit("a", 50, cls="error")[0]

    def test_flood_escalates_to_essential_only(self):
        clk = Clock()
        ta = TenantAdmission(bytes_per_s=100.0, burst_s=1.0, flood_ratio=2.0, clock=clk)
        for _ in range(16):  # 16x the budget in one tick: the EMA lands at 8
            ta.admit("flood", 100)
        ta.tick(1.0)
        assert ta.level_of("flood") == 3
        clk.advance(5.0)
        assert not ta.admit("flood", 10)[0]
        assert ta.admit("flood", 10, cls="error")[0]
        ta.admit("quiet", 10)
        assert ta.level_of("quiet") == 0

    def test_exit_hysteresis_steps_down_one_level_per_dwell(self):
        clk = Clock()
        ta = TenantAdmission(bytes_per_s=100.0, burst_s=1.0, flood_ratio=2.0, dwell_ticks=1,
                             clock=clk)
        for _ in range(16):
            ta.admit("f", 100)
        ta.tick(1.0)
        assert ta.level_of("f") == 3
        levels = []
        for _ in range(6):
            clk.advance(2.0)
            ta.tick(1.0)
            levels.append(ta.level_of("f"))
        assert levels[-1] == 0 and 2 in levels

    def test_lru_bounded_and_default_never_evicted(self):
        ta = TenantAdmission(bytes_per_s=0.0, max_tenants=4, clock=Clock())
        ta.admit(DEFAULT_TENANT, 1)
        for i in range(10):
            ta.admit(f"hostile-{i}", 1)
        c = ta.counters()
        assert c["tenantTableSize"] <= 4 and c["tenantEvictions"] >= 7
        assert DEFAULT_TENANT in ta.status()["tenants"]

    def test_retry_for_unknown_tenant_is_floor(self):
        assert TenantAdmission(bytes_per_s=100.0, clock=Clock()).retry_after_s("never-seen") == 0.05

    def test_retained_budget_gates_next_admission(self):
        clk = Clock()
        table = TenantBudgetTable(spans_per_s=10.0, burst_s=1.0, clock=clk)
        ta = TenantAdmission(bytes_per_s=10_000.0, burst_s=1.0, clock=clk, retained_table=table)
        assert ta.admit("a", 100)[0]
        ta.note_retained("a", 50)  # 5x the burst: deep in debt
        assert table.over_budget("a")
        ok, retry = ta.admit("a", 100)
        assert not ok and retry > 0.0
        row = ta.status()["tenants"]["a"]
        assert (row["retainedShed"], row["retainedSpans"]) == (1, 50)
        assert ta.admit("a", 100, cls="error")[0]

    def test_status_shape_for_statusz(self):
        ta = TenantAdmission(bytes_per_s=100.0, clock=Clock())
        ta.admit("a", 10)
        st = ta.status()
        assert st["enabled"] and st["budgetBytesPerS"] == 100.0
        assert set(st["tenants"]["a"]) == {"level", "pressure", "offered", "admitted", "shed",
                                            "retainedSpans", "retainedShed", "tokens"}


def test_a_seeded_admission_stream_matches_the_reference_exactly():
    """2,000 seeded admissions over 12 tenants (past the LRU's 8 rows), both
    classes, with ticks and retained-span charges between them, through both
    packages' tables (each with its retained-spans table) on one clock."""
    rng = np.random.default_rng(17)
    clk = Clock()
    kw = dict(bytes_per_s=500.0, burst_s=1.0, max_tenants=8, flood_ratio=2.0, dwell_ticks=2,
              clock=clk)
    port = TenantAdmission(retained_table=TenantBudgetTable(spans_per_s=40.0, burst_s=1.0,
                                                            max_tenants=8, clock=clk), **kw)
    ref = RefTenantAdmission(retained_table=RefBudgetTable(spans_per_s=40.0, burst_s=1.0,
                                                           max_tenants=8, clock=clk), **kw)
    levels = set()
    for i in range(2000):
        tenant = "default" if rng.random() < 0.2 else f"t{int(rng.zipf(1.6)) % 12}"
        n = int(rng.integers(1, 400))
        cls = "error" if rng.random() < 0.1 else "bulk"
        clk.advance(float(rng.exponential(0.02)))
        assert port.admit(tenant, n, cls) == ref.admit(tenant, n, cls), i
        if rng.random() < 0.3:
            k = int(rng.integers(0, 30))
            port.note_retained(tenant, k)
            ref.note_retained(tenant, k)
        if i % 50 == 49:
            port.tick(1.0)
            ref.tick(1.0)
            assert port.retry_after_s(tenant) == ref.retry_after_s(tenant)
            levels.update(port.level_of(t) for t in port.status()["tenants"])
    assert levels >= {0, 2, 3}
    assert port.counters() == ref.counters()
    assert port.status() == ref.status()
    assert port.retained_table.counters() == ref.retained_table.counters()


# -- the sampling tier's retained-spans table -------------------------------------------


class TestTenantBudgetTable:
    def test_disabled_tallies_without_enforcing(self):
        t = TenantBudgetTable(spans_per_s=0.0, clock=Clock())
        assert t.charge("a", 1_000_000)
        assert not t.over_budget("a")
        assert t.counters()["tenantRetainedTotal"] == 1_000_000

    def test_debt_then_refill(self):
        clk = Clock()
        t = TenantBudgetTable(spans_per_s=10.0, burst_s=1.0, clock=clk)
        assert t.charge("a", 5)
        assert not t.charge("a", 10)
        assert t.over_budget("a")
        clk.advance(1.0)
        assert not t.over_budget("a")

    def test_over_budget_never_creates_rows(self):
        t = TenantBudgetTable(spans_per_s=10.0, clock=Clock())
        assert not t.over_budget("ghost")
        assert t.counters()["tenantBudgetTableSize"] == 0

    def test_lru_bounded_and_default_kept(self):
        t = TenantBudgetTable(spans_per_s=10.0, max_tenants=3, clock=Clock())
        t.charge("default", 1)
        for i in range(10):
            t.charge(f"hostile-{i}", 1)
        c = t.counters()
        assert c["tenantBudgetTableSize"] <= 3 and c["tenantBudgetEvictions"] >= 8
        assert t.retained("default") == 1


# -- containment through the overload controller -------------------------------------


class TestOverloadContainment:
    def _controller(self, clk):
        ctl = OverloadController(clock=clk, hbm_stats=dict)
        ctl.tenant_admission = TenantAdmission(bytes_per_s=100.0, burst_s=1.0, clock=clk)
        return ctl

    def test_flooding_tenant_sheds_alone_global_stays_b0(self):
        ctl = self._controller(Clock())
        payload = b"x" * 60
        v = ctl.admit(payload, tenant="B")
        assert v.admitted and v.scope == "none"
        v = ctl.admit(payload, tenant="B")
        assert not v.admitted and (v.scope, v.tenant) == ("tenant", "B") and v.retry_after_s > 0.0
        for t in ("A", "C"):
            v = ctl.admit(payload, tenant=t)
            assert v.admitted and v.scope == "none"
        assert ctl.evaluate({"critpathQueueSaturation": 0.0}) == B0
        c = ctl.counters()
        assert (c["overloadLevel"], c["overloadShedTenant"], c["tenantShed_B"]) == (B0, 1, 1)
        assert (c["tenantLevel_B"], c["tenantLevel_A"], c["tenantLevel_C"]) == (2, 0, 0)

    def test_global_shed_reports_global_scope(self):
        ctl = OverloadController(clock=Clock(), hbm_stats=dict)
        for _ in range(12):
            if ctl.evaluate({"critpathQueueSaturation": 0.9}) >= B3:
                break
        assert ctl.level == B3
        v = ctl.admit(b"x" * 10, tenant="A")
        assert not v.admitted and v.scope == "global" and v.retry_after_s > 0.0
        v = ctl.admit(b"", tenant="A", value_class=CLASS_ERROR)
        assert v.admitted and v.tenant == "A"

    def test_missing_tenant_lands_on_default(self):
        v = self._controller(Clock()).admit(b"x")
        assert v.tenant == DEFAULT_TENANT and v.admitted

    def test_retry_guidance_is_tenant_scoped(self):
        ctl = self._controller(Clock())
        ctl.admit(b"x" * 100, tenant="B")
        assert not ctl.admit(b"x" * 100, tenant="B").admitted
        assert ctl.retry_after_s("B") > 0.0
        assert ctl.retry_after_s(None) >= 0.0


def test_a_tenant_over_its_budget_is_shed_at_the_boundary_alone():
    """Through the port's server: tenant A's second payload outruns its
    bucket (429, ``X-Shed-Scope: tenant``, ``X-Shed-Tenant: A``, its own
    delay), tenant B and the default tenant are admitted, the ladder stays B0
    and statusz, ``/metrics`` and ``/prometheus`` carry the tenant rows."""
    body = bulk_payload(0, per=8)
    server = serve(InMemoryStorage(), tenant_ingest_bytes_per_s=float(len(body)),
                   tenant_ingest_burst_s=1.0)
    try:
        a = {**JSON_CT, "X-Tenant-Id": "A"}
        assert _raw(server, "POST", "/api/v2/spans", body, a)[0] == 202
        status, headers, _ = _raw(server, "POST", "/api/v2/spans", bulk_payload(1, per=8), a)
        assert status == 429
        assert (headers["X-Shed-Scope"], headers["X-Shed-Tenant"]) == ("tenant", "A")
        assert int(headers["Retry-After"]) >= 1 and int(headers["X-Retry-After-Ms"]) >= 50
        assert _raw(server, "POST", "/api/v2/spans", body, {**JSON_CT, "X-Tenant-Id": "B"})[0] == 202
        assert _raw(server, "POST", "/api/v2/spans", body, JSON_CT)[0] == 202  # the default tenant
        assert server._overload.level == B0
        import json

        st = json.loads(_raw(server, "GET", "/api/v2/tpu/statusz")[2])["overload"]
        assert st["tenants"]["tenants"]["A"]["shed"] == 1
        assert st["tenants"]["tenants"]["B"]["shed"] == 0
        m = json.loads(_raw(server, "GET", "/metrics")[2])
        assert (m["gauge.zipkin_tpu.tenantShed_A"], m["gauge.zipkin_tpu.tenantShed_B"]) == (1, 0)
        assert m["gauge.zipkin_tpu.overloadShedTenant"] == 1
        prom = _raw(server, "GET", "/prometheus")[2].decode()
        assert 'zipkin_tpu_tenant_shed_total{tenant="A"} 1' in prom
    finally:
        server.stop()


# -- tenant-scoped fault injection -------------------------------------------------------


class TestTenantScopedFaults:
    def test_only_the_named_tenant_fires(self):
        faults.arm_resource("feed.latency", nth=1, count=1, latency_ms=1.0, tenant="B")
        for _ in range(5):
            faults.resource_point("feed.latency", tenant="A")
        assert faults.is_resource_armed("feed.latency")
        faults.resource_point("feed.latency", tenant="B")
        assert not faults.is_resource_armed("feed.latency")

    def test_nonmatching_tenants_do_not_consume_nth(self):
        faults.arm_resource("feed.latency", nth=2, count=1, latency_ms=1.0, tenant="B")
        for _ in range(5):
            faults.resource_point("feed.latency", tenant="A")
        faults.resource_point("feed.latency", tenant="B")
        assert faults.is_resource_armed("feed.latency")
        faults.resource_point("feed.latency", tenant="B")
        assert not faults.is_resource_armed("feed.latency")

    def test_contextvar_fallback_attribution(self):
        faults.arm_resource("feed.latency", nth=1, count=1, latency_ms=1.0, tenant="B")
        tok = CURRENT_TENANT.set("B")
        try:
            faults.resource_point("feed.latency")
        finally:
            CURRENT_TENANT.reset(tok)
        assert not faults.is_resource_armed("feed.latency")

    def test_env_grammar_parses_tenant_scope(self, monkeypatch):
        for var in (faults.ENV_VAR, faults.ENV_CORRUPT):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv(faults.ENV_RESOURCE, "feed.latency:2:3:tenant=acme")
        monkeypatch.setenv(faults.ENV_RESOURCE_LATENCY, "1")
        faults._arm_from_env()
        assert faults._resource_armed["feed.latency"] == [2, 3, 0.001, "acme"]


# -- bounded tenant-prefixed mirror demand keys ------------------------------------------


class _Agg:
    write_version = 0


class TestMirrorTenantKeys:
    def _mirror(self, max_keys):
        from zipkin_tpu_torch.tpu.mirror import ReadMirror

        agg = _Agg()
        return ReadMirror(lambda: agg, enabled=True, max_keys=max_keys)

    def test_tenant_keys_overflow_at_cap(self):
        m = self._mirror(max_keys=2)
        assert m.register("ttq:tenant=A:p99", lambda: 1)
        assert m.register("ttq:tenant=B:p99", lambda: 2)
        assert not m.register("ttq:tenant=C:p99", lambda: 3)
        c = m.counters()
        assert (c["mirrorDemandKeys"], c["mirrorDemandOverflow"]) == (2, 1)
        assert m.register("ttq:tenant=A:p99", lambda: 1)

    def test_tenant_keys_expire_by_publish_ttl(self):
        m = self._mirror(max_keys=8)
        assert m.register("ttq:tenant=A:p99", lambda: 1)
        for _ in range(m.DEMAND_TTL_PUBLISHES + 2):
            assert m.publish(force=True)
        assert m.counters()["mirrorDemandKeys"] == 0
        assert m.register("ttq:tenant=A:p99", lambda: 1)
        assert m.counters()["mirrorDemandOverflow"] == 0


# -- the per-tenant SLO ------------------------------------------------------------------


class TestTenantSlo:
    def test_tenant_specs_bind_to_slugged_counters(self):
        from zipkin_tpu.obs.slo import tenant_specs as ref_tenant_specs
        from zipkin_tpu_torch.obs.slo import tenant_specs

        (spec,) = tenant_specs("team-a")
        assert spec.name == "tenant_team_a_shed_ratio"
        assert (spec.bad, spec.total, spec.kind) == ("tenantShed_team_a", "tenantOffered_team_a",
                                                     "ratio")
        assert [s.name for s in tenant_specs("acme")] == [s.name for s in ref_tenant_specs("acme")]

    def test_add_spec_is_idempotent(self):
        from zipkin_tpu_torch.obs.recorder import StageRecorder
        from zipkin_tpu_torch.obs.slo import SloWatchdog, tenant_specs
        from zipkin_tpu_torch.obs.windows import WindowedTelemetry

        dog = SloWatchdog(WindowedTelemetry(StageRecorder(), dict), subscribe=False)
        n = len(dog.specs)
        (spec,) = tenant_specs("acme")
        dog.add_spec(spec)
        dog.add_spec(spec)
        assert len(dog.specs) == n + 1


# -- the {tenant=} exposition families ----------------------------------------------------


class TestPromTenantFamilies:
    def test_families_are_labelled_and_format_valid(self):
        from zipkin_tpu.server.app import _prom_tenants as ref_prom_tenants
        from zipkin_tpu_torch.server.app import _prom_tenants

        clk = Clock()
        ctl = OverloadController(clock=clk, hbm_stats=dict)
        ctl.tenant_admission = TenantAdmission(bytes_per_s=100.0, burst_s=1.0, clock=clk)
        ctl.admit(b"x" * 60, tenant="acme")
        ctl.admit(b"x" * 60, tenant="acme")  # shed
        lines = _prom_tenants(ctl.status())
        text = "\n".join(lines)
        assert 'zipkin_tpu_tenant_level{tenant="acme"} 2' in text
        assert 'zipkin_tpu_tenant_shed_total{tenant="acme"} 1' in text
        assert 'zipkin_tpu_tenant_offered_total{tenant="acme"} 2' in text
        assert "# TYPE zipkin_tpu_tenant_table_size gauge" in text
        assert lines == ref_prom_tenants(ctl.status())
        seen = set()
        for line in lines:
            if line.startswith("# HELP "):
                seen.add(line.split()[2])
            elif not line.startswith("#"):
                assert line.split("{")[0].split(" ")[0] in seen
                float(line.rsplit(" ", 1)[1])

    def test_empty_status_renders_nothing(self):
        from zipkin_tpu_torch.server.app import _prom_tenants

        assert _prom_tenants(None) == []
        assert _prom_tenants({"tenants": None}) == []


# -- tenant attribution through the fan-out tier -----------------------------------------


@pytest.mark.skipif(not native.available(), reason="no C compiler for the native parser")
class TestMpIngestTenantThreading:
    def test_submit_tenant_reaches_ack_accounting_and_sink(self):
        from tests.test_torch_mp_ingest import make_store, payloads
        from zipkin_tpu_torch.tpu import ring as ring_mod
        from zipkin_tpu_torch.tpu.mp_ingest import MultiProcessIngester

        store = make_store()
        ing = MultiProcessIngester(store, workers=2)
        sink_calls, words = [], []
        ing.tenant_sink = lambda tenant, n: sink_calls.append((tenant, n))
        consume = ing._consume_ring_chunk

        def spy(w, hdr, seq, ready):  # the ring slot's tenant word, as published
            words.append(int(hdr[ring_mod._S_TENANT]))
            return consume(w, hdr, seq, ready)

        ing._consume_ring_chunk = spy
        try:
            ps = payloads(n_payloads=2, spans_each=256)
            ing.submit(ps[0], tenant="acme")
            ing.submit(ps[1])  # no tenant header
            ing.drain()
            table = ing.stats()["mpTenantTable"]
        finally:
            ing.close()
        assert table["acme"] == {"payloads": 1, "spans": 256}
        assert table["default"] == {"payloads": 1, "spans": 256}
        assert dict(sink_calls) == {"acme": 256, "default": 256}
        assert sorted(set(words)) == [0, 1]  # acme interned as 1, default 0
        assert not ing._tenant_of
