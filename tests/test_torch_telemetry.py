"""repro_torch.telemetry against the reference's repro.telemetry: registry
semantics, span tracing, exporters, attribution, the engine.stats()
schema, and the off-mode guard — the cases of tests/test_telemetry.py
that need neither serving nor the profiler, run on the port — plus the
two packages held against each other in one process: the same calls
leave the same Prometheus exposition, and engine.stats() has the same
schema.

Spans timed on the card (CUDA events) are covered in
tests/test_torch_cuda.py; here every plan runs on the CPU, where the
same spans time the host.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch as R
from repro_torch import engine as TE
from repro_torch import telemetry as T
from repro_torch.faults import inject as PFJ
from repro_torch.telemetry.registry import MAX_SERIES, MetricsRegistry

from repro import compiler as JC
from repro import engine as JE
from repro import telemetry as JT
from repro.core import dwt2 as jdwt2
from repro.core import idwt2 as jidwt2

#: the port's backend names for the reference's
BACKEND_NAMES = {"jnp": "torch", "pallas": "cuda", "xla": "conv"}


@pytest.fixture(autouse=True)
def _port_planes():
    """The port's telemetry and fault planes, isolated per test (the
    reference's are isolated by tests/conftest.py)."""
    prev_mode = T.mode()
    prev_plan = PFJ.activate(None)
    T.set_mode("counters")
    T.reset()
    yield
    PFJ.activate(prev_plan)
    T.CONFIG.apply(prev_mode)
    T.reset()


def _img(shape=(16, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# -- registry ----------------------------------------------------------

def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "help text")
    c.inc()
    c.inc(2, backend="torch")
    assert c.value() == 1                # the unlabeled series is its own
    assert c.value(backend="torch") == 2
    g = reg.gauge("g")
    g.set(1.5, op="fwd")
    assert g.value(op="fwd") == 1.5
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    (row,) = h.series()
    assert row["count"] == 3 and row["sum"] == pytest.approx(5.55)
    assert row["buckets"] == {0.1: 1, 1.0: 2}        # cumulative


def test_registry_kind_mismatch_rejected():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="counter"):
        reg.gauge("x")


def test_declared_labelnames_reject_typos():
    reg = MetricsRegistry()
    c = reg.counter("strict_total", labelnames=("backend", "fuse"))
    c.inc(backend="torch", fuse="none")
    with pytest.raises(ValueError, match="declares labels"):
        c.inc(backend="torch", fues="none")
    with pytest.raises(ValueError, match="declares labels"):
        c.inc(backend="torch")


def test_series_cardinality_cap_drops_not_raises():
    reg = MetricsRegistry()
    c = reg.counter("wide_total")
    for i in range(MAX_SERIES + 10):
        c.inc(user=str(i))
    assert len(c.series()) == MAX_SERIES
    assert reg.dropped_series == 10
    # existing series still record after the cap is hit
    c.inc(user="0")
    assert c.value(user="0") == 2


def test_registry_reset_keeps_definitions():
    reg = MetricsRegistry()
    c = reg.counter("r_total", "kept help", labelnames=("k",))
    c.inc(k="a")
    reg.reset()
    assert c.value(k="a") == 0.0
    assert reg.get("r_total") is c and c.help == "kept help"
    c.inc(k="a")                       # definitions (labelnames) survive
    assert c.value(k="a") == 1


def test_counter_alias_is_read_write_mapping():
    reg = MetricsRegistry()
    alias = T.CounterAlias({"hits": ("alias_total", {"kind": "hit"}),
                            "misses": ("alias_total", {"kind": "miss"})},
                           registry=reg)
    reg.counter("alias_total").inc(3, kind="hit")
    assert alias["hits"] == 3 and alias["misses"] == 0
    assert isinstance(alias["hits"], int)
    assert dict(alias) == {"hits": 3, "misses": 0}
    assert sum(alias.values()) == 3
    alias.update(hits=0, misses=5)     # legacy reset/write idiom
    assert alias["hits"] == 0 and alias["misses"] == 5
    assert "hits" in alias and len(alias) == 2


def test_counter_alias_sums_the_labels_it_leaves_out():
    """The port's extension: a key naming fewer labels than the series
    carry reads their sum (WORKLOAD_COUNTERS["packet"] over backends),
    and an alias compares equal to a plain dict of its values."""
    reg = MetricsRegistry()
    c = reg.counter("demote_total", labelnames=("workload", "backend"))
    alias = T.CounterAlias({"packet": ("demote_total",
                                       {"workload": "packet"}),
                            "dwt3": ("demote_total", {"workload": "dwt3"})},
                           registry=reg)
    c.inc(workload="packet", backend="torch")
    c.inc(2, workload="packet", backend="cuda")
    c.inc(workload="dwt3", backend="conv")
    assert alias == {"packet": 3, "dwt3": 1}
    assert alias != {"packet": 3, "dwt3": 0}


def test_engine_counters_are_registry_views():
    """PYRAMID_COUNTERS / WORKLOAD_COUNTERS read the registry under the
    reference's metric names."""
    x = torch.from_numpy(_img())
    pyr = R.dwt2(x, levels=2, fuse="pyramid", device="cpu")
    R.idwt2(pyr, fuse="pyramid", device="cpu")
    assert TE.PYRAMID_COUNTERS["pyramid_kernel_launches"] == 2 == \
        T.REGISTRY.get("repro_pyramid_kernel_launches_total").value()
    R.wpt2(x, packet="full:2", fuse="pyramid", backend="torch",
           device="cpu")
    assert TE.WORKLOAD_COUNTERS == {"packet": 1, "dwt3": 0}
    assert T.REGISTRY.get("repro_workload_fuse_demotions_total").value(
        workload="packet", backend="torch") == 1


# -- prometheus exposition --------------------------------------------

def test_prometheus_text_round_trip():
    reg = MetricsRegistry()
    reg.counter("rt_total", 'tricky "help"').inc(2, path='a"b', nl="x")
    reg.gauge("rt_gauge").set(1.25)
    h = reg.histogram("rt_seconds", buckets=(0.1, 1.0))
    h.observe(0.05, op="f")
    h.observe(3.0, op="f")
    text = T.prometheus_text(reg)
    assert "# TYPE rt_total counter" in text
    assert "# TYPE rt_seconds histogram" in text
    parsed = T.parse_prometheus_text(text)
    assert parsed["rt_total"] == [({"path": 'a"b', "nl": "x"}, 2.0)]
    assert parsed["rt_gauge"] == [({}, 1.25)]
    buckets = {lb["le"]: v for lb, v in parsed["rt_seconds_bucket"]}
    assert buckets == {"0.1": 1.0, "1": 1.0, "+Inf": 2.0}
    assert parsed["rt_seconds_count"] == [({"op": "f"}, 2.0)]
    assert parsed["rt_seconds_sum"][0][1] == pytest.approx(3.05)
    # the two packages render the same registry contents identically
    jreg = JT.MetricsRegistry()
    jreg.counter("rt_total", 'tricky "help"').inc(2, path='a"b', nl="x")
    jreg.gauge("rt_gauge").set(1.25)
    jh = jreg.histogram("rt_seconds", buckets=(0.1, 1.0))
    jh.observe(0.05, op="f")
    jh.observe(3.0, op="f")
    assert JT.prometheus_text(jreg) == text


def test_global_exposition_contains_engine_counters():
    R.dwt2(torch.zeros(16, 16), levels=1, device="cpu")
    parsed = T.parse_prometheus_text(T.prometheus_text())
    assert "repro_plan_executions_total" in parsed
    assert "repro_plan_cache_lookups_total" in parsed


def _exposition(text, rename=None):
    """{metric: sorted (labels, value) rows}, backend labels renamed."""
    out = {}
    for name, rows in T.parse_prometheus_text(text).items():
        got = []
        for labels, value in rows:
            labels = dict(labels)
            if rename and "backend" in labels:
                labels["backend"] = rename.get(labels["backend"],
                                               labels["backend"])
            got.append((tuple(sorted(labels.items())), value))
        out[name] = sorted(got)
    return out


def test_prometheus_exposition_matches_the_reference():
    """The same dwt2/idwt2 calls on the port's "torch" and the
    reference's "jnp", each from a cold plan cache and compiler cache,
    leave the same metric names, label sets and counter values."""
    for cache_clear in (JE.clear_plan_cache, TE.clear_plan_cache,
                        JC.compile_scheme_programs.cache_clear,
                        R.compiler.compile_scheme_programs.cache_clear):
        cache_clear()
    JT.reset()
    calls = [dict(levels=2, fuse="none"), dict(levels=2, fuse="levels"),
             dict(levels=1, fuse="none"), dict(levels=2, fuse="none",
                                               scheme="sep-lifting")]
    for i, kw in enumerate(calls):
        x = _img((2, 16, 16), seed=i)
        jpyr = jdwt2(x, backend="jnp", **kw)
        kw_inv = {k: v for k, v in kw.items() if k != "levels"}
        jidwt2(jpyr, backend="jnp", **kw_inv)
        tpyr = R.dwt2(torch.from_numpy(x), backend="torch", device="cpu",
                      **kw)
        R.idwt2(tpyr, backend="torch", device="cpu", **kw_inv)
    want = _exposition(JT.prometheus_text(), rename=BACKEND_NAMES)
    got = _exposition(T.prometheus_text())
    assert set(got) == set(want)
    assert got == want
    assert got["repro_plan_executions_total"]


# -- spans -------------------------------------------------------------

def test_spans_noop_outside_spans_mode():
    with T.span("quiet.op") as sp:
        pass
    assert sp is T.NOOP_SPAN and sp.duration is None
    with T.device_span("quiet.device", "cpu") as sp:
        pass
    assert sp is T.NOOP_SPAN
    assert T.TRACER.records() == []


def test_span_nesting_and_parenting():
    T.set_mode("spans")
    with T.span("outer", a=1):
        with T.span("inner"):
            assert T.current_span().name == "inner"
        with T.span("inner2"):
            pass
    recs = T.TRACER.records()
    by_name = {r.name: r for r in recs}
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["inner2"].parent_id == by_name["outer"].span_id
    assert by_name["outer"].parent_id is None
    assert by_name["outer"].labels == {"a": 1}
    # exit order: inner completes (and records) before outer
    assert recs.index(by_name["inner"]) < recs.index(by_name["outer"])
    assert by_name["outer"].dur_s >= by_name["inner"].dur_s


def test_span_ring_is_bounded_and_counts_drops():
    tracer = T.SpanTracer(capacity=4)
    for i in range(10):
        rec = T.SpanRecord(name=f"s{i}", start_s=float(i), dur_s=0.1,
                           span_id=i + 1, parent_id=None, labels={},
                           thread="t")
        tracer.add(rec)
    st = tracer.stats()
    assert st["resident"] == 4 and st["recorded"] == 10
    assert st["dropped"] == 6
    assert [r.name for r in tracer.records()] == ["s6", "s7", "s8", "s9"]


def test_span_summary_aggregates_by_name():
    T.set_mode("spans")
    for _ in range(3):
        with T.span("agg.op"):
            pass
    with T.span("agg.other"):
        pass
    rows = T.span_summary()
    by_name = {r["name"]: r for r in rows}
    assert by_name["agg.op"]["count"] == 3
    assert by_name["agg.op"]["total_s"] >= by_name["agg.op"]["max_s"]
    assert by_name["agg.op"]["mean_s"] == pytest.approx(
        by_name["agg.op"]["total_s"] / 3)


def test_chrome_trace_of_pyramid_dwt2_is_valid_and_nested(tmp_path):
    """The trace of a fused-pyramid dwt2 loads as Chrome-trace JSON with
    the pyramid launch nested under the execution span."""
    T.set_mode("spans")
    x = torch.from_numpy(_img((64, 64)))
    R.dwt2(x, levels=2, fuse="pyramid", backend="cuda", device="cpu")
    path = T.write_chrome_trace(tmp_path / "trace.json")
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert xs, "no complete events recorded"
    for e in xs:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid"}
        assert e["dur"] >= 0
    names = {e["name"] for e in xs}
    assert {"plan.build", "execute.forward", "pyramid.launch"} <= names
    by_id = {e["args"]["span_id"]: e for e in xs}
    launch = next(e for e in xs if e["name"] == "pyramid.launch")
    assert by_id[launch["args"]["parent_id"]]["name"] == "execute.forward"
    # thread metadata lanes exist for every tid used
    meta_tids = {e["tid"] for e in events if e["ph"] == "M"}
    assert {e["tid"] for e in xs} <= meta_tids


@pytest.mark.parametrize("fuse,children", [("levels", "level"),
                                           ("none", "level"),
                                           ("pyramid", "pyramid.launch")])
def test_execute_spans_nest_the_device_work(fuse, children):
    """execute.forward / .inverse hold one level.* span per level, or
    the one pyramid.launch; on the CPU they time the host."""
    T.set_mode("spans")
    x = torch.from_numpy(_img((2, 32, 32)))
    pyr = R.dwt2(x, levels=3, fuse=fuse, backend="cuda", device="cpu")
    R.idwt2(pyr, fuse=fuse, backend="cuda", device="cpu")
    recs = T.TRACER.records()
    for op in ("forward", "inverse"):
        (ex,) = [r for r in recs if r.name == f"execute.{op}"]
        kids = [r.name for r in recs if r.parent_id == ex.span_id]
        want = (["pyramid.launch"] if children == "pyramid.launch"
                else [f"level.{op}"] * 3)
        assert kids == want
        assert ex.clock == "host" and ex.dur_s > 0


def test_packet_and_volume_spans():
    T.set_mode("spans")
    R.wpt2(torch.from_numpy(_img((16, 16))), packet="full:2",
           backend="torch", device="cpu")
    R.dwt3(torch.from_numpy(_img((4, 16, 16))), levels=2, backend="torch",
           device="cpu")
    names = [r.name for r in T.TRACER.records()]
    assert names.count("packet.forward") == 5      # internal nodes
    assert names.count("level3.forward") == 2


def test_spans_are_noops_while_torch_compile_traces(monkeypatch):
    T.set_mode("spans")
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert T.span("traced") is T.NOOP_SPAN
    assert T.device_span("traced", "cpu") is T.NOOP_SPAN


def test_profiler_mirror_annotates_torch_profiler():
    """While a torch.profiler session records, every span is a range of
    its name in its trace, in counters mode too, nested as the calls
    nest; with none recording a span is the shared no-op."""
    from torch.profiler import ProfilerActivity, profile
    assert T.mode() == "counters"
    assert T.span("call.dwt3") is T.NOOP_SPAN
    assert T.device_span("temporal.forward", "cpu") is T.NOOP_SPAN
    x = torch.from_numpy(_img((8, 16, 16)))
    R.dwt3(x, levels=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert T.span("call.dwt3") is not T.NOOP_SPAN
        R.dwt3(x, levels=2, device="cpu")
    assert T.span("call.dwt3") is T.NOOP_SPAN
    assert T.TRACER.records() == []
    ranges = {}
    for e in prof.events():
        if "::" not in e.name:
            ranges.setdefault(e.name, []).append(
                (e.thread, e.time_range.start, e.time_range.end))

    def nests(inner, outer):
        return ranges.get(inner) and all(
            any(t == u and a <= b0 and b1 <= b
                for u, a, b in ranges[outer])
            for t, b0, b1 in ranges[inner])

    assert nests("plan.lookup", "call.dwt3")
    assert nests("execute.forward", "call.dwt3")
    assert nests("level3.forward", "execute.forward")
    assert nests("temporal.forward", "level3.forward")
    # K1 reads the contiguous half-bands as images: no copy, no span
    assert "planes.split" not in ranges and "planes.merge" not in ranges
    assert len(ranges["level3.forward"]) == 2


def test_plane_copy_bytes_count_what_the_copies_write():
    """repro_plane_copy_bytes_total: K1 reads a contiguous image and
    writes the inverse's image itself, so a round trip copies nothing
    (repro_plane_folds_total counts a split and a merge a level);
    planes handed over as non-contiguous views are still copied, and
    counted, before the launch."""
    from repro_torch.kernels import polyphase as PP
    x = torch.from_numpy(_img((2, 32, 32)))
    pyr = R.dwt2(x, levels=2, backend="cuda", device="cpu")
    assert PP.PLANE_COPY_BYTES.value(op="split") == 0
    assert PP.PLANE_COPY_BYTES.value(op="merge") == 0
    assert PP.PLANE_FOLDS.value(op="split") == 2
    assert PP.PLANE_FOLDS.value(op="merge") == 0
    R.idwt2(pyr, backend="cuda", device="cpu")
    assert PP.PLANE_COPY_BYTES.value(op="split") == 0
    assert PP.PLANE_COPY_BYTES.value(op="merge") == 0
    assert PP.PLANE_FOLDS.value(op="split") == 2
    assert PP.PLANE_FOLDS.value(op="merge") == 2
    spec = TE.get_plan(shape=(2, 16, 16), levels=1, backend="cuda",
                       device="cpu").level_specs[0]
    planes = tuple(torch.zeros(2, 8, 8) for _ in range(4))
    PP.apply_steps_cuda(spec.fwd_steps, planes, windows=spec.fwd_windows)
    assert PP.PLANE_COPY_BYTES.value(op="split") == 0
    views = tuple(torch.zeros(2, 8, 8).mT for _ in range(4))
    PP.apply_steps_cuda(spec.fwd_steps, views, windows=spec.fwd_windows)
    assert PP.PLANE_COPY_BYTES.value(op="split") == 4 * 2 * 8 * 8 * 4
    assert PP.PLANE_COPY_BYTES.value(op="merge") == 0
    assert PP.PLANE_FOLDS.value(op="split") == 2


def test_kernel_launches_are_a_view_of_the_registry_series():
    """Kernel.launches reads repro_kernel_launches_total{kernel} and an
    assignment sets it; it counts in every mode, and T.reset() zeroes
    it."""
    from repro_torch.kernels import tap_window as TW
    k = TW.KERNEL
    k.launches = 0
    k.launched((132, 3))
    assert k.launches == 1 and k.last_grid == (132, 3)
    assert TW.LAUNCHES.value(kernel="tap_window") == 1
    TW.LAUNCHES.inc(2, kernel="tap_window")
    assert k.launches == 3
    k.launches = 0
    assert TW.LAUNCHES.value(kernel="tap_window") == 0
    T.set_mode("off")
    k.launched((1, 1))
    assert k.launches == 1
    T.reset()
    assert k.launches == 0


# -- mode gating -------------------------------------------------------

def test_off_mode_is_a_noop_everywhere():
    T.set_mode("off")
    T.reset()
    from repro_torch.engine import plan as P
    k = dict(op="forward", backend="cuda", fuse="none",
             scheme="ns-polyconv")
    before = P.EXECUTIONS.value(**k)
    R.dwt2(torch.zeros(16, 16), levels=1, device="cpu")
    assert P.EXECUTIONS.value(**k) == before
    assert T.TRACER.records() == []
    assert T.roofline() == []
    # reads and exports still work under off
    assert isinstance(T.prometheus_text(), str)
    assert TE.stats()["telemetry"]["mode"] == "off"


def test_counters_mode_skips_spans_but_counts():
    from repro_torch.engine import plan as P
    k = dict(op="forward", backend="cuda", fuse="none",
             scheme="ns-polyconv")
    before = P.EXECUTIONS.value(**k)
    R.dwt2(torch.zeros(16, 16), levels=1, device="cpu")
    assert P.EXECUTIONS.value(**k) == before + 1
    assert T.TRACER.records() == []


def test_off_mode_still_counts_what_the_engine_did():
    """Fallbacks, fused-pyramid executions and fuse demotions count in
    every mode: a hop under off must not go unseen."""
    from repro_torch.engine import plan as P
    from repro_torch.faults import degrade as DG
    from repro_torch.faults import plan as PFP
    T.set_mode("off")
    T.reset()
    x = torch.zeros(32, 32)
    R.dwt2(x, levels=2, fuse="pyramid", backend="cuda", device="cpu")
    assert P.COUNTERS["pyramid_kernel_launches"] == 1
    R.wpt2(x, packet="full:1", fuse="pyramid", backend="cuda",
           device="cpu")
    assert P.WORKLOAD_COUNTERS["packet"] == 1
    PFJ.activate(PFP.FaultPlan.from_text("pyramid.launch=always"))
    try:
        R.dwt2(x, levels=2, fuse="pyramid", backend="cuda", device="cpu")
    finally:
        PFJ.activate(None)
    assert DG.FALLBACKS.value(**{"from": "cuda/pyramid",
                                 "to": "cuda/levels",
                                 "site": "pyramid.launch"}) == 1
    assert TE.stats()["faults"]["fallbacks"] == 1


class _CardRecord:
    """A span record timed on the card: counts the reads of its
    duration (each would wait for the card)."""

    clock = "cuda"

    def __init__(self, seconds):
        self.seconds, self.reads = seconds, 0

    @property
    def dur_s(self):
        self.reads += 1
        return self.seconds


def test_record_span_waits_for_the_card_only_when_read():
    """An execution timed on the card is not resolved when it returns:
    the newest record per series is published when the roofline or an
    export is read."""
    plan = TE.get_plan(shape=(32, 32), levels=2, fuse="levels",
                       backend="cuda", device="cpu")
    old, new = _CardRecord(0.5), _CardRecord(0.25)
    T.record_span(plan, old, op="forward")
    T.record_span(plan, new, op="forward")
    assert (old.reads, new.reads) == (0, 0)
    assert T.REGISTRY.get("repro_measured_seconds").series() == []
    (row,) = T.roofline()
    assert (old.reads, new.reads) == (0, 1)
    assert row["seconds"] == 0.25
    T.record_span(plan, _CardRecord(0.125), op="forward")
    assert "0.125" in T.prometheus_text()
    T.set_mode("off")
    T.record_span(plan, _CardRecord(1.0), op="forward")
    assert T.roofline()[0]["seconds"] == 0.125


def test_mode_env_reload(monkeypatch):
    monkeypatch.setenv(T.MODE_ENV, "spans")
    T.reload()
    assert T.mode() == "spans" and T.CONFIG.spans_on
    monkeypatch.setenv(T.MODE_ENV, "bogus")
    with pytest.raises(ValueError, match="bogus"):
        T.reload()
    monkeypatch.delenv(T.MODE_ENV)
    T.reload()
    assert T.mode() == T.DEFAULT_MODE and not T.CONFIG.spans_on


def test_env_names_carry_the_port_prefix():
    """One process may hold both packages: their switches must differ."""
    from repro_torch.faults import degrade, plan
    from repro_torch.telemetry import spans
    names = [T.MODE_ENV, spans.RING_ENV,
             plan.FAULTS_ENV, plan.SEED_ENV, degrade.ENABLE_ENV,
             degrade.RETRIES_ENV, degrade.VERIFY_ENV]
    assert all(n.startswith("REPRO_TORCH_") for n in names)
    assert T.MODE_ENV != JT.MODE_ENV


# -- attribution -------------------------------------------------------

def test_attribution_publishes_roofline_gauges():
    plan = TE.get_plan(shape=(16, 16), levels=1, backend="cuda",
                       fuse="levels", device="cpu", cache=TE.PlanCache())
    row = T.record_execution(plan, 0.5, op="forward")
    assert row is not None
    assert row["gbps"] == pytest.approx(row["hbm_bytes"] / 0.5 / 1e9)
    assert row["macs_per_s"] == pytest.approx(row["macs"] / 0.5)
    rows = [r for r in T.roofline()
            if r["op"] == "forward" and r["backend"] == "cuda"
            and r["seconds"] == 0.5]
    assert rows and rows[0]["gbps"] == pytest.approx(row["gbps"])
    # inputs are cached on the plan: second call reuses them
    assert plan._attr_inputs["forward"]["hbm_bytes"] == row["hbm_bytes"]
    assert T.record_execution(plan, 0.25, op="forward")["gbps"] == \
        pytest.approx(2 * row["gbps"])


def test_attribution_handles_tap_opt_off_and_bad_measurements():
    plan = TE.get_plan(shape=(16, 16), levels=1, backend="torch",
                       fuse="none", tap_opt="off", device="cpu",
                       cache=TE.PlanCache())
    row = T.record_execution(plan, 0.1, op="forward")
    assert row is not None and row["macs"] is None   # no compiled MACs
    assert T.record_execution(plan, 0.0) is None     # unusable timing
    assert T.record_execution(plan, -1.0) is None


def test_attribution_macs_match_the_reference():
    """On the 2-D pyramid the compiled MACs are the reference's."""
    kw = dict(shape=(2, 32, 32), levels=2, fuse="levels")
    plan = TE.get_plan(backend="torch", device="cpu", cache=TE.PlanCache(),
                       **kw)
    ref = JE.get_plan(backend="jnp", cache=JE.PlanCache(), **kw)
    assert T.plan_macs(plan) == JT.plan_macs(ref)


def test_attribution_bytes_are_the_chip_scripts_model():
    """A cuda plan's bytes are the window kernel's model summed over the
    levels (the pyramid kernels' for a pyramid plan); other backends
    count the unique bytes."""
    from repro_torch.kernels import polyphase as PP
    cache = TE.PlanCache()
    kw = dict(shape=(2, 64, 64), levels=3, device="cpu", cache=cache)
    lv = TE.get_plan(backend="cuda", fuse="levels", **kw)
    for op, attr in (("forward", "fwd_programs"), ("inverse",
                                                   "inv_programs")):
        want = sum(PP.scheme_hbm_bytes(getattr(s, attr), s.image_shape, 4,
                                       s.block) for s in lv.level_specs)
        assert T.plan_cost_inputs(lv, op)["hbm_bytes"] == 2 * want
    py = TE.get_plan(backend="cuda", fuse="pyramid", **kw)
    pw = py.pyramid.fwd_kernel
    assert PP.plan_hbm_bytes(py, "forward") == 2 * PP.pyramid_hbm_bytes(
        (64, 64), 4, pw.level_blocks, [p.halo for p in pw.programs]
    ).modelled
    tp = TE.get_plan(backend="torch", fuse="levels", **kw)
    assert PP.plan_hbm_bytes(tp, "inverse") == 2 * 2 * 64 * 64 * 4
    # a 3-D level: K1 on both temporal half-bands (T >> (l + 1) frames
    # each) plus the temporal pass over the level's volume
    p3 = TE.get_plan(backend="cuda", shape=(1, 8, 32, 32), ndim=3,
                     levels=2, fuse="levels", device="cpu", cache=cache)
    assert p3.level_images == (4, 2) and p3.level_runs == (2, 2)
    want = sum(2 * n * PP.scheme_hbm_bytes(s.fwd_programs, s.image_shape,
                                           4, s.block)
               + 2 * (2 * n) * s.image_shape[0] * s.image_shape[1] * 4
               for s, n in zip(p3.level_specs, (4, 2)))
    assert PP.plan_hbm_bytes(p3, "forward") == want


def test_spans_mode_feeds_the_live_roofline():
    T.set_mode("spans")
    x = torch.from_numpy(_img((2, 32, 32)))
    pyr = R.dwt2(x, levels=2, fuse="levels", backend="cuda", device="cpu")
    R.idwt2(pyr, fuse="levels", backend="cuda", device="cpu")
    rows = {r["op"]: r for r in T.roofline()}
    assert set(rows) == {"forward", "inverse"}
    assert all(r["gbps"] > 0 and r["seconds"] > 0 for r in rows.values())


# -- engine.stats() schema contract -----------------------------------

def test_engine_stats_schema_exact_top_level_keys():
    s = TE.stats()
    assert sorted(s) == ["auto", "backends", "block_table", "faults",
                         "plan_cache", "plans", "pyramid", "serve",
                         "telemetry"]
    assert sorted(s["pyramid"]) == ["pyramid_kernel_launches",
                                    "vmem_fallbacks"]
    assert sorted(s["auto"]) == ["choices", "cold_fallbacks",
                                 "predictions", "store_hits"]
    assert {"submitted", "served", "failed", "rejected", "batches",
            "p50_ms", "p99_ms", "img_per_s", "mean_occupancy",
            "latency_samples", "latency_dropped", "deadline_exceeded",
            "quarantined", "breaker_rejections"} <= set(s["serve"])
    assert {"active", "enabled", "injections", "fallbacks",
            "retries"} <= set(s["faults"])
    assert sorted(s["telemetry"]) == ["dropped_series", "metrics",
                                      "mode", "series", "spans"]
    assert {"hits", "misses", "size", "maxsize"} <= set(s["plan_cache"])


def test_engine_stats_sections_degrade_to_zero_schema(monkeypatch):
    """At reset, the live auto, serve and block_table sections equal the
    zeroed schemas the reference reports when a subsystem fails to load
    (the block table with its path); a section whose read fails raises
    instead of reading zero (a zeroed fault section would hide a
    fallback)."""
    from repro.engine import cache as JEC
    from repro_torch.engine import autotune as AT
    from repro_torch.serve import metrics as SM
    SM.reset()
    s = TE.stats()
    assert s["serve"] == JEC._SERVE_ZERO
    assert s["auto"] == JEC._AUTO_ZERO
    assert s["block_table"] == {"device_fallbacks": 0,
                                "path": str(AT.table_path())}
    assert sorted(s) == ["auto", "backends", "block_table", "faults",
                         "plan_cache", "plans", "pyramid", "serve",
                         "telemetry"]

    def boom():
        raise RuntimeError("faults plane unavailable")
    monkeypatch.setattr("repro_torch.faults.stats", boom)
    with pytest.raises(RuntimeError, match="faults plane unavailable"):
        TE.stats()


def test_engine_stats_schema_matches_the_reference():
    """Top-level keys and every dict section's keys are the reference's;
    plan rows too, with pallas_calls -> launches and
    pyramid_vmem_bytes -> pyramid_smem_bytes."""
    TE.clear_plan_cache()
    JE.clear_plan_cache()
    renames = {"pallas_calls": "launches",
               "pyramid_vmem_bytes": "pyramid_smem_bytes"}
    for jb, fuse in (("jnp", "none"), ("pallas", "pyramid"),
                     ("pallas", "levels")):
        JE.get_plan(shape=(2, 32, 32), levels=2, backend=jb, fuse=fuse)
        TE.get_plan(shape=(2, 32, 32), levels=2, backend=BACKEND_NAMES[jb],
                    fuse=fuse, device="cpu")
    got, want = TE.stats(), JE.stats()
    assert sorted(got) == sorted(want)
    for section, value in want.items():
        if isinstance(value, dict):
            assert sorted(got[section]) == sorted(value), section
    assert len(got["plans"]) == len(want["plans"]) == 3
    for g, w in zip(got["plans"], want["plans"]):
        assert sorted(g) == sorted(renames.get(k, k) for k in w)
        assert g["backend"] == BACKEND_NAMES[w["backend"]]
        assert (g["num_steps"], g["launches"]) == \
            (w["num_steps"], w["pallas_calls"])


def test_legacy_counter_aliases_still_readable():
    from repro_torch.engine import plan as P
    assert set(P.COUNTERS) == {"pyramid_kernel_launches", "smem_fallbacks"}
    assert set(P.WORKLOAD_COUNTERS) == {"packet", "dwt3"}
    for alias in (P.COUNTERS, P.WORKLOAD_COUNTERS):
        for k, v in alias.items():
            assert isinstance(v, int) and v >= 0
