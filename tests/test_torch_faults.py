"""repro_torch.faults against the reference's repro.faults: grammar,
determinism, injection hooks, retry/deadline, circuit breaker and the
degradation chain — the cases of tests/test_faults.py, run on the port —
plus the two planes held against each other in one process: the same
fault text and seed fire on the same draws, and the degradation chain is
the reference's under the backend name map.
"""
import itertools
import json

import pytest
import torch

from repro_torch import telemetry as T
from repro_torch.engine.plan import FUSE_MODES, PlanKey
from repro_torch.faults import inject as FJ
from repro_torch.faults import plan as FP
from repro_torch.faults.degrade import degradation_chain
from repro_torch.faults.policy import (CircuitBreaker, Deadline,
                                       DeadlineExceeded, retry_call)

from repro.engine.plan import PlanKey as JPlanKey
from repro.faults import plan as JFP
from repro.faults.degrade import degradation_chain as jdegradation_chain

pytestmark = pytest.mark.chaos

#: the port's backend names for the reference's
BACKEND_NAMES = {"jnp": "torch", "pallas": "cuda", "xla": "conv"}


@pytest.fixture(autouse=True)
def _port_planes():
    """The port's telemetry and fault planes, isolated per test (the
    reference's are isolated by tests/conftest.py)."""
    prev_mode = T.mode()
    prev_plan = FJ.activate(None)
    T.set_mode("counters")
    T.reset()
    yield
    FJ.activate(prev_plan)
    T.set_mode(prev_mode)
    T.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- grammar ----------------------------------------------------------

def test_parse_grammar_variants():
    specs = FP.parse_faults(
        "pyramid.launch=0.05,stream.h2d_dispatch=once,"
        "serve.batch=slow:0.5:0.02,execute.forward=corrupt:always,"
        "stream.drain=hang:1.0")
    assert specs["pyramid.launch"].kind == "raise"       # default kind
    assert specs["pyramid.launch"].prob == 0.05
    assert specs["stream.h2d_dispatch"].once
    s = specs["serve.batch"]
    assert (s.kind, s.prob, s.sleep_s) == ("slow", 0.5, 0.02)
    c = specs["execute.forward"]
    assert c.kind == "corrupt" and c.prob is None and not c.once
    h = specs["stream.drain"]
    assert h.kind == "hang" and h.prob == 1.0
    assert specs["pyramid.launch"].sleep_s == FP.DEFAULT_SLOW_S


def test_parse_rejects_unknown_site_and_bad_specs():
    with pytest.raises(ValueError, match="unknown fault site"):
        FP.parse_faults("pyramid.lanch=0.05")            # typo is an error
    with pytest.raises(ValueError, match="probability.*in \\(0, 1\\]"):
        FP.parse_faults("serve.batch=1.5")
    with pytest.raises(ValueError, match="must be a probability"):
        FP.parse_faults("serve.batch=sometimes")
    with pytest.raises(ValueError, match="malformed fault entry"):
        FP.parse_faults("serve.batch")
    with pytest.raises(ValueError, match="trailing fields"):
        FP.parse_faults("serve.batch=slow:0.5:0.02:7")
    with pytest.raises(ValueError, match="no trigger"):
        FP.parse_faults("serve.batch=")


def test_scenario_file_roundtrip(tmp_path):
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(
        {"seed": 7, "faults": {"serve.batch": "slow:0.5",
                               "pyramid.launch": "once"}}))
    plan = FP.FaultPlan.from_text(f"@{path}")
    assert plan.seed == 7
    assert plan.specs["serve.batch"].kind == "slow"
    assert plan.specs["pyramid.launch"].once
    (tmp_path / "bad.json").write_text(json.dumps({"faults": "nope"}))
    with pytest.raises(ValueError, match="'faults' mapping"):
        FP.load_scenario(str(tmp_path / "bad.json"))


def test_sites_kinds_and_specs_are_the_references():
    assert FP.SITES == JFP.SITES and len(FP.SITES) == 12
    assert FP.KINDS == JFP.KINDS
    text = ("pyramid.launch=0.05,stream.h2d_dispatch=once,"
            "serve.batch=slow:0.5:0.02,execute.forward=corrupt:always,"
            "stream.drain=hang:1.0,plan.build=always")
    got, want = FP.parse_faults(text), JFP.parse_faults(text)
    assert {s: (v.kind, v.prob, v.once, v.sleep_s) for s, v in got.items()} \
        == {s: (v.kind, v.prob, v.once, v.sleep_s) for s, v in want.items()}


# -- determinism ------------------------------------------------------

def test_same_seed_same_fire_pattern():
    def pattern(seed):
        plan = FP.FaultPlan.from_text("serve.batch=0.3", seed=seed)
        return [plan.should_fire("serve.batch") is not None
                for _ in range(64)]
    assert pattern(42) == pattern(42)
    assert pattern(42) != pattern(43)
    assert any(pattern(42)) and not all(pattern(42))


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2 ** 31 - 1])
def test_fire_pattern_equals_the_references_draw_for_draw(seed):
    """The same text and seed fire on the same draws in both planes,
    site by site, with the sites' traffic interleaved."""
    text = ("serve.batch=0.3,pyramid.launch=0.7,execute.forward=once,"
            "execute.inverse=corrupt:0.5,plan.build=slow:0.2:0.0,"
            "stream.drain=always")
    ours = FP.FaultPlan.from_text(text, seed=seed)
    ref = JFP.FaultPlan.from_text(text, seed=seed)
    kinds = (FJ.CALL_KINDS, ("corrupt",))
    for i, site in zip(range(600), itertools.cycle(FP.SITES)):
        k = kinds[i % 2]
        got, want = ours.should_fire(site, k), ref.should_fire(site, k)
        assert (got is None) == (want is None), (i, site)
    assert ours.stats() == ref.stats()


def test_per_site_streams_are_independent():
    """Draw traffic on one site must not shift another site's pattern."""
    a = FP.FaultPlan.from_text(
        "serve.batch=0.3,pyramid.launch=0.3", seed=5)
    b = FP.FaultPlan.from_text(
        "serve.batch=0.3,pyramid.launch=0.3", seed=5)
    for _ in range(100):                       # extra traffic on one site
        b.should_fire("pyramid.launch")
    pa = [a.should_fire("serve.batch") is not None for _ in range(32)]
    pb = [b.should_fire("serve.batch") is not None for _ in range(32)]
    assert pa == pb


def test_once_fires_exactly_once_and_kind_filter_guards_draws():
    plan = FP.FaultPlan.from_text("serve.batch=once", seed=0)
    # a call-kind hook never consumes a corrupt spec's trigger & v.v.
    assert plan.should_fire("serve.batch", kinds=("corrupt",)) is None
    assert plan.should_fire("serve.batch") is not None
    assert plan.should_fire("serve.batch") is None
    assert plan.stats()["sites"]["serve.batch"]["fired"] == 1


# -- injection hooks --------------------------------------------------

def test_inactive_plane_is_a_noop_and_env_reload(monkeypatch):
    assert FJ.active() is None
    FJ.maybe_inject("serve.batch")             # no plan -> returns
    assert FJ.corrupt_output("serve.batch", 1.0) == 1.0
    monkeypatch.setenv(FP.FAULTS_ENV, "serve.batch=always")
    monkeypatch.setenv(FP.SEED_ENV, "9")
    plan = FJ.reload()
    assert plan is not None and plan.seed == 9
    with pytest.raises(FJ.InjectedFault) as ei:
        FJ.maybe_inject("serve.batch", op="forward")
    assert ei.value.site == "serve.batch" and ei.value.kind == "raise"
    monkeypatch.delenv(FP.FAULTS_ENV)
    assert FJ.reload() is None


def test_the_reference_env_does_not_arm_the_port(monkeypatch):
    monkeypatch.setenv(JFP.FAULTS_ENV, "serve.batch=always")
    monkeypatch.delenv(FP.FAULTS_ENV, raising=False)
    assert FJ.reload() is None


def test_slow_fault_returns_and_is_counted():
    FJ.activate(FP.FaultPlan.from_text("serve.batch=slow:always:0.001"))
    before = FJ.INJECTIONS.value(site="serve.batch", kind="slow")
    FJ.maybe_inject("serve.batch")             # must NOT raise
    assert FJ.INJECTIONS.value(site="serve.batch", kind="slow") \
        == before + 1


def test_corrupt_output_nan_poisons_tensors_and_tuples():
    FJ.activate(FP.FaultPlan.from_text("execute.forward=corrupt:always"))
    arr = torch.ones(4, 4)
    out = FJ.corrupt_output("execute.forward", arr)
    assert torch.isnan(out).all() and not torch.isnan(arr).any()  # a copy
    assert out.shape == arr.shape and out.dtype == arr.dtype
    ll, det = FJ.corrupt_output(
        "execute.forward", (torch.ones(2, 2), (torch.ones(3),)))
    assert torch.isnan(ll).all() and torch.isnan(det[0]).all()


# -- retry / deadline -------------------------------------------------

def test_retry_call_recovers_then_reraises_last_error():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError(f"boom {len(calls)}")
        return "ok"
    assert retry_call(flaky, site="execute.forward", retries=2,
                      backoff_s=0.0) == "ok"
    calls.clear()
    with pytest.raises(RuntimeError, match="boom 2"):   # last, not first
        retry_call(flaky, site="execute.forward", retries=1, backoff_s=0.0)


def test_retry_call_never_swallows_deadline():
    clock = FakeClock()
    d = Deadline(1.0, clock=clock)
    clock.t = 2.0
    calls = []

    def fn():
        calls.append(1)
        return "ok"
    with pytest.raises(DeadlineExceeded):
        retry_call(fn, site="serve.batch", retries=5, deadline=d)
    assert calls == []                          # expired before the call

    def raises_deadline():
        raise DeadlineExceeded("inner budget blown")
    with pytest.raises(DeadlineExceeded):
        retry_call(raises_deadline, site="serve.batch", retries=5,
                   backoff_s=0.0)


# -- circuit breaker --------------------------------------------------

def test_breaker_full_state_machine():
    clock = FakeClock()
    br = CircuitBreaker(failure_threshold=2, cooldown_s=10.0, clock=clock)
    assert br.state == "closed" and br.allow()
    br.record(ok=False)
    br.record(ok=True)                 # success resets the streak
    br.record(ok=False)
    assert br.state == "closed"
    br.record(ok=False)                # 2 consecutive -> open
    assert br.state == "open" and not br.allow()
    clock.t = 10.0                     # cooldown over -> half-open
    assert br.state == "half-open"
    assert br.allow()                  # claims THE probe slot
    assert not br.allow()              # second caller refused
    br.record(ok=False)                # failed probe -> re-open + restart
    assert br.state == "open" and not br.allow()
    clock.t = 15.0                     # cooldown restarted at t=10
    assert br.state == "open"
    clock.t = 20.0
    assert br.allow()
    br.record(ok=True)                 # successful probe -> closed
    assert br.state == "closed" and br.allow()


# -- degradation chain ------------------------------------------------

def _key(backend, fuse, **kw):
    return PlanKey("cdf97", "ns-polyconv", 2, (64, 64), "float32",
                   backend, False, fuse, "periodic", device="cpu", **kw)


def test_degradation_chain_capability_checked():
    chain = [(c.backend, c.fuse)
             for c in degradation_chain(_key("cuda", "pyramid"))]
    # fuse demotions first, then weaker backends at demoted fuses only;
    # conv never appears with "pyramid" (it has no fused-pyramid path)
    assert chain == [("cuda", "levels"), ("cuda", "none"),
                     ("conv", "levels"), ("torch", "levels")]
    assert ("conv", "pyramid") not in chain
    # the reference path has nowhere further to degrade
    assert degradation_chain(_key("torch", "none")) == []


@pytest.mark.parametrize("backend,fuse",
                         list(itertools.product(("pallas", "xla", "jnp"),
                                                FUSE_MODES)))
def test_degradation_chain_is_the_references(backend, fuse):
    for kw in ({}, {"packet": None, "ndim": 3}):
        ref = JPlanKey("cdf97", "ns-polyconv", 2, (8, 64, 64), "float32",
                       backend, False, fuse, "periodic", **kw)
        ours = PlanKey("cdf97", "ns-polyconv", 2, (8, 64, 64), "float32",
                       BACKEND_NAMES[backend], False, fuse, "periodic",
                       device="cpu", **kw)
        want = [(BACKEND_NAMES[c.backend], c.fuse)
                for c in jdegradation_chain(ref)]
        got = [(c.backend, c.fuse) for c in degradation_chain(ours)]
        assert got == want
        assert all(c.device == "cpu" for c in degradation_chain(ours))
