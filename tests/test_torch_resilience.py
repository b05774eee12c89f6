"""Resilience on the port: faults riding through repro_torch's engine —
the executor-dispatch cases of tests/test_resilience.py (retry in place,
corruption caught and retried, degradation down the capability chain
verified against the torch reference, chain exhaustion, fail-fast when
switched off, engine.stats()) and its atomic-write case, run on the
port — plus a degraded result held against the reference package's
degraded result, and the boundaries of what the chain recovers from.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro_torch as R
from repro_torch import engine as TE
from repro_torch import ioutil
from repro_torch import telemetry as T
from repro_torch.engine.pyramid import Pyramid
from repro_torch.faults import degrade as DG
from repro_torch.faults import inject as FJ
from repro_torch.faults import plan as FP
from repro_torch.faults.degrade import (FALLBACKS, DegradationExhausted,
                                        ExactnessError)
from repro_torch.kernels import tap_window as TW

from repro.core import dwt2 as jdwt2
from repro.faults import inject as JFJ
from repro.faults import plan as JFP

pytestmark = pytest.mark.chaos

# tests/test_differential.py CROSS_TOL (float32)
CROSS_TOL = dict(rtol=2e-4, atol=2e-5)


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


def _arm(text, seed=0):
    return FJ.activate(FP.FaultPlan.from_text(text, seed=seed))


def _img(shape=(64, 64), seed=0):
    return torch.from_numpy(np.random.default_rng(seed)
                            .standard_normal(shape).astype(np.float32))


def dwt2(x, **kw):
    return R.dwt2(x, device="cpu", **kw)


def idwt2(pyr, **kw):
    return R.idwt2(pyr, device="cpu", **kw)


# -- executor dispatch: retry + degrade -------------------------------

def test_transient_fault_retried_bit_identical():
    x = _img()
    ref = dwt2(x, levels=2).ll
    _arm("execute.forward=once")
    pyr = dwt2(x, levels=2)
    assert torch.equal(pyr.ll, ref)


def test_corruption_detected_and_retried_bit_identical():
    x = _img(seed=1)
    ref = dwt2(x, levels=2).ll
    _arm("execute.forward=corrupt:once")
    pyr = dwt2(x, levels=2)          # poisoned attempt rejected, retried
    assert torch.equal(pyr.ll, ref)
    assert not torch.isnan(pyr.ll).any()
    assert TE.stats()["faults"]["retries"] == 1


def test_persistent_failure_degrades_and_records_fallback():
    x = _img(seed=2)
    ref = dwt2(x, levels=2, backend="torch", fuse="none").ll
    _arm("pyramid.launch=always")
    pyr = dwt2(x, levels=2, backend="cuda", fuse="pyramid")
    FJ.activate(None)
    assert torch.allclose(pyr.ll, ref, rtol=1e-3, atol=1e-4)
    # the hop ran cuda/levels: exactly what a direct call computes
    direct = dwt2(x, levels=2, backend="cuda", fuse="levels")
    assert torch.equal(pyr.ll, direct.ll)
    assert FALLBACKS.value(**{"from": "cuda/pyramid", "to": "cuda/levels",
                              "site": "pyramid.launch"}) == 1
    labels = [s["labels"] for s in FALLBACKS.series()]
    assert all({"from", "to", "site"} <= set(lb) for lb in labels)


def test_reference_path_exhausts_chain_with_cause():
    x = _img(seed=3)
    _arm("execute.forward=always")
    with pytest.raises(DegradationExhausted) as ei:
        dwt2(x, levels=1, backend="torch", fuse="none")
    assert isinstance(ei.value.__cause__, FJ.InjectedFault)


def test_resilience_off_restores_fail_fast(monkeypatch):
    monkeypatch.setattr(
        DG, "CONFIG", dataclasses.replace(DG.CONFIG, enabled=False))
    _arm("execute.forward=always")
    with pytest.raises(FJ.InjectedFault):
        dwt2(_img(seed=4), levels=1)


def test_resilience_env_reload(monkeypatch):
    monkeypatch.setenv(DG.ENABLE_ENV, "off")
    monkeypatch.setenv(DG.RETRIES_ENV, "3")
    monkeypatch.setenv(DG.VERIFY_ENV, "off")
    try:
        cfg = DG.reload()
        assert (cfg.enabled, cfg.retries, cfg.verify) == (False, 3, False)
    finally:
        monkeypatch.undo()
        assert DG.reload().enabled


def test_inverse_dispatch_recovers_too():
    x = _img(seed=5)
    pyr = dwt2(x, levels=2)
    ref = idwt2(pyr)
    _arm("execute.inverse=once")
    out = idwt2(pyr)
    assert torch.equal(out, ref)


def test_packet_inverse_dispatch_degrades():
    x = _img(seed=11)
    pk = R.wpt2(x, packet="full:2", backend="cuda", fuse="levels",
                device="cpu")
    _arm("execute.inverse=always")
    rec = R.iwpt2(pk, backend="cuda", fuse="levels", device="cpu")
    assert torch.allclose(rec, x, rtol=1e-3, atol=1e-4)
    assert FALLBACKS.value(**{"from": "cuda/levels", "to": "cuda/none",
                              "site": "execute.inverse"}) == 1


def test_engine_stats_faults_section_live():
    _arm("execute.forward=once")
    dwt2(_img(seed=6), levels=1)
    s = TE.stats()["faults"]
    assert s["active"] and s["injections"] >= 1
    assert s["retries"] >= 1
    FJ.activate(None)
    assert TE.stats()["faults"]["active"] is False


def test_degraded_result_matches_the_references_degraded_result():
    """pyramid.launch fails in both packages: each degrades its fused
    pyramid to its per-level kernel path, and the two results agree
    within CROSS_TOL."""
    x = np.random.default_rng(7).standard_normal((64, 64)) \
        .astype(np.float32)
    prev = JFJ.activate(JFP.FaultPlan.from_text("pyramid.launch=always"))
    try:
        want = jdwt2(x, levels=2, backend="pallas", fuse="pyramid")
    finally:
        JFJ.activate(prev)
    _arm("pyramid.launch=always")
    got = dwt2(torch.from_numpy(x), levels=2, backend="cuda",
               fuse="pyramid")
    assert FALLBACKS.value(**{"from": "cuda/pyramid", "to": "cuda/levels",
                              "site": "pyramid.launch"}) == 1
    for g, w in zip([got.ll] + [d for det in got.details for d in det],
                    [want.ll] + [d for det in want.details for d in det]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CROSS_TOL)


def test_fallback_rejected_when_it_disagrees(monkeypatch):
    """A hop whose output breaks the exactness contract is refused and
    the chain moves on to the next hop."""
    x = _img(seed=8)
    real = DG._run_key
    bad = {"cuda/levels"}

    def run_key(cand, op, args):
        out = real(cand, op, args)
        if f"{cand.backend}/{cand.fuse}" in bad:
            ll, det = out
            return ll + 1.0, det
        return out
    monkeypatch.setattr(DG, "_run_key", run_key)
    _arm("pyramid.launch=always")
    pyr = dwt2(x, levels=2, backend="cuda", fuse="pyramid")
    want = dwt2(x, levels=2, backend="cuda", fuse="none")
    assert torch.equal(pyr.ll, want.ll)
    assert FALLBACKS.value(**{"from": "cuda/pyramid", "to": "cuda/none",
                              "site": "pyramid.launch"}) == 1
    with pytest.raises(ExactnessError):
        DG._verify((torch.zeros(2), ), (torch.ones(2), ),
                   TE.PlanKey("cdf97", "ns-polyconv", 1, (2, 2), "float32",
                              "torch", False, "none", "periodic",
                              device="cpu"))


@pytest.mark.parametrize("err", [
    RuntimeError("tap_window launch failed: CUDA error 700 (an illegal "
                 "memory access was encountered)"),
    RuntimeError("nvcc failed building tap_window.cu: exit status 1"),
    OSError("libtap_window.so: cannot open shared object file"),
    TW.SmemError("window needs 240000 B of shared memory"),
    torch.OutOfMemoryError("CUDA out of memory"),
], ids=["cuda-error", "nvcc", "load", "smem", "oom"])
def test_device_fault_is_raised_not_degraded(monkeypatch, err):
    """A kernel that fails to build, load or launch on the cuda backend
    propagates out of dwt2 as it is: neither retried nor degraded to a
    plain version."""
    def failed(win, planes):
        raise err
    monkeypatch.setattr(TW, "tap_window", failed)
    with pytest.raises(type(err)) as ei:
        dwt2(_img(seed=9), levels=1, backend="cuda", fuse="levels")
    assert ei.value is err
    s = TE.stats()["faults"]
    assert (s["fallbacks"], s["retries"]) == (0, 0)


def test_host_failure_of_a_cpu_plan_degrades(monkeypatch):
    """A torch or conv plan on the CPU degrades on any host-side failure,
    as the reference package's plans do."""
    x = _img(seed=12)
    plan = TE.get_plan(shape=(64, 64), levels=1, backend="conv",
                       fuse="levels", device="cpu")

    def failed(x):
        raise RuntimeError("host-side failure")
    monkeypatch.setattr(plan.executor, "forward", failed)
    pyr = plan.execute(x)
    want = dwt2(x, levels=1, backend="torch", fuse="levels")
    assert torch.allclose(pyr.ll, want.ll, rtol=1e-3, atol=1e-4)
    assert FALLBACKS.value(**{"from": "conv/levels", "to": "conv/none",
                              "site": "execute.forward"}) == 1
    assert TE.stats()["faults"]["retries"] == 1


def test_finite_sweep_runs_only_while_the_plane_is_armed(monkeypatch):
    """The sweep synchronises with the device: disarmed, dispatch must
    never call it."""
    calls = []
    real = DG._has_nonfinite
    monkeypatch.setattr(DG, "_has_nonfinite",
                        lambda out: calls.append(1) or real(out))
    x = _img(seed=10)
    pyr = dwt2(x, levels=2)
    idwt2(pyr)
    assert calls == []
    _arm("plan.build=once")            # armed at a site this call skips
    dwt2(x, levels=2)
    assert calls == [1]


# -- input validation (validate="nan") --------------------------------

def test_validate_nan_rejects_bad_inputs_and_pyramids():
    x = _img()
    x[3, 7] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        dwt2(x, levels=1, validate="nan")
    with pytest.raises(ValueError, match="validate"):
        dwt2(_img(), levels=1, validate="bogus")
    pyr = dwt2(_img(), levels=1)
    bad_ll = pyr.ll.clone()
    bad_ll[0, 0] = float("inf")
    bad = Pyramid(ll=bad_ll, details=pyr.details)
    with pytest.raises(ValueError, match="non-finite"):
        idwt2(bad, validate="nan")
    # default stays permissive (no device-sync sweep on the hot path)
    assert dwt2(x, levels=1) is not None


# -- crash-safe I/O ----------------------------------------------------

def test_atomic_write_text_replaces_not_appends(tmp_path):
    p = str(tmp_path / "f.json")
    ioutil.atomic_write_text(p, "old content")
    ioutil.atomic_write_text(p, "new")
    assert open(p).read() == "new"
    assert os.listdir(tmp_path) == ["f.json"]   # temp cleaned up


def test_fsync_append_and_line_checksums(tmp_path):
    from repro import ioutil as jioutil
    p = str(tmp_path / "journal.jsonl")
    ioutil.fsync_append(p, "a")
    ioutil.fsync_append(p, "b\n")
    assert open(p).read() == "a\nb\n"
    crc = ioutil.line_checksum('{"k": 1}')
    assert crc == jioutil.line_checksum('{"k": 1}')
    assert ioutil.checksum_ok('{"k": 1}', crc)
    assert not ioutil.checksum_ok('{"k": 2}', crc)
