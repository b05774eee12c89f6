"""The reversible 5-3 of ISO/IEC 15444-1 Annex F on the port's integer
path: ``dwt2``/``idwt2`` with ``wavelet="rev53"`` on int32 images, held
exactly to the benchmark's plain reference (``portbench/reference/
rev53.py``, written from the standard's own procedures), the round trip
exact, the plan's checks, and the spans and counter it reports.  CPU
only, small shapes; the kernel on the card is ``tests/test_torch_cuda.py``.
"""
import sys
from pathlib import Path

import pytest
import torch

import repro_torch as R
from repro_torch import engine as TE
from repro_torch import telemetry as T
from repro_torch.kernels import rev_lift as RL
from repro_torch.kernels import tap_window as TW

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import rev53 as REF  # noqa: E402

ARGS = dict(wavelet="rev53", scheme="sep-lifting", boundary="symmetric",
            device="cpu")


def _samples(shape, seed):
    """Seeded 12-bit samples, DC-shifted as JPEG 2000 codes them."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2048, 2048, shape, generator=g, dtype=torch.int32)


def _flat(ll, details):
    return [ll] + [t for level in details for t in level]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape,levels", [
    ((2, 64, 64), 5), ((3, 32, 96), 3), ((1, 48, 16), 1), ((2, 2, 8), 1),
    ((4, 16, 40), 3)])
def test_port_equals_the_reference_and_round_trips(shape, levels, backend):
    x = _samples(shape, seed=sum(shape) + levels)
    pyr = R.dwt2(x, levels=levels, backend=backend, **ARGS)
    ll, details = REF.dwt2(x, levels)
    got, want = _flat(pyr.ll, pyr.details), _flat(ll, details)
    assert len(got) == len(want) == 1 + 3 * levels
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g.long(), w)
    rec = R.idwt2(pyr, backend=backend, **ARGS)
    assert rec.dtype == torch.int32 and torch.equal(rec, x)


def test_constant_image_gives_zero_details_and_constant_ll():
    x = torch.full((2, 32, 64), -517, dtype=torch.int32)
    pyr = R.dwt2(x, levels=5, backend="torch", **ARGS)
    assert torch.equal(pyr.ll, torch.full_like(pyr.ll, -517))
    for level in pyr.details:
        for t in level:
            assert not t.any()


def test_the_float_control_differs_from_the_reference():
    x = _samples((2, 64, 64), seed=5)
    ll, details = REF.dwt2(x, 5)
    c_ll, c_details = REF.dwt2(x, 5, dtype=torch.float32)
    differ = sum(int((c.round().long() != w).sum())
                 for c, w in zip(_flat(c_ll, c_details), _flat(ll, details)))
    assert differ > 0


@pytest.mark.parametrize("kw,field", [
    (dict(x=torch.zeros(1, 16, 16)), "PlanKey.dtype"),
    (dict(scheme="ns-polyconv"), "PlanKey.scheme"),
    (dict(backend="conv"), "PlanKey.backend"),
    (dict(boundary="periodic"), "PlanKey.boundary"),
    (dict(fuse="pyramid"), "PlanKey.fuse"),
    (dict(backend="auto"), "PlanKey.backend"),
])
def test_a_reversible_key_outside_annex_f_raises_naming_the_field(kw, field):
    kw = dict(kw)
    x = kw.pop("x", torch.zeros(1, 16, 16, dtype=torch.int32))
    with pytest.raises(TE.BackendError, match=field):
        R.dwt2(x, levels=2, **dict(ARGS, **kw))


def test_a_float_wavelet_refuses_int32_and_the_symmetric_boundary():
    with pytest.raises(TE.BackendError, match="PlanKey.dtype"):
        R.dwt2(torch.zeros(1, 16, 16, dtype=torch.int32), levels=1,
               device="cpu")
    with pytest.raises(ValueError, match="boundary 'symmetric'"):
        R.dwt2(torch.zeros(1, 16, 16), levels=1, boundary="symmetric",
               device="cpu")


def test_plans_report_launches_and_capabilities():
    plan = TE.get_plan(shape=(4, 64, 64), levels=5, dtype="int32",
                       compute_dtype="int32", cache=TE.PlanCache(),
                       fuse="levels", **ARGS)
    assert plan.launches == 5 and plan.fallback is None
    assert plan.prepare() is plan          # no kernel to build on the CPU
    rows = {row["backend"]: row for row in TE.capability_matrix()}
    assert rows["cuda"]["reversible"]["scheme"] == ("sep-lifting",)
    assert rows["torch"]["reversible"]["wavelets"] == ("rev53",)
    assert rows["conv"]["reversible"] is None
    assert rows["auto"]["reversible"] is None


def test_revlift_spans_and_the_rev_lift_series():
    """Each level is one ``revlift.*`` span (the plain path's level on
    the CPU, where nothing launches); launches count under the
    ``rev_lift`` series of ``repro_kernel_launches_total``."""
    prev = T.mode()
    T.set_mode("spans")
    try:
        T.TRACER.clear()
        x = _samples((1, 32, 32), seed=3)
        R.idwt2(R.dwt2(x, levels=3, backend="cuda", **ARGS),
                backend="cuda", **ARGS)
        names = [r.name for r in T.TRACER.records()]
    finally:
        T.CONFIG.apply(prev)
        T.TRACER.clear()
    assert names.count("revlift.forward") == 3
    assert names.count("revlift.inverse") == 3
    assert "level.forward" not in names
    before = RL.KERNEL.launches
    RL.KERNEL.launched((1, 1))
    try:
        rows = {r["labels"]["kernel"]: r["value"]
                for r in TW.LAUNCHES.series()}
        assert rows["rev_lift"] == before + 1
    finally:
        RL.KERNEL.launches = before


def test_a_failed_level_falls_back_to_the_plain_path_and_counts():
    """The resilience plane's one hop for a reversible plan is the plain
    integer path, held to equality and counted in
    ``repro_fallbacks_total``."""
    from repro_torch.engine.plan import PlanKey
    from repro_torch.faults import degrade, inject
    from repro_torch.faults.plan import FaultPlan
    key = PlanKey("rev53", "sep-lifting", 3, (2, 32, 32), "int32", "cuda",
                  False, "levels", "symmetric", compute_dtype="int32",
                  device="cpu")
    assert [(c.backend, c.fuse)
            for c in degrade.degradation_chain(key)] == [("torch", "none")]
    hop = {"from": "cuda/levels", "to": "torch/none",
           "site": "execute.forward"}

    def hops():
        return sum(r["value"] for r in degrade.FALLBACKS.series()
                   if r["labels"] == hop)

    x = _samples((2, 32, 32), seed=9)
    want = R.dwt2(x, levels=3, backend="torch", **ARGS)
    before = hops()
    prev = inject.activate(FaultPlan.from_text(
        "execute.forward=raise:always"))
    try:
        got = R.dwt2(x, levels=3, fuse="levels", **ARGS)
    finally:
        inject.activate(prev)
    assert hops() == before + 1
    for g, w in zip(_flat(got.ll, got.details), _flat(want.ll, want.details)):
        assert torch.equal(g, w)
