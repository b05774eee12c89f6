"""Wavelet packets and the 3-D (t+2D) transform in the port, against the
reference package.

Mirrors ``tests/test_workloads.py`` (its serving and degradation tests
wait for those layers): the packet tree algebra and best-basis costs
equal the reference's, ``wpt2``/``iwpt2``/``best_basis`` and
``dwt3``/``idwt3`` on every port backend ("torch"; "cuda", which runs
the window kernel's plain version on CPU tensors; "conv") agree with the
reference's "jnp" backend for all six schemes, one case of each with its
interpret-mode "pallas" backend, the temporal lifting programs are the
reference's, and the plan layer checks, demotes, caches and counts as
the reference does.  Inputs come from ``np.random.default_rng(seed)``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.compiler import temporal as JTP
from repro.core import packets as JPK
from repro.core import transform as JT
from repro.core.schemes import SCHEMES
from repro.engine import backends as JB
from repro.engine import cache as JC

import repro_torch as R
from repro_torch import engine as TE
from repro_torch.compiler import temporal as TTP
from repro_torch.convert import packet_from_numpy, pyramid3_from_numpy
from repro_torch.core import packets as TPK

# tests/test_differential.py ROUNDTRIP_TOL / CROSS_TOL
ROUNDTRIP_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
                 "float16": dict(rtol=2e-2, atol=2e-3)}
CROSS_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
             "float16": dict(rtol=2e-2, atol=2e-3)}
BACKENDS = ("torch", "cuda", "conv")
MIXED = ("aa", "ah", "av", "ad", "h", "v", "da", "dh", "dv", "dd")
# (I/O dtype, compute dtype, tolerance): bf16 compute is held to the
# reference's own bf16-compute result at the fp16 bound
PRECISIONS = {"fp32": (np.float32, "float32", CROSS_TOL["float32"]),
              "fp16-io": (np.float16, "float32", CROSS_TOL["float16"]),
              "bf16-compute": (np.float32, "bfloat16", CROSS_TOL["float16"])}
# the conv backend composes a level into one dense filter bank, so its
# bf16 arithmetic is not the per-tap walk's: under bf16 compute it is held
# to the reference's own conv backend ("xla"), which rounds the same bank


def _reference(precision, port_backend, fn, *args, **kw):
    """The reference result a port backend is held to, and the bound."""
    _, cdt, tol = PRECISIONS[precision]
    if port_backend == "conv" and cdt == "bfloat16":
        kw = dict(kw, backend="xla", fuse="scheme")
    return fn(*args, compute_dtype=cdt, **kw), tol


def _img(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def _flat(out):
    """Leaves of a packet decomposition, or every subband of a pyramid."""
    if hasattr(out, "leaves"):
        return list(out.leaves)
    return [out.ll] + [d for det in out.details for d in det]


def _assert_close(got, ref, tol):
    g, r = _flat(got), _flat(ref)
    assert [tuple(a.shape) for a in g] == [tuple(b.shape) for b in r]
    for a, b in zip(g, r):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


# ---------------------------------------------------------------------------
# PacketTree algebra and costs: the reference's, exactly
# ---------------------------------------------------------------------------

SPECS = ["full:1", "full:2", "full:3", "dwt:1", "dwt:2", "dwt:3", "dwt:4",
         tuple(reversed(JPK.PacketTree.full(2).leaves)), MIXED,
         tuple(reversed(MIXED)), ("a", "h", "v", "da", "dh", "dv", "dd")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_packet_tree_equals_reference(spec):
    ref, got = JPK.PacketTree.from_spec(spec), TPK.PacketTree.from_spec(spec)
    assert got.leaves == ref.leaves
    assert got.depth == ref.depth and len(got) == len(ref)
    assert got.internal_nodes() == ref.internal_nodes()
    assert TPK.PacketTree.from_spec(got) is got


INADMISSIBLE = [("a", "h", "v"),                    # incomplete
                ("a", "h", "v", "d", "aa"),         # prefix overlap
                ("",),                              # root as leaf
                ("a", "h", "v", "x"),               # bad alphabet
                ("a", "a", "h", "v", "d"),          # duplicate
                (), "full:x", "tree:2", "full", "full:0", "dwt:0"]


@pytest.mark.parametrize("spec", INADMISSIBLE, ids=str)
def test_packet_tree_error_texts_equal_reference(spec):
    with pytest.raises(ValueError) as ref:
        JPK.PacketTree.from_spec(spec)
    with pytest.raises(ValueError) as got:
        TPK.PacketTree.from_spec(spec)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("depth", (1, 2, 3))
@pytest.mark.parametrize("seed", range(4))
def test_best_basis_from_costs_equals_reference(seed, depth):
    rng = np.random.default_rng(seed)
    nodes = [""]
    level = [""]
    for _ in range(depth):
        level = [p + c for p in level for c in TPK.CHILDREN]
        nodes += level
    costs = {p: float(rng.uniform(0, 10 * 4 ** -len(p))) for p in nodes}
    assert TPK.best_basis_from_costs(costs, depth).leaves == \
        JPK.best_basis_from_costs(costs, depth).leaves
    with pytest.raises(ValueError) as ref:
        JPK.best_basis_from_costs({"": 1.0}, depth)
    with pytest.raises(ValueError) as got:
        TPK.best_basis_from_costs({"": 1.0}, depth)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("cost", sorted(JPK.COSTS))
def test_costs_equal_reference(cost):
    a = _img((3, 17, 9), seed=1) * 0.05
    a[0, 0, :3] = 0.0
    assert TPK.COSTS[cost](a) == JPK.COSTS[cost](a)
    assert TPK.COSTS[cost](np.zeros(4)) == JPK.COSTS[cost](np.zeros(4))


# ---------------------------------------------------------------------------
# wpt2 / iwpt2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", (1, 2, 3))
@pytest.mark.parametrize("backend", BACKENDS)
def test_wpt2_of_the_pyramid_tree_is_dwt2_bit_for_bit(backend, levels):
    x = torch.from_numpy(_img((2, 24, 40), seed=levels))
    kw = dict(backend=backend, fuse="levels", device="cpu")
    pk = R.wpt2(x, packet=f"dwt:{levels}", **kw)
    pyr = R.dwt2(x, levels=levels, **kw)
    assert torch.equal(pk["a" * levels], pyr.ll)
    for lvl, det in enumerate(pyr.details):       # coarsest first
        prefix = "a" * (levels - 1 - lvl)
        for c, band in zip("hvd", det):
            assert torch.equal(pk[prefix + c], band)


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_wpt2_matches_reference_jnp(scheme, precision):
    io, cdt, _ = PRECISIONS[precision]
    x = _img((2, 20, 28), seed=3, dtype=io)
    fuse = "none" if precision == "fp32" else "scheme"
    for packet, backend in itertools.product(("full:2", MIXED), BACKENDS):
        ref, tol = _reference(precision, backend, JT.wpt2, x,
                              packet=packet, scheme=scheme, backend="jnp")
        kw = dict(scheme=scheme, backend=backend, fuse=fuse,
                  compute_dtype=cdt, device="cpu")
        pk = R.wpt2(torch.from_numpy(x), packet=packet, **kw)
        assert pk.paths == ref.paths
        assert pk.leaves[0].dtype == torch.from_numpy(x).dtype
        _assert_close(pk, ref, tol)
        if precision == "bf16-compute":
            continue              # bf16 arithmetic: forward parity only
        rec = R.iwpt2(pk, **kw)
        np.testing.assert_allclose(
            _np(rec), x.astype(np.float32),
            **ROUNDTRIP_TOL["float32" if precision == "fp32"
                            else "float16"])


def test_wpt2_matches_reference_pallas():
    """The reference's Pallas path (interpret mode), one configuration."""
    x = _img((2, 12, 20), seed=5)
    ref = JT.wpt2(x, packet="full:2", backend="pallas", fuse="levels")
    pk = R.wpt2(torch.from_numpy(x), packet="full:2", backend="cuda",
                fuse="levels", device="cpu")
    _assert_close(pk, ref, CROSS_TOL["float32"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_iwpt2_of_a_reference_decomposition(backend):
    """A packet decomposition made by the reference, carried across."""
    x = _img((2, 20, 28), seed=6)
    for packet in ("full:2", MIXED):
        ref = JT.wpt2(x, packet=packet, backend="jnp")
        pk = packet_from_numpy(ref.paths, [np.asarray(a) for a in ref.leaves])
        rec = R.iwpt2(pk, backend=backend, device="cpu")
        np.testing.assert_allclose(rec.numpy(), x,
                                   **ROUNDTRIP_TOL["float32"])
        np.testing.assert_allclose(
            rec.numpy(), np.asarray(JT.iwpt2(ref, backend="jnp")),
            **CROSS_TOL["float32"])


RAMP = np.outer(np.linspace(0, 1, 32), np.linspace(0, 1, 32)) \
    .astype(np.float32)


@pytest.mark.parametrize("cost", sorted(JPK.COSTS))
@pytest.mark.parametrize("image", ("ramp", "random"))
def test_best_basis_equals_reference_tree(image, cost):
    x = RAMP if image == "ramp" else _img((32, 32), seed=7)
    ref = JT.best_basis(x, depth=2, cost=cost, backend="jnp")
    for backend in ("torch", "cuda"):
        tree = R.best_basis(torch.from_numpy(x), depth=2, cost=cost,
                            backend=backend, device="cpu")
        assert isinstance(tree, TPK.PacketTree)
        assert tree.leaves == ref.leaves
        pk = R.wpt2(torch.from_numpy(x), packet=tree, backend=backend,
                    device="cpu")
        np.testing.assert_allclose(
            R.iwpt2(pk, backend=backend, device="cpu").numpy(), x,
            **ROUNDTRIP_TOL["float32"])
    with pytest.raises(ValueError, match="unknown cost"):
        R.best_basis(torch.from_numpy(x), cost="nope", device="cpu")


def test_best_basis_reads_bfloat16_nodes():
    x = torch.from_numpy(_img((16, 16), seed=8)).bfloat16()
    tree = R.best_basis(x, depth=2, backend="torch", device="cpu")
    assert tree.depth <= 2 and len(R.wpt2(x, packet=tree, backend="torch",
                                          device="cpu").leaves) == len(tree)


# ---------------------------------------------------------------------------
# dwt3 / idwt3 and the temporal pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", sorted(PRECISIONS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dwt3_matches_reference_jnp(scheme, precision):
    io, cdt, _ = PRECISIONS[precision]
    x = _img((2, 12, 20, 28), seed=4, dtype=io)
    fuse = "none" if precision == "fp32" else "scheme"
    for backend in BACKENDS:
        ref, tol = _reference(precision, backend, JT.dwt3, x, levels=2,
                              scheme=scheme, backend="jnp")
        kw = dict(scheme=scheme, backend=backend, fuse=fuse,
                  compute_dtype=cdt, device="cpu")
        p3 = R.dwt3(torch.from_numpy(x), levels=2, **kw)
        assert p3.levels == 2 and all(len(d) == 7 for d in p3.details)
        _assert_close(p3, ref, tol)       # the 7-subband order included
        if precision == "bf16-compute":
            continue
        rec = R.idwt3(p3, **kw)
        np.testing.assert_allclose(
            _np(rec), x.astype(np.float32),
            **ROUNDTRIP_TOL["float32" if precision == "fp32"
                            else "float16"])


def test_dwt3_matches_reference_pallas():
    """The reference's Pallas path (interpret mode), one configuration."""
    x = _img((4, 12, 20), seed=6)
    ref = JT.dwt3(x, levels=2, backend="pallas", fuse="levels")
    p3 = R.dwt3(torch.from_numpy(x), levels=2, backend="cuda",
                fuse="levels", device="cpu")
    _assert_close(p3, ref, CROSS_TOL["float32"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_idwt3_of_a_reference_pyramid(backend):
    x = _img((2, 8, 12, 20), seed=9)
    ref = JT.dwt3(x, levels=2, backend="jnp")
    p3 = pyramid3_from_numpy(np.asarray(ref.ll),
                             [[np.asarray(d) for d in det]
                              for det in ref.details])
    rec = R.idwt3(p3, backend=backend, device="cpu")
    np.testing.assert_allclose(rec.numpy(), x, **ROUNDTRIP_TOL["float32"])


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("wavelet", ("cdf53", "cdf97", "dd137"))
def test_compile_temporal_equals_reference(wavelet, inverse):
    ref = JTP.compile_temporal(wavelet, inverse)
    got = TTP.compile_temporal(wavelet, inverse)
    assert [(s.target, s.taps) for s in got.steps] == \
        [(s.target, s.taps) for s in ref.steps]
    assert (got.s_scale, got.d_scale, got.inverse, got.reach) == \
        (ref.s_scale, ref.d_scale, ref.inverse, ref.reach)


@pytest.mark.parametrize("cdt", ("float32", "bfloat16"))
@pytest.mark.parametrize("wavelet", ("cdf53", "cdf97", "dd137"))
def test_temporal_pass_matches_reference(wavelet, cdt):
    import jax.numpy as jnp
    x = _img((2, 8, 6, 10), seed=10)
    tol = CROSS_TOL["float32" if cdt == "float32" else "float16"]
    jf, ji = (JTP.compile_temporal(wavelet, i) for i in (False, True))
    tf, ti = (TTP.compile_temporal(wavelet, i) for i in (False, True))
    ref = JTP.temporal_forward(jnp.asarray(x), jf, jnp.dtype(cdt))
    got = TTP.temporal_forward(torch.from_numpy(x), tf, getattr(torch, cdt))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    s, d = (np.array(b) for b in ref)
    back = TTP.temporal_inverse(torch.from_numpy(s), torch.from_numpy(d), ti,
                                getattr(torch, cdt))
    want = JTP.temporal_inverse(jnp.asarray(s), jnp.asarray(d), ji,
                                jnp.dtype(cdt))
    np.testing.assert_allclose(back.numpy(), np.asarray(want), **tol)
    if cdt == "float32":
        np.testing.assert_allclose(TTP.temporal_inverse(*got, ti).numpy(),
                                   x, **ROUNDTRIP_TOL["float32"])
    with pytest.raises(ValueError, match="temporal axis must be even"):
        TTP.temporal_split(torch.zeros(3, 4, 4))


# ---------------------------------------------------------------------------
# plan layer
# ---------------------------------------------------------------------------

def test_packet_plans_cache_by_canonical_tree():
    cache = TE.PlanCache()
    p1 = TE.get_plan(shape=(16, 16), packet="full:2", device="cpu",
                     cache=cache)
    p2 = TE.get_plan(shape=(16, 16), packet=tuple(reversed(p1.key.packet)),
                     device="cpu", cache=cache)
    p3 = TE.get_plan(shape=(16, 16), packet=TPK.PacketTree.full(2),
                     device="cpu", cache=cache)
    assert p1 is p2 is p3 and cache.stats()["misses"] == 1
    ref = JC.get_plan(shape=(16, 16), packet="full:2", cache=JC.PlanCache())
    assert p1.key.levels == ref.key.levels == 2
    assert p1.key.packet == ref.key.packet


@pytest.mark.parametrize("backend", BACKENDS[:2])
def test_pyramid_fuse_demotes_for_packet_and_3d(backend):
    cache = TE.PlanCache()
    before = dict(TE.WORKLOAD_COUNTERS)
    p = TE.get_plan(shape=(16, 16), packet="full:2", fuse="pyramid",
                    backend=backend, device="cpu", cache=cache)
    ref = JC.get_plan(shape=(16, 16), packet="full:2", fuse="pyramid",
                      backend="jnp", cache=JC.PlanCache())
    assert p.key.fuse == ref.key.fuse == "levels"
    assert p.fallback == ref.fallback and p.pyramid is None
    p3 = TE.get_plan(shape=(4, 16, 16), ndim=3, fuse="pyramid",
                     backend=backend, device="cpu", cache=cache)
    assert p3.key.fuse == "levels" and "dwt3 plan" in p3.fallback
    assert TE.WORKLOAD_COUNTERS == {"packet": before["packet"] + 1,
                                    "dwt3": before["dwt3"] + 1}


def test_cuda_3d_temporal_fallback_recorded():
    assert TE.get_backend("cuda").temporal_fuse is False
    p = TE.get_plan(shape=(4, 16, 16), ndim=3, fuse="levels",
                    backend="cuda", device="cpu", cache=TE.PlanCache())
    ref = JC.get_plan(shape=(4, 16, 16), ndim=3, fuse="levels",
                      backend="pallas", cache=JC.PlanCache())
    assert p.fallback == ref.fallback.replace("'pallas'", "'cuda'")
    assert "temporal pass runs unfused" in p.fallback
    for backend in ("torch", "conv"):
        assert TE.get_plan(shape=(4, 16, 16), ndim=3, fuse="levels",
                           backend=backend, device="cpu",
                           cache=TE.PlanCache()).fallback is None


def test_backend_validate_rejects_pyramid_packet_key():
    key = TE.PlanKey("cdf97", "ns-polyconv", 1, (16, 16), "float32", "torch",
                     False, "pyramid", "periodic", "float32", "full", "cpu",
                     packet=("a", "h", "v", "d"))
    ref_key = JC.PlanKey("cdf97", "ns-polyconv", 1, (16, 16), "float32",
                         "jnp", False, "pyramid", "periodic", "float32",
                         "full", None, packet=("a", "h", "v", "d"))
    with pytest.raises(TE.BackendError) as got:
        TE.get_backend("torch").validate(key)
    with pytest.raises(JB.BackendError) as ref:
        JB.get_backend("jnp").validate(ref_key)
    assert str(got.value) == str(ref.value).replace("'jnp'", "'torch'")


@pytest.mark.parametrize("kw", [
    dict(shape=(4, 16, 16), packet="full:2", ndim=3),    # packet + 3-D
    dict(shape=(64, 64), packet="full:2", tiles=(32, 32)),
    dict(shape=(4, 16, 16), ndim=3, tiles=(8, 8)),
    dict(shape=(6, 16, 16), ndim=3, levels=2),            # T % 2^levels
    dict(shape=(16, 16), ndim=3),                         # rank too low
    dict(shape=(16, 16), ndim=4),
], ids=["packet-3d", "packet-tiles", "3d-tiles", "indivisible-T",
        "rank", "ndim"])
def test_workload_key_validation_errors_equal_reference(kw):
    with pytest.raises(ValueError) as ref:
        JC.get_plan(cache=JC.PlanCache(), **kw)
    with pytest.raises(ValueError) as got:
        TE.get_plan(device="cpu", cache=TE.PlanCache(), **kw)
    assert not isinstance(got.value, TE.BackendError)
    assert str(got.value) == str(ref.value)


def test_packet_depth_must_equal_levels():
    key = TE.PlanKey("cdf97", "ns-polyconv", 1, (16, 16), "float32", "torch",
                     False, "none", "periodic", device="cpu",
                     packet=TPK.PacketTree.full(2).leaves)
    with pytest.raises(ValueError, match="must equal the packet tree depth"):
        TE.build_plan(key)


@pytest.mark.parametrize("kw,runs", [
    (dict(packet=("a", "h", "v", "d")), (1,)),
    (dict(packet="full:2"), (1, 4)),
    (dict(packet=MIXED), (1, 2)),
    (dict(ndim=3, levels=2), (2, 2)),
], ids=["packet-depth-1", "packet-full-2", "packet-mixed", "ndim-3"])
def test_packet_and_volume_keys_build_plans(kw, runs):
    """Packet and 3-D keys plan (they raised before these workloads were
    ported); each level runs once per node at its depth or twice per
    3-D level, and the launch model counts every run."""
    shape = (2, 8, 32, 32) if kw.get("ndim") == 3 else (2, 32, 32)
    for fuse, per_level in (("none", 2), ("levels", 1)):
        plan = TE.get_plan(shape=shape, fuse=fuse, backend="cuda",
                           device="cpu", cache=TE.PlanCache(), **kw)
        ref = JC.get_plan(shape=shape, fuse=fuse, backend="pallas",
                          cache=JC.PlanCache(), **kw)
        assert plan.key.levels == ref.key.levels == len(runs)
        assert plan.key.packet == ref.key.packet
        assert plan.level_runs == runs
        assert plan.launches == per_level * sum(runs)
        conv = TE.get_plan(shape=shape, fuse=fuse, backend="conv",
                           device="cpu", cache=TE.PlanCache(), **kw)
        assert conv.launches == plan.launches


def test_execute_checks_leaves_and_levels():
    x = torch.from_numpy(_img((16, 16), seed=2))
    plan = TE.get_plan(shape=(16, 16), packet="full:1", device="cpu",
                       cache=TE.PlanCache())
    other = R.wpt2(x, packet="dwt:2", device="cpu")
    with pytest.raises(ValueError, match="plan built for packet leaves"):
        plan.execute_inverse(other)
    p3 = TE.get_plan(shape=(4, 16, 16), ndim=3, levels=1, device="cpu",
                     cache=TE.PlanCache())
    with pytest.raises(ValueError, match="plan built for 1 levels"):
        p3.execute_inverse(R.dwt3(torch.zeros(4, 16, 16), levels=2,
                                  device="cpu"))


def test_capabilities_expose_workload_flags():
    rows = {row["backend"]: row for row in TE.capability_matrix()}
    assert set(rows) == {"torch", "cuda", "conv"}
    for name, row in rows.items():
        assert row["packets"] is True and row["supports_3d"] is True
        assert row["temporal_fuse"] is (name != "cuda")
    ref = {row["backend"]: row for row in JB.capability_matrix()}
    for port, theirs in (("torch", "jnp"), ("cuda", "pallas"),
                         ("conv", "xla")):
        assert rows[port]["temporal_fuse"] == ref[theirs]["temporal_fuse"]


def test_validate_nan_walks_workload_containers():
    pk = R.wpt2(torch.zeros(16, 16), packet="full:1", device="cpu")
    pk.leaves[2][0, 0] = float("nan")
    with pytest.raises(ValueError, match="leaf 'v'"):
        R.iwpt2(pk, validate="nan", device="cpu")
    p3 = R.dwt3(torch.zeros(4, 16, 16), levels=1, device="cpu")
    p3.details[0][4][0, 0, 0] = float("inf")
    with pytest.raises(ValueError, match="subband 4, level 0"):
        R.idwt3(p3, validate="nan", device="cpu")


def test_flatten_pyramid_round_trips_and_matches_reference():
    x = _img((2, 16, 24), seed=11)
    pyr = R.dwt2(torch.from_numpy(x), levels=2, backend="torch",
                 device="cpu")
    flat = R.flatten_pyramid(pyr)
    ref = JT.flatten_pyramid(JT.dwt2(x, levels=2, backend="jnp"))
    np.testing.assert_allclose(flat.numpy(), np.asarray(ref),
                               **CROSS_TOL["float32"])
    back = R.unflatten_pyramid(flat, 2)
    for a, b in zip(_flat(back), _flat(pyr)):
        assert torch.equal(a, b)


def test_workloads_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros(4, 16, 16)
    for call in (lambda: R.wpt2(x), lambda: R.dwt3(x),
                 lambda: R.best_basis(x)):
        with pytest.raises(RuntimeError, match=r'device="cpu"'):
            call()
