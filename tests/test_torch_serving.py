"""repro_torch.serve against the reference's repro.serve: the cases of
tests/test_serving.py and the heartbeat cases of
tests/test_fault_tolerance.py on the port, with ``ServeConfig(
device="cpu")`` (the ``"cuda"`` backend runs its kernels' plain
versions here; the card's path is in tests/test_torch_cuda.py).

The parity target is the direct call, never the reference's server:

* served results equal direct ``repro_torch`` calls at the same
  ``(backend, fuse, tap_opt)`` bit for bit on ``"torch"`` and ``"cuda"``
  at ``"none"``/``"levels"``/``"pyramid"`` (both directions), and within
  CROSS_TOL on ``"conv"`` (its ``F.conv2d`` at ``"none"`` picks its
  algorithm per batch size);
* they are within CROSS_TOL of the reference's direct
  ``repro.core.dwt2(..., backend="jnp", fuse="levels")`` per image.

Every asyncio run is bounded (:func:`_run`), so a hang fails one test
instead of the suite; stores and tables live in ``tmp_path``.
"""
import asyncio

import numpy as np
import pytest
import torch

import repro_torch as R
from repro_torch import engine as TE
from repro_torch import telemetry as T
from repro_torch.distributed.fault_tolerance import (FaultToleranceConfig,
                                                     HeartbeatTracker)
from repro_torch.engine import autotune as AT
from repro_torch.faults import inject as PFJ
from repro_torch.faults import plan as PFP
from repro_torch.profiler import store as PST
from repro_torch.serve import (BucketSpec, DwtServer, QueueFullError,
                               ServeConfig, WorkerDied, bucket_batches,
                               padded_batch, serve_map, serve_stats)
from repro_torch.serve import bucket as BK
from repro_torch.serve import metrics as SM

from repro.core import dwt2 as jdwt2

# tests/test_differential.py
CROSS_TOL = dict(rtol=2e-4, atol=2e-5)
ROUNDTRIP_TOL = dict(rtol=1e-3, atol=1e-4)
#: (backend, fuse) pairs served bit for bit (the plain versions of the
#: kernels on "cuda")
EXACT = [(b, f) for b in ("torch", "cuda")
         for f in ("none", "levels", "pyramid")]
BOUND_S = 30.0


@pytest.fixture(autouse=True)
def _port_planes(tmp_path, monkeypatch):
    """The port's telemetry, fault and serving planes isolated per test,
    the profiler store and block table in ``tmp_path``, a clean plan
    cache."""
    monkeypatch.setenv(PST.STORE_ENV, str(tmp_path / "store.jsonl"))
    monkeypatch.setenv(AT.TABLE_ENV, str(tmp_path / "table.json"))
    AT.clear_cache()
    prev_mode = T.mode()
    prev_plan = PFJ.activate(None)
    T.set_mode("counters")
    T.reset()
    SM.reset()
    TE.clear_plan_cache()
    yield
    PFJ.activate(prev_plan)
    T.set_mode(prev_mode)
    T.reset()
    SM.reset()
    TE.clear_plan_cache()
    AT.clear_cache()


def _run(make_coro, bound: float = BOUND_S):
    """Run one test coroutine to its end, failing after ``bound`` s."""
    async def bounded():
        return await asyncio.wait_for(make_coro(), bound)
    return asyncio.run(bounded())


def _cfg(**kw):
    return ServeConfig(device="cpu", **kw)


def _images(n, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, w)).astype(np.float32)
            for _ in range(n)]


def _direct(im, **kw):
    return R.dwt2(torch.from_numpy(im), device="cpu", **kw)


def _pyr_equal(a, b):
    la, lb = BK.flatten_tree(a), BK.flatten_tree(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _pyr_close(a, b, tol):
    """Leaf by leaf within ``tol``; ``b`` may be the reference's
    Pyramid."""
    lb = [b.ll] + [d for dd in b.details for d in dd]
    for x, y in zip(BK.flatten_tree(a), lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


# -- coalescing correctness -------------------------------------------

@pytest.mark.parametrize("backend,fuse", EXACT)
@pytest.mark.parametrize("scheme", ["ns-polyconv", "sep-lifting"])
def test_coalesced_forward_bit_identical(backend, fuse, scheme):
    """Requests coalesced into one batched plan execution return exactly
    the coefficients a direct dwt2 call produces — per request, across
    partial (padded) and full batches — and stay within CROSS_TOL of the
    reference's direct jnp call."""
    imgs = _images(6)
    kw = dict(wavelet="cdf97", scheme=scheme, levels=2, backend=backend,
              fuse=fuse)
    direct = [_direct(im, **kw) for im in imgs]

    async def run():
        async with DwtServer(_cfg(max_batch=4, max_wait_ms=5.0)) as srv:
            return await asyncio.gather(
                *[srv.submit(im, **kw) for im in imgs])

    served = _run(run)
    for i, (s, d) in enumerate(zip(served, direct)):
        assert isinstance(s.ll, np.ndarray)
        assert _pyr_equal(s, d), \
            f"request {i} diverged ({backend}/{fuse}/{scheme})"
    ref = jdwt2(imgs[0], wavelet="cdf97", scheme=scheme, levels=2,
                backend="jnp", fuse="levels")
    _pyr_close(served[0], ref, CROSS_TOL)
    st = serve_stats()
    assert st["served"] == 6
    assert st["batches"] >= 2          # 6 requests > max_batch=4
    assert st["mean_occupancy"] is not None and st["mean_occupancy"] <= 1.0


@pytest.mark.parametrize("fuse", ["none", "levels"])
def test_coalesced_conv_forward_within_cross_tol(fuse):
    """The conv backend serves within CROSS_TOL of its direct calls (at
    "none" F.conv2d picks its algorithm per batch size, so batched and
    single results may differ in the last bits)."""
    imgs = _images(3)
    kw = dict(levels=2, backend="conv", fuse=fuse)

    async def run():
        async with DwtServer(_cfg(max_batch=4, max_wait_ms=5.0)) as srv:
            return await asyncio.gather(
                *[srv.submit(im, **kw) for im in imgs])

    for s, im in zip(_run(run), imgs):
        _pyr_close(s, _direct(im, **kw), CROSS_TOL)
        _pyr_close(s, jdwt2(im, levels=2, backend="jnp", fuse="levels"),
                   CROSS_TOL)


@pytest.mark.parametrize("backend,fuse", EXACT + [("conv", "levels")])
def test_coalesced_inverse_bit_identical(backend, fuse):
    imgs = _images(3)
    kw = dict(wavelet="cdf97", scheme="ns-polyconv", backend=backend,
              fuse=fuse)
    pyrs = [_direct(im, levels=2, **kw) for im in imgs]
    direct = [R.idwt2(p, device="cpu", **kw).numpy() for p in pyrs]

    async def run():
        async with DwtServer(_cfg(max_batch=4, max_wait_ms=5.0)) as srv:
            return await asyncio.gather(
                *[srv.submit_inverse(p, **kw) for p in pyrs])

    for i, (s, d, im) in enumerate(zip(_run(run), direct, imgs)):
        if backend == "conv":
            np.testing.assert_allclose(s, d, **CROSS_TOL)
        else:
            assert np.array_equal(s, d), f"inverse request {i} diverged"
        np.testing.assert_allclose(s, im, **ROUNDTRIP_TOL)


def test_packet_and_volume_requests_serve_bit_identical(make_volume):
    """wpt2/iwpt2 and dwt3/idwt3 requests stack and scatter their trees
    (WaveletPacket2D, Pyramid3) exactly."""
    imgs = _images(3)
    vols = [make_volume(4, 16, 16, seed=s) for s in range(3)]
    kw = dict(backend="cuda", fuse="levels")

    async def run():
        async with DwtServer(_cfg(max_batch=4, max_wait_ms=5.0)) as srv:
            pks = await asyncio.gather(*[srv.submit_wpt2(
                im, packet="full:2", **kw) for im in imgs])
            ims = await asyncio.gather(*[srv.submit_iwpt2(pk, **kw)
                                         for pk in pks])
            p3s = await asyncio.gather(*[srv.submit_dwt3(
                v, levels=1, **kw) for v in vols])
            v3s = await asyncio.gather(*[srv.submit_idwt3(p, **kw)
                                         for p in p3s])
            return pks, ims, p3s, v3s

    pks, ims, p3s, v3s = _run(run)
    for im, pk, back in zip(imgs, pks, ims):
        want = R.wpt2(torch.from_numpy(im), packet="full:2", device="cpu",
                      **kw)
        assert tuple(pk.paths) == tuple(want.paths) and _pyr_equal(pk, want)
        assert np.array_equal(back, R.iwpt2(want, device="cpu",
                                            **kw).numpy())
    for v, p3, back in zip(vols, p3s, v3s):
        want = R.dwt3(torch.from_numpy(v), levels=1, device="cpu", **kw)
        assert _pyr_equal(p3, want)
        np.testing.assert_allclose(back, v, **ROUNDTRIP_TOL)


# -- bucketing ---------------------------------------------------------

def test_mixed_shape_requests_bucket_separately():
    """Different geometries (and configs) never share a batch — each
    bucket executes its own plan and every result stays exact."""
    shapes = [(16, 16), (32, 32), (32, 48)]
    rng = np.random.default_rng(7)
    reqs = [rng.standard_normal((h, w)).astype(np.float32)
            for h, w in shapes for _ in range(3)]
    kw = dict(wavelet="cdf97", scheme="ns-polyconv", levels=1,
              backend="torch", fuse="levels")
    direct = [_direct(x, **kw) for x in reqs]

    async def run():
        srv = DwtServer(_cfg(max_batch=4, max_wait_ms=5.0))
        async with srv:
            out = await asyncio.gather(*[srv.submit(x, **kw) for x in reqs])
            return out, srv.stats()

    served, st = _run(run)
    for i, (s, d) in enumerate(zip(served, direct)):
        assert s.ll.shape == tuple(d.ll.shape)
        assert _pyr_equal(s, d), f"mixed-shape request {i} diverged"
    assert st["buckets_seen"] == len(shapes)


def test_padded_batch_and_bucket_batches():
    assert [padded_batch(n, 16) for n in (1, 2, 3, 5, 9, 16, 40)] == \
        [1, 2, 4, 8, 16, 16, 16]
    assert bucket_batches(16) == [1, 2, 4, 8, 16]
    assert bucket_batches(6) == [1, 2, 4, 6]   # cap need not be a pow2
    assert bucket_batches(1) == [1]
    with pytest.raises(ValueError):
        padded_batch(0, 16)


def test_bucket_keys_carry_the_device_and_canonical_packets():
    a = BK.request_key((64, 64), np.float32, op="wpt2", wavelet="cdf97",
                       scheme="ns-polyconv", levels=1, backend="cuda",
                       optimize=False, fuse="levels", boundary="periodic",
                       compute_dtype="float32", tap_opt="full",
                       device="cpu", packet="full:2")
    b = BK.request_key((64, 64), "float32", op="wpt2", wavelet="cdf97",
                       scheme="ns-polyconv", levels=1, backend="cuda",
                       optimize=False, fuse="levels", boundary="periodic",
                       compute_dtype="float32", tap_opt="full",
                       device="cpu",
                       packet=R.PacketTree.from_spec("full:2"))
    assert a == b and a.levels == 2 and a.device == "cpu"
    assert a.plan_kwargs(4)["device"] == "cpu"
    assert BucketSpec(shape=(8, 8)).key("idwt2", "cpu").device == "cpu"


def test_stack_and_scatter_trees_round_trip():
    pyrs = [_direct(im, levels=2) for im in _images(3)]
    host = [BK.unflatten_tree(p, [t.numpy() for t in BK.flatten_tree(p)])
            for p in pyrs]
    n = BK.stacked_numel(host[0], 4)
    flat = np.full(n, np.nan, np.float32)
    stacked = BK.stack_trees(host, 4, out=flat)
    assert stacked.ll.shape == (4, 8, 8) and not np.isnan(flat).any()
    assert np.shares_memory(stacked.ll, flat)
    assert not stacked.ll[3].any()                 # zero padding
    for got, want in zip(BK.scatter_tree(stacked, 3), host):
        assert _pyr_equal(got, want)


def test_rejects_non_2d_requests():
    async def run():
        async with DwtServer(_cfg()) as srv:
            with pytest.raises(ValueError, match="single .H, W. images"):
                await srv.submit(np.zeros((2, 16, 16), np.float32))
    _run(run)


# -- backpressure ------------------------------------------------------

def test_backpressure_reject_raises_queue_full():
    imgs = _images(3, h=16, w=16)
    cfg = _cfg(max_batch=8, max_wait_ms=200.0, max_queue=2,
               backpressure="reject", num_workers=1)
    kw = dict(levels=1, backend="torch")

    async def run():
        async with DwtServer(cfg) as srv:
            # two requests park in the coalescing window...
            t0 = asyncio.ensure_future(srv.submit(imgs[0], **kw))
            t1 = asyncio.ensure_future(srv.submit(imgs[1], **kw))
            for _ in range(5):
                await asyncio.sleep(0)
            assert srv.stats()["pending"] == 2
            # ...so the third arrival exceeds max_queue and fails fast
            with pytest.raises(QueueFullError):
                await srv.submit(imgs[2], **kw)
            srv.flush()
            return await asyncio.gather(t0, t1)

    served = _run(run)
    for s, im in zip(served, imgs[:2]):
        assert _pyr_equal(s, _direct(im, **kw, fuse="levels"))
    st = serve_stats()
    assert st["rejected"] == 1
    assert st["served"] == 2


def test_backpressure_wait_parks_then_serves_everything():
    imgs = _images(6, h=16, w=16)
    cfg = _cfg(max_batch=2, max_wait_ms=1.0, max_queue=2,
               backpressure="wait", num_workers=1)
    kw = dict(levels=1, backend="torch")

    async def run():
        async with DwtServer(cfg) as srv:
            return await asyncio.gather(
                *[srv.submit(im, **kw) for im in imgs])

    for s, im in zip(_run(run), imgs):
        assert _pyr_equal(s, _direct(im, **kw, fuse="levels"))
    st = serve_stats()
    assert st["submitted"] == 6 and st["served"] == 6
    assert st["rejected"] == 0


# -- fault tolerance ---------------------------------------------------

def test_dead_worker_batch_redispatched_and_replaced():
    """Kill the only worker mid-claim: its in-flight batch must be
    re-dispatched and served (exactly) by the elastic replacement."""
    imgs = _images(4, h=16, w=16)
    kw = dict(levels=1, backend="cuda")

    async def run():
        srv = DwtServer(_cfg(max_batch=4, max_wait_ms=5.0, num_workers=1))
        async with srv:
            victim = srv.inject_worker_failure()
            out = await asyncio.gather(
                *[srv.submit(im, **kw) for im in imgs])
            return out, victim, srv.stats()

    served, victim, st = _run(run)
    for i, (s, im) in enumerate(zip(served, imgs)):
        assert _pyr_equal(s, _direct(im, **kw, fuse="levels")), \
            f"re-dispatched request {i} diverged"
    m = serve_stats()
    assert m["worker_deaths"] == 1
    assert m["redispatched"] == 4          # the whole in-flight batch
    assert m["workers_spawned"] == 1       # elastic replacement
    assert m["served"] == 4 and m["failed"] == 0
    assert victim in st["workers"]["dead"]
    assert st["workers"]["alive"]          # the replacement is beating


def test_redispatch_budget_exhaustion_fails_request():
    """With max_redispatch=0 a request dies with its worker — and the
    server itself survives to serve the next request."""
    img, img2 = _images(2, h=16, w=16)
    kw = dict(levels=1, backend="torch")

    async def run():
        srv = DwtServer(_cfg(max_batch=2, max_wait_ms=2.0, num_workers=1,
                             max_redispatch=0))
        async with srv:
            srv.inject_worker_failure()
            with pytest.raises(WorkerDied):
                await srv.submit(img, **kw)
            return await srv.submit(img2, **kw)

    assert _pyr_equal(_run(run), _direct(img2, **kw, fuse="levels"))
    m = serve_stats()
    assert m["failed"] == 1 and m["redispatched"] == 0
    assert m["worker_deaths"] == 1 and m["served"] == 1


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_tracker_register_and_mark_dead():
    """The serving extensions to HeartbeatTracker: immediate out-of-band
    death, revival on beat, and mid-run registration."""
    t = [0.0]
    tr = HeartbeatTracker(["w0"], FaultToleranceConfig(
        soft_timeout_s=10, hard_timeout_s=100), clock=lambda: t[0])
    tr.mark_dead("w0")
    assert tr.dead() == ["w0"]
    assert tr.stragglers() == []
    assert tr.should_restart_elastic()
    tr.register("w1")
    assert tr.dead() == ["w0"]
    tr.beat("w0", step=1)
    assert tr.dead() == []


def test_heartbeat_straggler_and_dead():
    clock = FakeClock()
    ft = FaultToleranceConfig(soft_timeout_s=10, hard_timeout_s=100,
                              quorum_fraction=0.5)
    tr = HeartbeatTracker(["h0", "h1", "h2", "h3"], ft, clock=clock)
    clock.t = 15.0
    for h in ("h0", "h1", "h2"):
        tr.beat(h, step=1)
    clock.t = 20.0   # h3 silent for 20s -> straggler; h0-2 fresh (5s)
    assert tr.stragglers() == ["h3"]
    assert tr.have_quorum()
    assert tr.should_skip_stragglers()
    assert not tr.should_restart_elastic()
    clock.t = 150.0
    tr.beat("h0", 2)
    tr.beat("h1", 2)
    assert "h3" in tr.dead()
    assert tr.should_restart_elastic()


def test_mark_dead_and_register_interact_with_quorum():
    clock = FakeClock()
    ft = FaultToleranceConfig(soft_timeout_s=10, hard_timeout_s=100,
                              quorum_fraction=0.75)
    tr = HeartbeatTracker(["h0", "h1", "h2", "h3"], ft, clock=clock)
    tr.mark_dead("h2")
    tr.mark_dead("h3")
    assert sorted(tr.dead()) == ["h2", "h3"]
    assert tr.should_restart_elastic()
    assert not tr.have_quorum()            # 2/4 alive < 0.75 * 4
    clock.t = 20.0
    for h in ("h0", "h1"):
        tr.beat(h, step=1)
    assert tr.stragglers() == []           # h2/h3 are dead, not straggling
    tr.register("h4")
    assert "h4" in tr.hosts and "h4" not in tr.dead()
    assert not tr.have_quorum()            # 3/5 alive < 0.75 * 5
    tr.beat("h3", step=2)                  # a beating host revives
    assert tr.dead() == ["h2"]
    assert tr.have_quorum()                # 4/5 alive >= 0.75 * 5


def test_beat_revives_marked_dead_host():
    clock = FakeClock()
    ft = FaultToleranceConfig(soft_timeout_s=10, hard_timeout_s=100,
                              quorum_fraction=0.5)
    tr = HeartbeatTracker(["h0", "h1"], ft, clock=clock)
    tr.mark_dead("h0")
    assert tr.dead() == ["h0"] and tr.should_restart_elastic()
    clock.t = 1.0
    tr.beat("h0", step=1)
    assert tr.dead() == [] and not tr.should_restart_elastic()
    tr.mark_dead("h0")
    assert tr.dead() == ["h0"]
    clock.t = 200.0
    tr.beat("h0", step=2)
    assert "h1" in tr.dead()
    assert tr.should_restart_elastic()


def test_all_workers_dead_no_quorum_restarts():
    clock = FakeClock()
    ft = FaultToleranceConfig(soft_timeout_s=10, hard_timeout_s=100,
                              quorum_fraction=0.5)
    tr = HeartbeatTracker(["h0", "h1"], ft, clock=clock)
    tr.mark_dead("h0")
    tr.mark_dead("h1")
    assert sorted(tr.dead()) == ["h0", "h1"]
    assert not tr.have_quorum()
    assert tr.should_restart_elastic()
    assert tr.stragglers() == []


def test_should_restart_elastic_edges():
    clock = FakeClock()
    ft = FaultToleranceConfig(soft_timeout_s=10, hard_timeout_s=100,
                              quorum_fraction=0.5)
    tr = HeartbeatTracker([], ft, clock=clock)
    assert not tr.should_restart_elastic()
    tr.register("h0")
    assert not tr.should_restart_elastic()
    clock.t = 99.0
    assert not tr.should_restart_elastic()
    clock.t = 101.0
    assert tr.should_restart_elastic()


# -- warmup / profiler integration ------------------------------------

def test_warmup_prefetches_plans_first_request_hits_cache():
    spec = BucketSpec(shape=(16, 16), levels=1, backend="cuda",
                      fuse="levels")
    srv = DwtServer(_cfg(max_batch=4))
    n = srv.warmup([spec])
    assert n == len(bucket_batches(4))     # every padded batch size
    misses_before = TE.plan_cache_stats()["misses"]
    imgs = _images(3, h=16, w=16)

    async def run():
        async with srv:
            return await asyncio.gather(*[
                srv.submit(im, levels=1, backend="cuda") for im in imgs])
    served = _run(run)
    assert TE.plan_cache_stats()["misses"] == misses_before, \
        "warmed bucket's first traffic must be a plan-cache hit"
    assert all(_pyr_equal(s, _direct(im, levels=1, backend="cuda",
                                     fuse="levels"))
               for s, im in zip(served, imgs))


def test_warmup_profiler_resolves_auto_from_store():
    """warm_profiler=True writes traces for every padded batch shape, so
    a backend="auto" bucket resolves from measurements (source="store")
    for every batch size served, and serves what a direct call at the
    resolved configuration computes."""
    from repro_torch.profiler import auto_stats
    spec = BucketSpec(shape=(16, 16), levels=1, backend="auto")
    srv = DwtServer(_cfg(max_batch=4))
    srv.warmup([spec], warm_profiler=True, reps=1,
               candidates=[("torch", "levels", "full"),
                           ("torch", "none", "full")])
    st = auto_stats()
    assert st["store_hits"] == len(bucket_batches(4))
    assert st["cold_fallbacks"] == 0
    resolved = [row["auto"] for row in TE.stats()["plans"]
                if row.get("auto")]
    assert resolved and all(r["source"] == "store" for r in resolved)
    assert all(r["backend"] == "torch" for r in resolved)

    misses_before = TE.plan_cache_stats()["misses"]
    imgs = _images(2, h=16, w=16)

    async def run():
        async with srv:
            out = await asyncio.gather(*[
                srv.submit(im, levels=1, backend="auto") for im in imgs])
            back = await asyncio.gather(*[
                srv.submit_inverse(p, backend="auto") for p in out])
            return out, back
    served, back = _run(run)
    assert TE.plan_cache_stats()["misses"] == misses_before
    assert auto_stats()["cold_fallbacks"] == 0
    # the batch of 2 ran the plan "auto" resolved for (2, 16, 16)
    pb = TE.get_plan(shape=(2, 16, 16), levels=1, backend="auto",
                     device="cpu")
    for s, b, im in zip(served, back, imgs):
        assert _pyr_equal(s, _direct(im, levels=1, backend=pb.key.backend,
                                     fuse=pb.key.fuse,
                                     tap_opt=pb.key.tap_opt))
        np.testing.assert_allclose(b, im, **ROUNDTRIP_TOL)


def test_warmup_builds_nothing_on_the_cpu_and_prepares_plans():
    """prepare() is a no-op off the card: warmup on a CPU server builds
    no kernel and uploads no table."""
    from repro_torch.kernels import pyramid_window as PW
    from repro_torch.kernels import tap_window as TW
    srv = DwtServer(_cfg(max_batch=2))
    srv.warmup([BucketSpec(shape=(16, 16), levels=2, backend="cuda",
                           fuse="pyramid")])
    plan = TE.get_plan(shape=(2, 16, 16), levels=2, backend="cuda",
                       fuse="pyramid", device="cpu")
    assert plan.pyramid is not None
    assert plan.pyramid.fwd_kernel._tables == {}
    assert TW.LIBRARY._lib is None and PW.LIBRARY._lib is None


# -- float64, devices ---------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "conv"])
def test_float64_is_served_as_dwt2_serves_it(backend):
    im = np.random.default_rng(5).standard_normal((16, 16))
    kw = dict(levels=1, backend=backend, fuse="levels")

    async def run():
        async with DwtServer(_cfg(max_wait_ms=1.0)) as srv:
            return await srv.submit(im, **kw)
    out = _run(run)
    want = _direct(im, **kw)
    assert out.ll.dtype == np.float64 and want.ll.dtype == torch.float64
    _pyr_close(out, want, CROSS_TOL)


def test_float64_on_cuda_fails_the_batch_naming_the_dtype():
    im = np.zeros((16, 16))

    async def run():
        async with DwtServer(_cfg(max_wait_ms=1.0)) as srv:
            with pytest.raises(TE.BackendError, match="PlanKey.dtype"):
                await srv.submit(im, levels=1, backend="cuda")
            # auto never resolves float64 to "cuda"
            return await srv.submit(im, levels=1, backend="auto")
    out = _run(run)
    assert out.ll.dtype == np.float64
    assert serve_stats()["failed"] == 1


def test_a_cuda_server_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    srv = DwtServer(ServeConfig())
    assert srv.cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.warmup([BucketSpec(shape=(16, 16))])

    async def run():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await srv.start()
        assert not srv.stats()["running"]
    _run(run)


# -- observability / front doors --------------------------------------

def test_engine_stats_has_serve_section():
    imgs = _images(2, h=16, w=16)
    pyrs = serve_map(imgs, config=_cfg(max_batch=2), levels=1,
                     backend="torch")
    assert all(_pyr_equal(p, _direct(im, levels=1, backend="torch",
                                     fuse="levels"))
               for p, im in zip(pyrs, imgs))
    s = TE.stats()["serve"]
    assert s["served"] == 2
    assert s["batches"] >= 1
    assert s["p50_ms"] is not None and s["p99_ms"] >= s["p50_ms"]
    assert s["img_per_s"] is None or s["img_per_s"] > 0
    assert 0.0 < s["mean_occupancy"] <= 1.0


def test_serve_series_names_are_the_reference_s():
    from repro.serve import metrics as JSM
    mine = {m.name for m in SM.ServeMetrics._METRICS}
    theirs = {m.name for m in JSM.ServeMetrics._METRICS}
    assert mine == theirs
    assert sorted(SM.serve_stats()) == sorted(JSM.serve_stats())


def test_serve_config_validation():
    with pytest.raises(ValueError, match="backpressure"):
        ServeConfig(backpressure="drop")
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(RuntimeError, match="not running"):
        _run(lambda: DwtServer(_cfg()).submit(np.zeros((8, 8), np.float32)))


# -- resilience: deadlines, breaker, quarantine, worker exceptions ----

def test_worker_exception_after_execution_fails_not_hangs(monkeypatch):
    """An exception raised *between* batch execution and future
    resolution (a metrics hook blowing up) fails the batch's requests
    promptly with the real exception, and the pool heals."""
    from repro_torch.serve import scheduler as SCH
    real = SCH.METRICS.batch_done
    armed = {"on": True}

    def exploding(*a, **kw):
        if armed["on"]:
            armed["on"] = False
            raise RuntimeError("metrics hook exploded")
        return real(*a, **kw)

    monkeypatch.setattr(SCH.METRICS, "batch_done", exploding)
    imgs = _images(2)
    kw = dict(levels=1, backend="torch", fuse="none")

    async def run():
        cfg = _cfg(max_batch=4, max_wait_ms=1.0, request_deadline_ms=3000.0)
        async with DwtServer(cfg) as srv:
            with pytest.raises(RuntimeError, match="metrics hook"):
                await srv.submit(imgs[0], **kw)
            return await srv.submit(imgs[1], **kw)

    assert _pyr_equal(_run(run), _direct(imgs[1], **kw))
    assert serve_stats()["deadline_exceeded"] == 0


def test_request_deadline_cuts_hung_batch():
    from repro_torch.faults.policy import DeadlineExceeded
    PFJ.activate(PFP.FaultPlan.from_text("serve.batch=hang:always:0.6"))

    async def run():
        cfg = _cfg(max_wait_ms=1.0, request_deadline_ms=150.0)
        async with DwtServer(cfg) as srv:
            with pytest.raises(DeadlineExceeded, match="150 ms"):
                await srv.submit(_images(1)[0], levels=1, backend="torch",
                                 fuse="none")
    try:
        _run(run)
    finally:
        PFJ.activate(None)
    assert serve_stats()["deadline_exceeded"] == 1


def test_circuit_breaker_opens_per_bucket():
    from repro_torch.faults.policy import CircuitOpenError
    PFJ.activate(PFP.FaultPlan.from_text("serve.batch=always"))

    async def run():
        cfg = _cfg(max_batch=1, max_wait_ms=0.5, breaker_threshold=2,
                   breaker_cooldown_s=60.0)
        kw = dict(levels=1, backend="torch", fuse="none")
        img = _images(1)[0]
        async with DwtServer(cfg) as srv:
            for _ in range(2):
                with pytest.raises(PFJ.InjectedFault):
                    await srv.submit(img, **kw)
            with pytest.raises(CircuitOpenError, match="circuit open"):
                await srv.submit(img, **kw)
    try:
        _run(run)
    finally:
        PFJ.activate(None)
    assert serve_stats()["breaker_rejections"] >= 1


def test_poison_batch_quarantine_isolates_requests():
    """A batch that has already killed a worker kills another:
    survivors within budget re-dispatch as singleton batches and
    over-budget requests drop with WorkerDied."""
    async def run():
        loop = asyncio.get_running_loop()
        srv = DwtServer(_cfg())                 # not started: no live
        srv._loop = loop                        # workers to steal the
        srv._batch_q = asyncio.Queue()          # re-queued batches
        srv.tracker = HeartbeatTracker(
            [], FaultToleranceConfig(soft_timeout_s=1.0,
                                     hard_timeout_s=2.0,
                                     quorum_fraction=0.5),
            clock=lambda: 0.0)
        srv.tracker.register("w0")
        key = BK.BucketKey(op="dwt2", h=32, w=32, dtype="float32",
                           wavelet="cdf97", scheme="ns-polyconv",
                           levels=1, backend="torch", optimize=False,
                           fuse="none", boundary="periodic",
                           compute_dtype="float32", tap_opt="full",
                           device="cpu")
        reqs = [BK.Request(payload=i, future=loop.create_future(),
                           t=0.0, attempts=a)
                for i, a in enumerate([1, 1, 2])]
        srv._in_flight["w0"] = (key, reqs)
        srv._on_worker_death("w0", "poison test")
        assert isinstance(reqs[2].future.exception(), WorkerDied)
        batches = [srv._batch_q.get_nowait()
                   for _ in range(srv._batch_q.qsize())]
        assert [len(rs) for _, rs in batches] == [1, 1]   # singletons
        assert all(k == key for k, _ in batches)

    _run(run)
    assert serve_stats()["quarantined"] == 2


def test_serve_validate_nan_rejects_at_submit():
    img = _images(1)[0]
    bad = img.copy()
    bad[0, 0] = np.nan
    kw = dict(levels=1, backend="torch", fuse="none")

    async def run():
        async with DwtServer(_cfg(validate="nan", max_wait_ms=1.0)) as srv:
            with pytest.raises(ValueError, match="non-finite"):
                await srv.submit(bad, **kw)
            pyr = await srv.submit(img, **kw)   # clean input still flows
            bad_ll = np.asarray(pyr.ll).copy()
            bad_ll[0, 0] = np.inf
            with pytest.raises(ValueError, match="non-finite"):
                await srv.submit_inverse(
                    R.Pyramid(ll=bad_ll, details=pyr.details),
                    backend="torch", fuse="none")
            return pyr

    assert _pyr_equal(_run(run), _direct(img, **kw))
    with pytest.raises(ValueError, match="validate"):
        ServeConfig(validate="bogus")


def test_requests_may_be_tensors():
    im = _images(1)[0]

    async def run():
        async with DwtServer(_cfg(max_wait_ms=1.0)) as srv:
            return await srv.submit(torch.from_numpy(im), levels=1,
                                    backend="torch")
    assert _pyr_equal(_run(run), _direct(im, levels=1, backend="torch",
                                        fuse="levels"))


def test_stack_h2d_fault_fails_one_batch_and_the_next_serves():
    PFJ.activate(PFP.FaultPlan.from_text("serve.stack_h2d=once"))
    img = _images(1)[0]
    kw = dict(levels=1, backend="cuda", fuse="levels")

    async def run():
        async with DwtServer(_cfg(max_batch=1, max_wait_ms=0.5)) as srv:
            with pytest.raises(PFJ.InjectedFault):
                await srv.submit(img, **kw)
            return await srv.submit(img, **kw)
    try:
        out = _run(run)
    finally:
        PFJ.activate(None)
    assert _pyr_equal(out, _direct(img, **kw))
    assert serve_stats()["failed"] == 1


def test_spans_of_a_served_batch():
    """In spans mode a batch leaves serve.batch, serve.stack_h2d,
    serve.execute and serve.scatter spans, the engine's execute span
    inside serve.execute."""
    T.set_mode("spans")
    try:
        serve_map(_images(2), config=_cfg(max_batch=2), levels=1,
                  backend="cuda", fuse="levels")
        names = [r.name for r in T.TRACER.records()]
    finally:
        T.set_mode("counters")
    for n in ("serve.batch", "serve.stack_h2d", "serve.execute",
              "serve.scatter", "serve.enqueue", "execute.forward"):
        assert n in names, n
    recs = {r.name: r for r in T.TRACER.records()}
    assert recs["execute.forward"].parent_id == \
        recs["serve.execute"].span_id
