"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's, and their DTensor placements.

The rule functions read only a mesh's axis names and sizes, so both
packages run in this process on the same stub mesh (``axis_names`` and
``devices``), at every arch's full width: the reference's trees come from
``jax.eval_shape``, the port's from ``device="meta"``.  The reference's
``NamedSharding`` needs a real mesh, so it is replaced, for these tests,
by a holder of its spec.  Placements and the resharding restore run under
a fake process group in this process (destroyed after each test); rank r
of a fake group holds rank r's shards, so every block is checked.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import registry as RR
from repro.configs.base import ALL_SHAPES as R_SHAPES
from repro.distributed import sharding as RSH
from repro.launch import specs as RSPEC

from repro_torch import pytree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry as PR
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SPEC
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh


class StubMesh:
    """What the rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = (StubMesh(("data", "model"), (16, 16)),
          StubMesh(("pod", "data", "model"), (2, 16, 16)),
          StubMesh(("data", "model"), (2, 4)),
          StubMesh(("pod", "data", "model"), (2, 2, 2)))


class _Spec:
    """Stands in for the reference's NamedSharding (stub meshes)."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref_specs(monkeypatch):
    monkeypatch.setattr(RSH, "NamedSharding", _Spec)


def _variants(arch, run):
    """The run variants each arch is held under."""
    out = [run, dataclasses.replace(run, zero=2),
           dataclasses.replace(run, attn_tp=not run.attn_tp),
           dataclasses.replace(run, grad_compression="dwt:2")]
    if arch in ("mixtral-8x7b", "dbrx-132b"):
        out.append(dataclasses.replace(run, expert_parallel=True))
    return out


def _specs(tree_of_shardings, flatten):
    return [tuple(s.spec) for s in flatten(tree_of_shardings)]


def _port_run(run):
    from repro_torch.configs.base import RunConfig
    return RunConfig(**dataclasses.asdict(run))


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_state_shardings_equal_reference(arch, ref_specs):
    """``make_state_shardings`` (``param_spec`` on every leaf of params,
    ``mu``, ``nu`` and the error feedback) on four meshes and every run
    variant: the same spec per leaf, in the same leaf order."""
    rcfg, rrun = RR.get_config(arch)
    pcfg, _ = PR.get_config(arch)
    trees = {}      # the state's shapes depend on the run only by its efb
    for run in _variants(arch, rrun):
        key = run.grad_compression
        if key not in trees:
            trees[key] = (RSPEC.state_specs(rcfg, run),
                          SPEC.state_specs(pcfg, _port_run(run)))
        rstate, pstate = trees[key]
        for mesh in MESHES:
            want = _specs(RSH.make_state_shardings(mesh, rstate, rcfg, run),
                          jax.tree_util.tree_leaves)
            got = _specs(SH.make_state_shardings(mesh, pstate, pcfg,
                                                 _port_run(run)),
                         pytree.leaves)
            assert got == want, (arch, mesh.devices.shape, run)


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_batch_and_cache_shardings_equal_reference(arch, ref_specs):
    """``make_batch_shardings`` for every shape's batch and
    ``make_cache_shardings`` for every decode shape's cache, attn_tp on
    and off."""
    rcfg, rrun = RR.get_config(arch)
    pcfg, _ = PR.get_config(arch)
    for rshape, pshape in zip(R_SHAPES, ALL_SHAPES):
        rb, pb = RSPEC.batch_specs(rcfg, rshape), SPEC.batch_specs(pcfg,
                                                                   pshape)
        for mesh in MESHES:
            assert (_specs(SH.make_batch_shardings(mesh, pb), pytree.leaves)
                    == _specs(RSH.make_batch_shardings(mesh, rb),
                              jax.tree_util.tree_leaves))
        if rshape.kind != "decode" or RR.shape_applicability(arch, rshape):
            continue
        rc, pc = RSPEC.cache_specs(rcfg, rshape), SPEC.cache_specs(pcfg,
                                                                   pshape)
        assert ([tuple(x.shape) for x in jax.tree_util.tree_leaves(rc)]
                == [tuple(x.shape) for x in pytree.leaves(pc)])
        for run in (rrun, dataclasses.replace(rrun,
                                              attn_tp=not rrun.attn_tp)):
            for mesh in MESHES:
                want = _specs(RSH.make_cache_shardings(mesh, rc, rcfg, run),
                              jax.tree_util.tree_leaves)
                got = _specs(SH.make_cache_shardings(mesh, pc, pcfg,
                                                     _port_run(run)),
                             pytree.leaves)
                assert got == want, (arch, rshape.name, mesh.devices.shape)


def test_param_spec_examples():
    """A few specs spelled out (the reference's own examples)."""
    cfg, run = PR.get_config("mixtral-8x7b")
    mesh = MESHES[1]
    assert SH.param_spec("blocks/moe/gate", (32, 8, 4096, 14336), cfg, run,
                         mesh) == SH.P(None, None, "data", "model")
    assert SH.param_spec("blocks/ln1", (32, 4096), cfg, run, mesh) == SH.P()
    assert SH.batch_axes(mesh, 256) == ("pod", "data")
    assert SH.batch_axes(mesh, 16) == "data"
    assert SH.batch_axes(mesh, 3) is None


@pytest.fixture
def fake_group():
    """A fake process group of ``world`` ranks as rank ``rank``; always
    destroyed (the xdist worker process runs other tests after)."""
    def start(world, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    try:
        yield start
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _chunk(n, k, i):
    """Rank i's part of n split in k as ``torch.chunk`` splits it."""
    size = -(-n // k)
    return max(0, min(size, n - i * size))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi4-mini-3.8b"])
def test_placements_give_chunk_local_shapes(arch, fake_group):
    """Every leaf of the full-width state placed on the 2x16x16 mesh of a
    fake 512-rank group: rank 0's local shape is ``ceil(n / axes)`` on
    each sharded dim (nested for two mesh dims on one tensor dim), the
    heads included where ``model`` does not divide them."""
    fake_group(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    cfg, run = PR.get_config(arch)
    state = SPEC.state_specs(cfg, run)
    shd = SH.make_state_shardings(mesh, state, cfg, run)
    placed = SH.distribute_tree(state, shd)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for t, sh in zip(pytree.leaves(placed), pytree.leaves(shd)):
        if t.dim() == 0:
            assert not SH.is_dtensor(t)     # host counters stay plain
            continue
        want = list(t.shape)
        for d, entry in enumerate(sh.spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                want[d] = _chunk(want[d], sizes[a], 0)
        assert list(t.to_local().shape) == want, (sh.spec, t.shape)
    assert SH.placements(SH.P(("pod", "data"), None, "model"), mesh) == (
        SH.placements(SH.P("pod"), mesh)[0],) + SH.placements(
        SH.P("data", None, "model"), mesh)[1:]
    with pytest.raises(ValueError, match="does not have"):
        SH.placements(SH.P("expert"), mesh)


def test_uneven_heads_shard_like_gspmd_padding(fake_group):
    """qwen2's 14 and phi4's 24 q heads on a 16-way model axis: rank 0
    holds ceil(n/16) heads, one and two, as GSPMD's padded shape."""
    fake_group(256)
    mesh = make_production_mesh(device_type="cpu")
    for heads, want in ((14, 1), (24, 2)):
        t = SH.distribute(torch.empty((896, heads, 64), device="meta"),
                          SH.NamedSharding(mesh, SH.P(None, "model", None)))
        assert t.to_local().shape == (896, want, 64)


def test_restore_reshards_onto_a_2x4_mesh(tmp_path, fake_group):
    """A checkpoint saved unsharded restores onto a (data=2, model=4)
    mesh: each rank's local shard is its block of the saved array (the
    reference's ``test_distributed.py`` elastic restart)."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(8, dtype=torch.float32)}
    Checkpointer(str(tmp_path)).save(3, tree)
    for rank in range(8):
        fake_group(8, rank)
        mesh = make_debug_mesh(2, 4, device_type="cpu")
        shardings = {"w": SH.NamedSharding(mesh, SH.P("data", "model")),
                     "b": None}
        restored, step = Checkpointer(str(tmp_path)).restore(
            {"w": torch.zeros(8, 8), "b": torch.zeros(8)},
            shardings=shardings)
        assert step == 3
        w = restored["w"]
        assert SH.is_dtensor(w) and not SH.is_dtensor(restored["b"])
        assert tuple(w.placements) == SH.placements(SH.P("data", "model"),
                                                    mesh)
        i, j = divmod(rank, 4)
        assert torch.equal(w.to_local(), tree["w"][4 * i:4 * i + 4,
                                                   2 * j:2 * j + 2])
        assert torch.equal(restored["b"], tree["b"])


def test_mesh_builders_check_the_group(fake_group):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_debug_mesh(2, 2, device_type="cpu")
    fake_group(4)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_debug_mesh(2, 4, device_type="cpu")
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")


def test_shard_batch_outside_a_mesh_and_on_plain_tensors(fake_group):
    """``shard_batch`` leaves a tensor as it is outside ``use_mesh`` and
    for a plain tensor; inside, a DTensor's batch dim goes over data
    (and dim 1 over model under SEQ_PARALLEL)."""
    from repro_torch.models import common as C
    x = torch.ones(4, 8, 2)
    assert C.shard_batch(x) is x
    fake_group(4)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    with SH.use_mesh(mesh):
        assert C.shard_batch(x) is x
        d = SH.distribute(x, SH.NamedSharding(mesh, SH.P()))
        y = C.shard_batch(d)
        assert tuple(y.placements) == SH.placements(SH.P("data"), mesh)
        old, C.SEQ_PARALLEL = C.SEQ_PARALLEL, True
        try:
            z = C.shard_batch(d)
        finally:
            C.SEQ_PARALLEL = old
        assert tuple(z.placements) == SH.placements(SH.P("data", "model"),
                                                    mesh)
    assert SH.current_mesh() is None
    assert math.prod(mesh.shape) == 4
