"""The port's launch tooling: meta-device specs against the reference's
``jax.eval_shape`` specs, the FLOP and collective counters
(``repro_torch.launch.analysis``) on the reference's own analytic
programs (``tests/test_distributed.py``), and one SMOKE dry-run cell
through the CLI.

The counters run in this process under a fake process group (destroyed
after each test: xdist reuses the worker); the dry run starts its own
fake group, so it runs in a subprocess.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import registry as RR
from repro.configs.base import ALL_SHAPES as R_SHAPES
from repro.launch import specs as RSPEC

from repro_torch import pytree
from repro_torch.configs import registry as PR
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.launch import analysis as A
from repro_torch.launch import specs as SPEC

ROOT = Path(__file__).resolve().parents[1]


def _shapes(tree, leaves):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves(tree)]


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_input_specs_equal_reference(arch):
    """Every shape cell's inputs (TrainState and batch, params and batch,
    or params, cache and tokens): the same leaves, shapes and dtypes as
    the reference's ``jax.eval_shape`` stand-ins, on ``meta``."""
    rcfg, rrun = RR.get_config(arch)
    pcfg, prun = PR.get_config(arch)
    for rshape, pshape in zip(R_SHAPES, ALL_SHAPES):
        if RR.shape_applicability(arch, rshape):
            continue
        want = _shapes(RSPEC.input_specs(rcfg, rrun, rshape),
                       jax.tree_util.tree_leaves)
        got_tree = SPEC.input_specs(pcfg, prun, pshape)
        assert _shapes(got_tree, pytree.leaves) == want, rshape.name
        assert all(t.device.type == "meta" or t.dim() == 0
                   for t in pytree.leaves(got_tree))


@pytest.fixture
def fake_group():
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    try:
        yield start
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_flop_count_exact_on_known_program(fake_group):
    """The reference's scanned program (L=7, B=64, D=256; x over data,
    the weights' output dim over model, a 2x4 mesh): the FLOPs each rank
    runs are L * 2 * B * D * D / 8 (the reference's bound, 0.95-1.1).
    Counted per device: ops on DTensors are counted as the local ops
    DTensor runs, its shape inference (on fake tensors) skipped."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    fake_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    L, B, D = 7, 64, 256
    for device in ("cpu", "meta"):
        x = DTensor.from_local(torch.randn(B // 2, D, device=device), mesh,
                               [Shard(0), Replicate()], run_check=False)
        ws = DTensor.from_local(torch.randn(L, D, D // 4, device=device),
                                mesh, [Replicate(), Shard(2)],
                                run_check=False)

        def f(x, ws):
            h = x
            for w in ws.unbind(0):
                h = torch.tanh(h @ w)
            return (h.float() ** 2).sum()

        _, cost = A.count_costs(f, x, ws)
        ratio = cost.flops / (L * 2 * B * D * D / 8)
        assert 0.95 < ratio < 1.1, (device, ratio)
        assert cost.bytes_major > 0 and cost.bytes_accessed >= \
            cost.bytes_major


def test_collective_count_on_known_program(fake_group):
    """The gradient of relu(x @ w).sum() with x's columns and w's rows
    over an 8-way model axis (the reference's program): more than 0
    collectives and wire bytes, none across pods (there are none)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    fake_group(8)
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
    x = DTensor.from_local(torch.randn(64, 64, requires_grad=True), mesh,
                           [Shard(1)], run_check=False)
    w = DTensor.from_local(torch.randn(64, 512), mesh, [Shard(0)],
                           run_check=False)

    def grad(x, w):
        return torch.autograd.grad(torch.relu(x @ w).sum(), x)

    _, st = A.count_collectives(grad, x, w, mesh=mesh)
    assert sum(st.counts.values()) > 0 and st.total_wire_bytes > 0
    assert st.wire_bytes_pod_crossing == 0
    assert st.total_wire_bytes == st.wire_bytes_intra_pod


def test_smoke_dryrun_cell_through_the_cli(tmp_path):
    """``python -m repro_torch.launch.dryrun --smoke``: qwen2's SMOKE
    train cell on a 2x2 mesh of a fake group is OK, with the reference's
    fields on the H100's constants."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "train_4k", "--mesh", "single", "--smoke",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "[dryrun] qwen2-0.5b__train_4k__single: OK" in out.stdout
    res = json.loads((tmp_path / "qwen2-0.5b__train_4k__single.json")
                     .read_text())
    assert res["status"] == "OK" and res["mesh"] == "2x2" and res["smoke"]
    mem = res["memory"]
    assert mem["argument_bytes"] > 0
    assert mem["peak_device_bytes"] is None or \
        mem["peak_device_bytes"] >= mem["argument_bytes"]
    assert "fits_80GB" in mem and "fits_16GB" not in mem
    assert res["cost"]["flops_per_device"] > 0
    assert res["collectives"]["total_wire_bytes"] > 0
    assert set(res["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert res["dominant"] in res["roofline"]
    assert res["model_flops"] > 0 and res["constants"]["peak_flops"] == 989e12
