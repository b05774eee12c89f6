"""The port's multi-device train steps on CPU processes: the podwise step
on 2 gloo ranks (``pod=2``) and the sharded ``train_step`` on 4
(``data=2, model=2`` and ``data=1, model=4``), each against a
computation on one process.

The reference's own sharded and podwise steps fail in its CPU test
(``tests/test_distributed.py``), so they are no parity target; the port
is held against its own single-device ``train_step`` and against the
podwise step's arithmetic spelled out by hand.  Each test writes a script to ``tmp_path`` that
spawns its ranks (``torch.multiprocessing.spawn``, ``file://``
rendezvous) and runs it in a subprocess, so no process group outlives
it.  Rank 0 computes the single-process side and writes the verdicts.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_COMMON = """
import dataclasses, json, os, sys, warnings
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
warnings.filterwarnings("ignore")


def setup(rank, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "rendezvous"), rank=rank, world_size=world)


def config(arch, compression):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_pipeline
    cfg, run = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype="float32")
    run = dataclasses.replace(run, grad_compression=compression,
                              grad_accum=1, warmup_steps=2)
    shape = ShapeConfig("s", "train", 32, 8)
    batch = {k: torch.from_numpy(v) for k, v in
             make_pipeline(cfg, seed=0).batch_at(0, shape).items()}
    return cfg, run, batch
"""

_PODWISE = _COMMON + """

def hand(state, batch, cfg, run, steps):
    # the podwise step spelled out on one process: each pod's half-batch
    # gradients, each pod's compressed slice, (a + b) / 2, decompress,
    # AdamW; rank 0's error feedback kept
    from repro_torch import pytree
    from repro_torch.core import compression as CMP
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as ST
    levels = ST.compression_levels(run)
    halves = [{k: v[:4] for k, v in batch.items()},
              {k: v[4:] for k, v in batch.items()}]
    params, opt = state.params, state.opt
    efbs = [state.efb, state.efb]
    losses = []
    for step in range(steps):
        phase = step % CMP.n_phases(levels)
        gs, ms = zip(*[ST.grads_and_metrics(params, h, cfg, run)
                       for h in halves])
        g_hat, new_efbs = [], [[], []]
        for leaves in zip(*[pytree.leaves(g) for g in gs],
                          *[pytree.leaves(e) for e in efbs]):
            g, e = leaves[:2], leaves[2:]
            acc = [e_ + g_.float() for g_, e_ in zip(g, e)]
            c = [CMP.compress(a, phase, levels) for a in acc]
            mean = (c[0] + c[1]) / 2
            gh = CMP.decompress(mean, phase, g[0].shape, levels)
            g_hat.append(gh.to(g[0].dtype))
            for r in range(2):
                new_efbs[r].append(acc[r] - gh)
        grads = pytree.unflatten(gs[0], g_hat)
        efbs = [pytree.unflatten(gs[0], e) for e in new_efbs]
        params, opt, _ = adamw.apply(grads, opt, params, run)
        losses.append(float((ms[0]["loss"] + ms[1]["loss"]) / 2))
    return params, efbs[0], losses


def run(rank, world, out):
    setup(rank, world, out)
    try:
        from repro_torch import pytree
        from repro_torch.core import compression as CMP
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.runtime import steps as ST
        cfg, run_, batch = config("minitron-8b", "dwt:1")
        mesh = make_debug_mesh(1, 1, multi_pod=True, device_type="cpu")
        state = ST.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    run_, device="cpu")
        shd = SH.make_state_shardings(mesh, state, cfg, run_)
        placed = ST.TrainState(SH.distribute_tree(state.params, shd.params),
                               SH.distribute_tree(state.opt, shd.opt),
                               state.efb, state.step)
        step = ST.make_train_step_podwise(mesh, cfg, run_)
        ST.POD_REDUCE.zero()
        losses = []
        with SH.use_mesh(mesh):
            for _ in range(2):
                placed, m = step(placed, batch)
                losses.append(float(m["loss"]))
        slices = sum(CMP.tile_shape(p.numel(), 1)[0] * CMP.WIDTH * 4
                     // CMP.n_phases(1)
                     for p in pytree.leaves(state.params))
        if rank == 0:
            params, efb, want = hand(state, batch, cfg, run_, 2)
            same = lambda a, b: all(
                torch.equal(SH.to_global(x), y)
                for x, y in zip(pytree.leaves(a), pytree.leaves(b)))
            json.dump({"losses": losses, "hand_losses": want,
                       "params_equal": same(placed.params, params),
                       "efb_equal": same(placed.efb, efb),
                       "pod_bytes": ST.POD_REDUCE.bytes,
                       "pod_calls": ST.POD_REDUCE.calls,
                       "slice_bytes": 2 * slices,
                       "leaves": len(pytree.leaves(state.params))},
                      open(os.path.join(out, "result.json"), "w"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(2, sys.argv[1]), nprocs=2)
"""

_SHARDED = _COMMON + """

def compare(placed, ref, pytree, SH):
    worst = {}
    full = [SH.to_global(t) for t in pytree.leaves(placed)]
    for (path, r), got in zip(pytree.leaves_with_path(ref), full):
        group = path[0][1] if path[0][1] != "opt" else path[1][1]
        scale = max(float(r.float().abs().max()), 1e-30)
        diff = float((got.float() - r.float()).abs().max())
        worst[group] = max(worst.get(group, 0.0), diff / scale)
        worst[group + "_abs"] = max(worst.get(group + "_abs", 0.0), diff)
    return worst


def run(rank, world, out):
    setup(rank, world, out)
    try:
        from repro_torch import pytree
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.runtime import steps as ST
        cfg, run_, batch = config("minitron-8b", "dwt:1")
        state = ST.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    run_, device="cpu")
        ref, want = state, []
        for _ in range(2):
            ref, m = ST.train_step(ref, batch, cfg, run_)
            want.append(float(m["loss"]))
        result = {"ref_losses": want, "lr": float(m["lr"])}
        # (2, 2): the q heads and the 2 kv heads both split; (1, 4): the
        # 4 q heads split where the 2 kv groups do not (per-head path)
        for dims in ((2, 2), (1, 4)):
            mesh = make_debug_mesh(*dims, device_type="cpu")
            placed = SH.distribute_tree(
                state, SH.make_state_shardings(mesh, state, cfg, run_))
            b = SH.distribute_tree(batch,
                                   SH.make_batch_shardings(mesh, batch))
            losses = []
            with SH.use_mesh(mesh):
                for _ in range(2):
                    placed, m = ST.train_step(placed, b, cfg, run_)
                    losses.append(float(m["loss"]))
            result["x".join(map(str, dims))] = {
                "losses": losses, "worst": compare(placed, ref, pytree, SH),
                "placements": sorted({str(t.placements) for t in
                                      pytree.leaves(placed.params)})}
        if rank == 0:
            json.dump(result, open(os.path.join(out, "result.json"), "w"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(4, sys.argv[1]), nprocs=4)
"""

# the sharded step sums in other orders than one device (partial sums
# over the model axis, the norm over shards): after two steps each leaf
# of mu, nu and the error feedback is within this fraction of the leaf's
# largest value, and each parameter within one learning rate (AdamW's
# normalised update turns a rounding difference in a near-zero gradient
# into up to a whole step; tests/test_torch_family_steps.py bounds
# parameters the same way)
SHARDED_LEAF_RTOL = 1e-4
SHARDED_LOSS_RTOL = 1e-6


def _spawn(tmp_path, script):
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(script))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, str(path), str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads((tmp_path / "result.json").read_text())


def test_podwise_step_on_two_pods_equals_the_hand_computation(tmp_path):
    """Two gloo ranks, one per pod, minitron SMOKE at float32, dwt:1, the
    same batch twice: the losses, every parameter and rank 0's error
    feedback equal the hand computation bit for bit; the all-reduce
    carried the 4^-1 slices alone (one per leaf per step); the loss
    drops."""
    res = _spawn(tmp_path, _PODWISE)
    assert res["losses"] == res["hand_losses"]
    assert res["params_equal"] and res["efb_equal"]
    assert res["pod_bytes"] == res["slice_bytes"]
    assert res["pod_calls"] == 2 * res["leaves"]
    assert res["losses"][1] < res["losses"][0]


def test_sharded_step_on_2x2_and_1x4_meshes_matches_one_device(tmp_path):
    """Four gloo ranks as (data=2, model=2) and as (data=1, model=4),
    minitron SMOKE at float32, dwt:1: two sharded steps on the same
    batch against the single-device ``train_step`` (bounds above); the
    state's leaves really are sharded, the loss drops."""
    res = _spawn(tmp_path, _SHARDED)
    for mesh in ("2x2", "1x4"):
        got = res[mesh]
        for a, b in zip(got["losses"], res["ref_losses"]):
            assert abs(a - b) <= SHARDED_LOSS_RTOL * abs(b), mesh
        for group in ("mu", "nu", "efb"):
            assert got["worst"][group] <= SHARDED_LEAF_RTOL, (mesh, group)
        assert got["worst"]["params_abs"] <= res["lr"], mesh
        assert got["worst"]["step"] == got["worst"]["count"] == 0.0
        assert any("Shard" in p for p in got["placements"]), mesh
        assert got["losses"][1] < got["losses"][0], mesh
