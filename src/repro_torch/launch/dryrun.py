"""Multi-pod dry run: the port's copy of ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell this runs the real
step function — the sharded ``train_step`` (or, with ``--podwise``, the
podwise step), ``prefill_step`` or ``decode_step`` — on ``meta`` DTensors
placed by the sharding rules on the production mesh, 16x16 single-pod
and 2x16x16 multi-pod, inside a *fake* process group of 256 or 512
ranks: nothing is allocated and no card is needed, as the reference
lowers without devices.  It records per device:

* the argument bytes, exact, from the local shard shapes;
* the peak, where ``torch.distributed._tools.mem_tracker`` can measure
  it on ``meta`` tensors (else ``null`` with the reason);
* FLOPs and bytes of the ops each rank runs, and the collectives it
  issues with their wire bytes, intra-pod and pod-crossing
  (:mod:`repro_torch.launch.analysis`);
* the three roofline terms on the H100's constants, and ``model_flops``.

Each cell is one JSON file, ``<out>/<arch>__<shape>__<mesh><tag>.json``,
with the reference's fields (``fits_80GB`` for its ``fits_16GB``).  A cell
that raises is ``FAIL``; the command exits non-zero if any cell asked for
failed.  ``--smoke`` runs the SMOKE configs on a 2x2 (2x2x2) mesh at
seq 32, batch 8, in seconds.  ``--args-only`` records the argument
bytes alone, for a cell whose step on ``meta`` takes too long to run on
a host (dbrx-132b's train step: 16 microbatches of 40 MoE layers; the
sharded step on the 2x16x16 mesh, where DTensor's redistribution
planner searches its 3-D placements for minutes).

The counts depend on the installed torch's DTensor (its strategy per
op): the same cell counts other collectives under torch 2.11 and 2.13.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path

# NVIDIA H100 SXM, from NVIDIA's data sheet (the hopper-kernels guide's
# table): dense bf16 tensor-core rate, HBM3 bandwidth, NVLink each way
PEAK_FLOPS = 989e12          # FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card each way (intra-pod)
# pod-crossing: an assumption, one 400 Gb/s NIC per card (a DGX H100
# node's eight ConnectX-7 ports), i.e. 50e9 bytes/s per card
POD_BW = 50e9
HBM_BYTES = 80e9             # per card
WORLD = {False: 256, True: 512}
# --smoke: the SMOKE configs on a (data=2, model=2) / (pod=2, data=2,
# model=2) mesh, each shape cut to SMOKE_SHAPE (seq, global batch)
SMOKE_SHAPE = (32, 8)


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks (this process is rank 0);
    any group already started is ended first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    from repro_torch import pytree
    from repro_torch.distributed import sharding as SH
    total = 0
    for t in pytree.leaves(tree):
        if SH.is_dtensor(t):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _mem_tracker():
    """(a MemTracker to run the step under, or None; why not)."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError as e:
        return None, f"torch.distributed._tools.mem_tracker: {e}"
    return MemTracker(), None


def _peak_of(mt):
    """The largest per-device total of ``mt``'s peak snapshot."""
    snap = mt.get_tracker_snapshot("peak")
    totals = [v.get("Total", 0) for v in snap.values()]
    return max(totals) if totals else None


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             run_overrides=None, tag_suffix: str = "",
             args_only: bool = False, smoke: bool = False) -> dict:
    """One cell: its JSON, written to ``out_dir`` and returned."""
    from repro_torch.configs.base import ALL_SHAPES
    from repro_torch.configs.registry import shape_applicability
    mesh_tag = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_tag}{tag_suffix}"
    shape = next(s for s in ALL_SHAPES if s.name == shape_name)
    skip = shape_applicability(arch, shape)
    if skip:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "SKIP", "reason": skip}
    else:
        t0 = time.time()
        try:
            res = _cell(arch, shape, multi_pod, run_overrides or {},
                        args_only, smoke)
            res["status"] = "OK"
        except Exception as e:  # a failure here is a bug in the system
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        res["run_seconds"] = round(time.time() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
    return res


def _cell(arch, shape, multi_pod, overrides, args_only, smoke) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import analysis as A
    from repro_torch.launch import specs as SPEC
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.models import common as C
    from repro_torch.models import moe as M
    from repro_torch.runtime import steps as ST

    cfg, run = get_config(arch, smoke=smoke)
    plain = {k: v for k, v in overrides.items() if not k.startswith("_")}
    if plain:
        run = dataclasses.replace(run, **plain)
    podwise = bool(overrides.get("_podwise"))
    if smoke:
        shape = dataclasses.replace(shape, seq_len=SMOKE_SHAPE[0],
                                    global_batch=SMOKE_SHAPE[1])
        _fake_group(8 if multi_pod else 4)
        mesh = make_debug_mesh(2, 2, multi_pod=multi_pod, device_type="cpu")
    else:
        _fake_group(WORLD[multi_pod])
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()

    if shape.kind == "train":
        state, batch = SPEC.input_specs(cfg, run, shape)
        shd = SH.make_state_shardings(mesh, state, cfg, run)
        efb = state.efb
        state = SH.distribute_tree(state, shd)
        if podwise:   # pod-local error feedback: plain, each rank's own
            state = state._replace(efb=efb)
            fn = ST.make_train_step_podwise(mesh, cfg, run)
            args = (state, batch)
        else:
            batch = SH.distribute_tree(batch,
                                       SH.make_batch_shardings(mesh, batch))
            fn = lambda s, b: ST.train_step(s, b, cfg, run)
            args = (state, batch)
    elif shape.kind == "prefill":
        params, batch = SPEC.input_specs(cfg, run, shape)
        params = SH.distribute_tree(
            params, SH.make_param_shardings(mesh, params, cfg, run))
        batch = SH.distribute_tree(batch,
                                   SH.make_batch_shardings(mesh, batch))
        fn = lambda p, b: ST.prefill_step(p, b, cfg, shape.seq_len)
        args = (params, batch)
    else:
        params, cache, tokens = SPEC.input_specs(cfg, run, shape)
        params = SH.distribute_tree(
            params, SH.make_param_shardings(mesh, params, cfg, run))
        cache = SH.distribute_tree(
            cache, SH.make_cache_shardings(mesh, cache, cfg, run))
        tokens = SH.distribute_tree(
            {"t": tokens}, SH.make_batch_shardings(mesh, {"t": tokens}))["t"]
        fn = lambda p, c, t: ST.decode_step(p, c, t, cfg)
        args = (params, cache, tokens)

    out = {"arch": arch, "shape": shape.name,
           "mesh": "x".join(str(n) for n in mesh.shape), "smoke": smoke,
           "multi_pod": multi_pod, "podwise": podwise, "n_chips": n_chips,
           "kind": shape.kind, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "memory": {"argument_bytes": _local_bytes(args)}}
    if args_only:
        out["memory"].update(peak_device_bytes=None, fits_80GB=None,
                             peak_note="--args-only: the step was not run")
        out["analysis"] = "argument bytes only (--args-only)"
        return out

    prev = C.SEQ_PARALLEL, M.EXPERT_PARALLEL
    C.SEQ_PARALLEL, M.EXPERT_PARALLEL = run.seq_parallel, run.expert_parallel
    mt, why = _mem_tracker()
    try:
        with SH.use_mesh(mesh), mt if mt is not None else nullcontext():
            result, costs, comm = A.analyse(fn, *args, mesh=mesh)
            del result
    finally:
        C.SEQ_PARALLEL, M.EXPERT_PARALLEL = prev
    peak = _peak_of(mt) if mt is not None else None
    if mt is not None and peak is None:
        why = "MemTracker recorded no device"
    out["memory"].update(
        peak_device_bytes=peak,
        fits_80GB=None if peak is None else peak < HBM_BYTES,
        peak_note=why or "MemTracker peak on meta tensors (parameters, "
                         "optimizer state, activations and gradients; "
                         "no allocator fragmentation)")
    out["collectives"] = comm.as_dict()
    out["cost"] = {"flops_per_device": costs.flops,
                   "bytes_major_per_device": costs.bytes_major,
                   "bytes_accessed_per_device": costs.bytes_accessed,
                   "ops_per_device": costs.ops,
                   "method": "dispatch-mode count of each rank's local ops "
                             "(launch/analysis.py)"}
    terms = A.roofline(costs, comm, PEAK_FLOPS, HBM_BW, NVLINK_BW, POD_BW)
    out["roofline"] = terms
    out["dominant"] = max(terms, key=terms.get)
    out["constants"] = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                        "nvlink_bw": NVLINK_BW, "pod_bw": POD_BW,
                        "source": "NVIDIA H100 SXM data sheet; pod_bw "
                                  "assumed (one 400 Gb/s NIC per card)"}

    # model FLOPs (whole step, all ranks)
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        d_tokens = shape.global_batch * (
            cfg.max_target_len if cfg.family == "encdec" else shape.seq_len)
        model_flops = 6 * n_active * d_tokens
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch
    total = costs.flops * n_chips
    out["model_flops"] = model_flops
    out["flops_total"] = total
    out["useful_flops_ratio"] = model_flops / total if total else 0.0
    return out


def _summary(res: dict) -> str:
    if res["status"] != "OK":
        return res.get("error", res.get("reason", ""))[:120]
    mem = res["memory"]
    line = f"args={mem['argument_bytes'] / 2**30:.3f}GiB/device"
    if "cost" in res:
        peak = mem["peak_device_bytes"]
        line += (f" peak={'n/a' if peak is None else f'{peak / 2**30:.2f}GiB'}"
                 f" flops={res['cost']['flops_per_device']:.4g}/device"
                 f" wire={res['collectives']['total_wire_bytes']:.4g}B"
                 f" (pod {res['collectives']['wire_bytes_pod_crossing']:.4g})"
                 f" dom={res['dominant']}")
    return line + f" {res['run_seconds']}s"


def main(argv=None) -> int:
    from repro_torch.configs.base import ALL_SHAPES
    from repro_torch.configs.registry import ARCH_IDS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="artifact name suffix")
    ap.add_argument("--podwise", action="store_true",
                    help="the podwise step (explicit cross-pod all-reduce)")
    ap.add_argument("--args-only", action="store_true",
                    help="record the argument bytes alone (no step run)")
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE configs on a 2x2 / 2x2x2 mesh, each shape "
                         "cut to seq %d, batch %d" % SMOKE_SHAPE)
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override key=value (repeatable)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.podwise:
        overrides["_podwise"] = True
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v in ("true", "false"):
            v = v == "true"
        elif v.isdigit():
            v = int(v)
        overrides[k] = v

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in ALL_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)
    failed = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    tag = (f"{arch}__{shape}__{'multi' if mp else 'single'}"
                           f"{args.tag}")
                    path = out_dir / f"{tag}.json"
                    if args.skip_existing and path.exists():
                        prev = json.loads(path.read_text())
                        if prev.get("status") in ("OK", "SKIP"):
                            continue
                    res = run_cell(arch, shape, mp, out_dir,
                                   run_overrides=overrides,
                                   tag_suffix=args.tag,
                                   args_only=args.args_only,
                                   smoke=args.smoke)
                    failed += res["status"] == "FAIL"
                    print(f"[dryrun] {tag}: {res['status']} {_summary(res)}",
                          flush=True)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
