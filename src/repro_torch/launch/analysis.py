"""FLOPs, bytes and collective traffic of one run of a function, per
device: the port's counterpart of ``repro.launch.hlo_analysis``.

The reference parses the partitioned HLO of a compiled step.  The port
has no HLO: it runs the step (on ``meta`` tensors in the dry run, so
nothing is allocated) under two dispatch modes (``TorchDispatchMode``)
and counts the operations as they are dispatched.

* :func:`count_costs` counts what each rank computes.  An op on DTensors
  is passed on to DTensor (the mode returns ``NotImplemented``), which
  runs the rank's local op on plain tensors, and that op comes back
  through the mode and is counted: FLOPs by PyTorch's own formulas
  (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions,
  attention).  DTensor infers each op's global output shape by running
  it once on fake tensors at the global shape; those runs are skipped,
  so the count is per device, the reference's measure.  (A
  ``FlopCounterMode`` around the same program counts every op at its
  global shape, and with the shape inference too.)  Bytes: each op's
  tensor inputs read once and outputs written once, views excluded;
  ``bytes_major`` only for the ops a fused kernel cannot keep on chip
  (the matmul family, gathers and scatters) — the reference's
  fusion-optimistic term — and ``bytes_accessed`` for every op (an
  unfused upper bound).
* :func:`count_collectives` counts the collectives each rank issues,
  under ``torch.distributed.tensor.debug.CommDebugMode``: DTensor's
  functional collectives and explicit ``torch.distributed`` calls alike.
  Each is sized by its result, turned into wire bytes by the
  reference's ring factors, and filed as pod-crossing when its process
  group is the mesh's ``pod`` group, intra-pod otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (without namespace and overload) -> reference kind: DTensor's
# functional collectives and the c10d all-reduce of the podwise step
_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops a fused kernel cannot keep on chip besides the flop_registry's
_GATHERS = {"index", "index_put", "index_put_", "gather", "scatter",
            "scatter_add", "index_select", "index_copy", "index_add",
            "embedding", "embedding_dense_backward"}


@dataclasses.dataclass
class CostStats:
    flops: float               # per device
    bytes_major: float         # matmuls, gathers, scatters (fused estimate)
    bytes_accessed: float      # every non-view op (unfused upper bound)
    ops: int                   # local ops counted



@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    op_bytes: Dict[str, float]        # result bytes
    wire_bytes_intra_pod: float       # ring wire bytes per device
    wire_bytes_pod_crossing: float
    total_wire_bytes: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _name(func) -> str:
    return func.overloadpacket.__name__


def _mode_classes():
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class LocalCosts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.stats = CostStats(0.0, 0.0, 0.0, 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented    # DTensor runs the local op
            out = func(*args, **kwargs)
            ins = _tensors((args, kwargs))
            if any(isinstance(t, FakeTensor) for t in ins):
                return out               # DTensor's shape inference
            st = self.stats
            st.ops += 1
            formula = flop_registry.get(func.overloadpacket)
            moved = 0
            if not func.is_view:
                moved = _nbytes(ins) + _nbytes(_tensors(out))
                st.bytes_accessed += moved
            if formula is not None:
                st.flops += formula(*args, **kwargs, out_val=out)
                st.bytes_major += moved
            elif _name(func) in _GATHERS:
                st.bytes_major += moved
            return out

    class Collectives(CommDebugMode):
        def __init__(self, pod_groups):
            super().__init__()
            self.pod_groups = pod_groups
            self.stats = CollectiveStats({k: 0 for k in COLLECTIVES},
                                         {k: 0.0 for k in COLLECTIVES},
                                         0.0, 0.0, 0.0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = _KINDS.get(_name(func))
            if kind is not None and not any(issubclass(t, DTensor)
                                            for t in types):
                self._record(kind, func, args, out)
            return out

        def _record(self, kind, func, args, out):
            name, size = _group_of(args)
            if size <= 1:
                return
            # the result: a functional collective returns it, an
            # in-place one (c10d) writes its first argument
            res = _tensors(out if func.namespace.endswith("functional")
                           else args[0])
            rb = _nbytes(res)
            g = size
            if kind == "all-reduce":
                wire = 2.0 * rb * (g - 1) / g
            elif kind == "all-gather":
                wire = rb * (g - 1) / g
            elif kind == "reduce-scatter":
                wire = rb * (g - 1)      # result is the scattered shard
            else:                        # all-to-all
                wire = rb * (g - 1) / g
            st = self.stats
            st.counts[kind] += 1
            st.op_bytes[kind] += rb
            if name in self.pod_groups:
                st.wire_bytes_pod_crossing += wire
            else:
                st.wire_bytes_intra_pod += wire
            st.total_wire_bytes += wire

    return LocalCosts, Collectives


def _group_of(args):
    """(name, size) of a collective's process group: a functional
    collective names it by a string, a c10d op passes the group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(a)
            return pg.group_name, pg.size()
    names = [a for a in args if isinstance(a, str)]
    pg = _resolve_process_group(names[-1])
    return pg.group_name, pg.size()


def count_costs(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CostStats)``: the FLOPs and bytes of the
    ops this rank runs (module docstring)."""
    local_costs, _ = _mode_classes()
    mode = local_costs()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.stats


def _pod_groups(mesh):
    if mesh is not None and "pod" in (mesh.mesh_dim_names or ()):
        return {mesh.get_group("pod").group_name}
    return set()


def count_collectives(fn, *args, mesh=None, **kwargs):
    """``(fn(*args, **kwargs), CollectiveStats)``: the collectives this
    rank issues, pod-crossing where the group is ``mesh``'s ``pod``
    group (module docstring)."""
    _, collectives = _mode_classes()
    mode = collectives(_pod_groups(mesh))
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.stats


def analyse(fn, *args, mesh=None, **kwargs):
    """``fn`` run once under both counters: ``(out, CostStats,
    CollectiveStats)``."""
    local_costs, collectives = _mode_classes()
    comm, costs = collectives(_pod_groups(mesh)), local_costs()
    with comm, costs:
        out = fn(*args, **kwargs)
    return out, costs.stats, comm.stats


def roofline(costs: CostStats, comm: CollectiveStats, peak_flops: float,
             hbm_bw: float, intra_bw: float, cross_bw: float,
             ) -> Dict[str, float]:
    """The three roofline terms in seconds per device (and so per step)."""
    return {"compute_s": costs.flops / peak_flops,
            "memory_s": costs.bytes_major / hbm_bw,
            "collective_s": (comm.wire_bytes_intra_pod / intra_bw
                             + comm.wire_bytes_pod_crossing / cross_bw)}
