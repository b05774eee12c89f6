"""Sharding rules of the production mesh, as DTensor placements; and the
rank mesh of the tiling subsystem's ``"dist"`` transport.

The port's copy of ``repro.distributed.sharding``.  Logical layout:

* FSDP over the ``data`` axis on one matrix dim of every weight (ZeRO-3:
  optimizer state inherits the same specs);
* tensor parallelism over the ``model`` axis on heads / d_ff / vocab /
  experts;
* the ``pod`` axis (multi-pod mesh) is pure data parallelism: parameters
  are replicated across pods and gradients all-reduce across them — the
  collective whose bytes the DWT compression shrinks.

The rules are the reference's, line for line: :func:`param_spec` names
one :class:`PartitionSpec` per leaf from its path and shape, and the
``make_*_shardings`` functions build trees of :class:`NamedSharding`
with the reference's tree structure.  They read only the mesh's axis
names and sizes, so they run on a torch ``DeviceMesh`` and on any object
with ``axis_names`` and ``devices`` (a stub of the reference's ``Mesh``)
alike.

A spec becomes DTensor placements by :func:`placements` (``Shard(d)`` /
``Replicate()`` per mesh dim), and :func:`distribute_tree` places a tree
by them.  A dim that an axis does not divide is split as ``torch.chunk``
splits it: ``ceil(n / axis)`` per rank, the last ranks short or empty.
For the q heads the rules shard without divisibility (qwen2's 14 and
phi4's 24 on a 16-way ``model`` axis) that gives the per-device shape
GSPMD's padding gives (one and two heads).

:func:`use_mesh` sets the ambient mesh that
:func:`repro_torch.models.common.shard_batch` and the MoE's
``_shard_experts`` read.  The reference's ``shard_map`` has no
counterpart: in the port, the podwise step's cross-pod exchange is an
explicit ``torch.distributed`` collective over the ``pod`` group
(:func:`repro_torch.runtime.steps.make_train_step_podwise`).

:class:`TileMesh` is the counterpart of the reference's
``make_tile_mesh``: a 2-D arrangement of the ranks of one
``torch.distributed`` group, one tile per rank, sized like the tile grid
(see :mod:`repro_torch.tiling.exchange`).  Rank ``r`` of the group holds
grid cell ``(r // cols, r % cols)``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, RunConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of axis names.  Compares equal to a tuple of the same
    entries, the reference's ``PartitionSpec`` among them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (the DTensor placements are :attr:`placements`)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


# ---------------------------------------------------------------------------
# The mesh as the rules see it
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a stub's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def _mesh_shape(mesh) -> Tuple[int, ...]:
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.shape)
    return tuple(mesh.devices.shape)


def _axis_size(mesh, name: str) -> int:
    return dict(zip(axis_names(mesh), _mesh_shape(mesh))).get(name, 1)


def _div(n: int, mesh, axis: str) -> Optional[str]:
    """Return the axis name if it exists in the mesh and n is divisible
    by its size, else None."""
    if axis not in axis_names(mesh):
        return None
    return axis if n % _axis_size(mesh, axis) == 0 else None


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def param_spec(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
               run: RunConfig, mesh, fsdp: bool = True) -> PartitionSpec:
    """PartitionSpec for one parameter leaf.

    ``path`` is the '/'-joined key path; a leading layer-stack dim is
    detected by shape arity and never sharded.  ``fsdp=False`` (ZeRO-2
    compute params) drops the 'data'-axis sharding while keeping TP —
    optimizer state keeps fsdp=True.
    """
    name = path.split("/")[-1]
    names = axis_names(mesh)

    def d(n, mesh_, axis):
        if axis == "data" and not fsdp:
            return None
        return _div(n, mesh_, axis)

    def base(spec_dims):
        """Prepend Nones for any leading stack dims."""
        pad = len(shape) - len(spec_dims)
        return P(*([None] * pad + list(spec_dims)))

    # --- embeddings ---
    if name == "tok":
        return P(d(shape[0], mesh, "model"), d(shape[1], mesh, "data"))
    if name == "head":
        return P(d(shape[0], mesh, "data"), d(shape[1], mesh, "model"))

    in_attn = "attn" in path or "xattn" in path

    def _q_heads_ax(n: int):
        """Q heads shard over model even when not divisible (qwen2 14 on
        16, phi4 24 on 16: the per-device shape of GSPMD's padding).
        Tiny head counts replicate."""
        if "model" not in names or not run.attn_tp:
            return None
        ax = _axis_size(mesh, "model")
        if n % ax == 0 or n >= 0.75 * ax:
            return "model"
        return None

    def _kv_heads_ax(n: int):
        return ("model" if (run.attn_tp and "model" in names
                            and n % _axis_size(mesh, "model") == 0)
                else None)

    # --- attention (q/k/v stored (d, n, hd); wo (n, hd, d)) ---
    if name in ("wq", "wk", "wv") and len(shape) >= 3 and in_attn:
        n = shape[-2]
        h_ax = _q_heads_ax(n) if name == "wq" else _kv_heads_ax(n)
        # MQA (kv=1): shard the head_dim instead (granite-34b)
        hd_ax = None
        if h_ax is None and n == 1 and run.attn_tp and name in ("wk", "wv"):
            hd_ax = d(shape[-1], mesh, "model")
        return base([d(shape[-3], mesh, "data"), h_ax, hd_ax])
    if name == "wo" and len(shape) >= 3 and in_attn:
        h_ax = _q_heads_ax(shape[-3])
        return base([h_ax, None, d(shape[-1], mesh, "data")])
    if name in ("bq", "bk", "bv"):
        n = shape[-2]
        h_ax = _q_heads_ax(n) if name == "bq" else _kv_heads_ax(n)
        return base([h_ax, None])

    # --- MoE experts (e, d, f) / (e, f, d); router (d, e) ---
    if name == "router":
        return base([d(shape[-2], mesh, "data"), None])
    if name in ("gate", "up", "down") and len(shape) >= 3 and cfg.is_moe \
            and shape[-3] == cfg.n_experts:
        e_ax = ("model" if run.expert_parallel and "model" in names
                and cfg.n_experts % _axis_size(mesh, "model") == 0 else None)
        if name == "down":  # (e, f, d)
            f_ax = None if e_ax else d(shape[-2], mesh, "model")
            return base([e_ax, f_ax, d(shape[-1], mesh, "data")])
        f_ax = None if e_ax else d(shape[-1], mesh, "model")
        return base([e_ax, d(shape[-2], mesh, "data"), f_ax])

    # --- dense MLP ---
    if name in ("gate", "up", "ck", "decay_w1"):
        return base([d(shape[-2], mesh, "data"),
                     d(shape[-1], mesh, "model")
                     if name != "decay_w1" else None])
    if name in ("down", "cv"):
        return base([d(shape[-2], mesh, "model"), d(shape[-1], mesh, "data")])
    if name == "up_b":
        return base([d(shape[-1], mesh, "model")])

    # --- mamba ---
    if name == "in_proj":
        return base([d(shape[-2], mesh, "data"), d(shape[-1], mesh, "model")])
    if name == "out_proj":
        return base([d(shape[-2], mesh, "model"), d(shape[-1], mesh, "data")])
    if name in ("conv_w",):
        return base([None, d(shape[-1], mesh, "model")])
    if name in ("conv_b", "norm"):
        return base([d(shape[-1], mesh, "model")])

    # --- rwkv square projections (paths contain 'rwkv', not 'attn') ---
    if name in ("wr", "wg", "cr", "wk", "wv", "wq", "wo"):
        return base([d(shape[-2], mesh, "data"), d(shape[-1], mesh, "model")])
    if name == "decay_w2":
        return base([None, d(shape[-1], mesh, "model")])

    # everything else (norm scales, biases, mixing coefficients) replicates
    return P()


def _path(path) -> str:
    return "/".join(str(k) for _, k in path)


def make_param_shardings(mesh, params_shape: Any, cfg: ModelConfig,
                         run: RunConfig, fsdp: bool = True) -> Any:
    """NamedSharding tree matching ``params_shape`` (any tree of leaves
    with a ``shape``: meta tensors from ``init_params(..., "meta")``)."""
    flat = pytree.leaves_with_path(params_shape)
    return pytree.unflatten(params_shape, [
        NamedSharding(mesh, param_spec(_path(p), tuple(leaf.shape), cfg, run,
                                       mesh, fsdp=fsdp))
        for p, leaf in flat])


def make_state_shardings(mesh, state_specs, cfg: ModelConfig,
                         run: RunConfig):
    """TrainState shardings: ZeRO-3 shards compute params over 'data';
    ZeRO-2 keeps compute params TP-only and shards just optimizer state
    (+ error feedback) — one param gather per step instead of per
    microbatch."""
    from repro_torch.runtime.steps import TrainState
    repl = NamedSharding(mesh, P())
    fsdp_params = run.zero >= 3
    return TrainState(
        params=make_param_shardings(mesh, state_specs.params, cfg, run,
                                    fsdp=fsdp_params),
        opt=type(state_specs.opt)(
            count=repl,
            mu=make_param_shardings(mesh, state_specs.opt.mu, cfg, run),
            nu=make_param_shardings(mesh, state_specs.opt.nu, cfg, run)),
        efb=make_param_shardings(mesh, state_specs.efb, cfg, run),
        step=repl,
    )


def batch_axes(mesh, batch: int):
    """Shard batch over (pod, data) when divisible; fall back gracefully."""
    names = axis_names(mesh)
    axes = [a for a in ("pod", "data") if a in names]
    size = 1
    for a in axes:
        size *= _axis_size(mesh, a)
    if batch % size == 0:
        return tuple(axes) if len(axes) > 1 else axes[0]
    if "data" in names and batch % _axis_size(mesh, "data") == 0:
        return "data"
    return None


def make_batch_shardings(mesh, batch_shape: Any) -> Any:
    return pytree.tree_map(
        lambda leaf: NamedSharding(mesh, P(batch_axes(mesh, leaf.shape[0]),
                                           *([None] * (len(leaf.shape) - 1)))),
        batch_shape)


def make_cache_shardings(mesh, cache_shape: Any, cfg: ModelConfig,
                         run: RunConfig) -> Any:
    """Decode caches: batch over (pod,data); kv-head dim over model when
    divisible.  Cache leaves are (L, B, ...) or (B, ...) for scalars."""
    names = axis_names(mesh)

    def one(keys, leaf):
        shp = tuple(leaf.shape)
        if not shp:  # pos scalar
            return NamedSharding(mesh, P())
        specs = [None] * len(shp)
        # caches are stacked (L_or_groups, B, ...): batch is dim 1
        # whenever stacked
        bdim = 1 if ("kv" in keys or "cross" in keys or "rwkv" in keys
                     or "mamba" in keys) and len(shp) >= 3 else 0
        specs[bdim] = batch_axes(mesh, shp[bdim])
        # kv heads (k/v caches are (..., len, kv, hd))
        if keys.endswith("/k") or keys.endswith("/v"):
            kv = shp[-2]
            if "model" not in names:
                return NamedSharding(mesh, P(*specs))
            ax = _axis_size(mesh, "model")
            if run.attn_tp and kv % ax == 0:
                specs[-2] = "model"
            elif run.attn_tp and kv == 1 and shp[-1] % ax == 0:
                specs[-1] = "model"  # MQA: shard head_dim (granite)
            elif run.attn_tp and len(shp) >= 4 and shp[-3] % ax == 0:
                # GQA with kv not divisible (kv=8 on 16-way): shard the
                # cache LENGTH (sequence-parallel decode attention)
                specs[-3] = "model"
        if "wkv" in keys and len(shp) >= 4:  # (L,B,nh,hd,hd)
            if _div(shp[2], mesh, "model"):
                specs[2] = "model"
        if "ssm" in keys and len(shp) >= 4:  # (L,B,nh,hd,ds)
            if _div(shp[2], mesh, "model"):
                specs[2] = "model"
        return NamedSharding(mesh, P(*specs))

    flat = pytree.leaves_with_path(cache_shape)
    return pytree.unflatten(cache_shape,
                            [one(_path(p), leaf) for p, leaf in flat])


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: PartitionSpec, mesh) -> tuple:
    """``Shard(d)`` / ``Replicate()`` for each dim of ``mesh``: mesh dim
    ``a`` shards tensor dim ``d`` when ``spec[d]`` names ``a`` (alone or
    in a tuple).  Mesh dims that shard one tensor dim split it in mesh
    order (``("pod", "data")`` on a (pod, data, model) mesh: pod major)."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            if a in where:
                raise ValueError(f"axis {a!r} named twice in {spec!r}")
            where[a] = d
    names = axis_names(mesh)
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"{spec!r} names axes {sorted(unknown)} the mesh "
                         f"{names} does not have")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def distribute(t, sharding: NamedSharding):
    """``t`` (the whole tensor, the same on every rank) as a DTensor
    placed by ``sharding``: each rank keeps its own chunk, nothing is
    sent.  A 0-d tensor on the host (a step counter) stays as it is:
    the port keeps counters on the host, replicated by construction."""
    if t.dim() == 0 and t.device.type == "cpu":
        return t
    mesh = sharding.mesh
    if t.device.type not in (mesh.device_type, "meta"):
        t = t.to(mesh.device_type)
    return like(t, sharding)


def distribute_tree(tree, shardings):
    """Each leaf of ``tree`` placed by the matching leaf of
    ``shardings`` (:func:`distribute`)."""
    return pytree.tree_map(distribute, tree, shardings)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def to_global(t):
    """The whole tensor of a DTensor (gathered), or ``t`` itself."""
    return t.full_tensor() if is_dtensor(t) else t


def reduced(t):
    """A DTensor with its partial placements reduced (replicated over
    those mesh dims); anything else as it is."""
    if not is_dtensor(t) or not any(pl.is_partial() for pl in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if pl.is_partial()
                                          else pl for pl in t.placements])


def split_across_ranks(t, dim: int) -> bool:
    """Whether DTensor ``t``'s dim ``dim`` is sharded by a mesh dim of
    more than one rank."""
    if not is_dtensor(t):
        return False
    dim %= t.ndim
    return any(pl.is_shard(dim) and n > 1
               for pl, n in zip(t.placements, t.device_mesh.shape))


def like(t, ref):
    """``t`` (the whole tensor, the same on every rank) placed as ``ref``
    is: a DTensor's mesh and placements, or a :class:`NamedSharding`'s.
    Each rank keeps its chunk of ``t``; nothing is sent.  Any other
    ``ref`` returns ``t``."""
    if isinstance(ref, NamedSharding):
        mesh, where = ref.mesh, ref.placements
    elif is_dtensor(ref):
        mesh, where = ref.device_mesh, ref.placements
    else:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    whole = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, where)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; with DTensor operands, computed shard
    by shard with explicit placements (:func:`_contract`).

    DTensor's own einsum flattens its operands into a matrix product and
    unflattens the result, and the unflatten fails wherever the product
    came out sharded on a merged dim the mesh does not divide (qwen2's 2
    kv heads on a 16-way ``model`` axis)."""
    import torch
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    return _contract(la, lb, out, a, b,
                     lambda x, y: torch.einsum(eq, x, y))


def matmul(x, w):
    """``x @ w`` for a 2-D ``w`` (a weight); with DTensor operands,
    computed shard by shard as :func:`einsum` is, so the weight's
    tensor-parallel sharding carries into the result (DTensor's own
    matmul may gather the weight whole and replicate the product)."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    lead = "abcdefgh"[:x.ndim - 1]
    return _contract(lead + "k", "kz", lead + "z", x, w,
                     lambda p, q: p @ q)


def _contract(la, lb, out, a, b, local):
    """``local(a, b)`` on each rank's chunks, the operands' dims named by
    the letters ``la`` and ``lb`` and the result's by ``out``.  Per mesh
    dim, the first operand (the activation) keeps its sharding and the
    second (the weight) follows it: it shards the same letter where it
    has it and is gathered otherwise; a letter only the weight shards,
    the activation shards too (a local chunk), so the result is sharded
    on that letter, or partial where the letter is contracted.  On a
    one-rank mesh, ``local`` runs on the same tensors as without
    DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (a if is_dtensor(a) else b).device_mesh

    def as_d(t):
        if is_dtensor(t):
            return reduced(t)
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    a, b = as_d(a), as_d(b)
    pa, pb, po = [], [], []
    for A, B in zip(a.placements, b.placements):
        if A.is_shard():
            x = la[A.dim]
            A2 = A
            B2 = Shard(lb.index(x)) if x in lb else Replicate()
        elif B.is_shard():
            x = lb[B.dim]
            B2 = B
            A2 = Shard(la.index(x)) if x in la else Replicate()
        else:
            pa.append(A)
            pb.append(B)
            po.append(Replicate())
            continue
        pa.append(A2)
        pb.append(B2)
        po.append(Shard(out.index(x)) if x in out else Partial())
    if tuple(pa) != tuple(a.placements):
        a = a.redistribute(mesh, pa)
    if tuple(pb) != tuple(b.placements):
        b = b.redistribute(mesh, pb)
    # a replicated operand whose partner is sharded on a letter it lacks
    # gets a partial-sum gradient over that mesh dim
    ga = [Partial() if A.is_replicate() and B.is_shard() else A
          for A, B in zip(pa, pb)]
    gb = [Partial() if B.is_replicate() and A.is_shard() else B
          for A, B in zip(pa, pb)]
    y = local(a.to_local(grad_placements=ga),
              b.to_local(grad_placements=gb))
    size = dict(zip(la, a.shape))
    size.update(zip(lb, b.shape))
    return from_local(y, mesh, po, tuple(size[x] for x in out))


def from_local(y, mesh, where, shape):
    """``y`` as the local chunk of a DTensor of global ``shape``; the
    global strides keep ``y``'s memory order (an einsum may return a
    permuted view), so reshapes decide view or copy as they would on
    the local tensor."""
    from torch.distributed.tensor import DTensor
    stride, acc = [0] * len(shape), 1
    for d in sorted(range(len(shape)), key=lambda d: (y.stride(d), -d)):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(y, mesh, where, run_check=False, shape=shape,
                              stride=tuple(stride))


def mask_tail(t, n: int, fill):
    """``t`` with its last dim's entries from ``n`` on set to ``fill``.
    On a DTensor, each rank masks its own columns (DTensor's ``where``
    against a whole-width mask, in the backward pass, gathers what is
    sharded)."""
    import torch
    if not is_dtensor(t):
        keep = torch.arange(t.shape[-1], device=t.device) < n
        return torch.where(keep, t, fill)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    t = reduced(t)
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    local = t.to_local()
    cols = offset[-1] + torch.arange(local.shape[-1], device=local.device)
    return from_local(torch.where(cols < n, local, fill), t.device_mesh,
                       t.placements, tuple(t.shape))


def take_rows(table, idx):
    """``table[idx]``: rows of a table by integer indices.  With
    DTensors, the table is gathered whole and each rank looks up its own
    indices, so the result is placed as ``idx`` is (on its leading
    dims); the table's gradient is a partial sum over the mesh dims that
    shard ``idx``.  (DTensor's own rule for the index op's backward,
    ``index_put``, fails on the card's torch 2.11.)  The local op is the
    plain indexing: on a one-rank mesh, the same call on the same
    tensors as without DTensor."""
    if not (is_dtensor(table) or is_dtensor(idx)):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (idx if is_dtensor(idx) else table).device_mesh
    whole = [Replicate()] * mesh.ndim
    if is_dtensor(table):
        table = table.redistribute(mesh, whole)
    else:
        table = DTensor.from_local(table, mesh, whole, run_check=False)
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, whole, run_check=False)
    where = idx.placements
    grad = [Partial() if pl.is_shard() else Replicate() for pl in where]
    y = table.to_local(grad_placements=grad)[idx.to_local()]
    return from_local(y, mesh, [Shard(pl.dim) if pl.is_shard()
                                 else Replicate() for pl in where],
                       tuple(idx.shape) + tuple(table.shape[1:]))


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_MESH = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (read by :func:`current_mesh`) for
    the block: the counterpart of the reference's ``use_mesh``."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = prev


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH[0]


# ---------------------------------------------------------------------------
# The tiling subsystem's rank mesh
# ---------------------------------------------------------------------------

class TileMesh:
    """``rows x cols`` ranks of ``group`` (None: the default group), one
    tile block each.  Built on every rank after
    ``torch.distributed.init_process_group``; raises unless the group
    has exactly ``rows * cols`` ranks."""

    def __init__(self, rows: int, cols: int, group=None):
        import torch.distributed as dist
        self.rows, self.cols, self.group = int(rows), int(cols), group
        have = dist.get_world_size(group)
        if have != self.rows * self.cols:
            raise ValueError(
                f"tile mesh {rows}x{cols} needs {rows * cols} devices, "
                f"have {have}")
        #: this process's rank in ``group``
        self.rank = dist.get_rank(group)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    def coords(self, rank: int) -> Tuple[int, int]:
        """Grid cell ``(row, col)`` of group rank ``rank``."""
        return divmod(rank, self.cols)

    def rank_of(self, row: int, col: int) -> int:
        """Group rank holding grid cell ``(row, col)``."""
        return row * self.cols + col

    def global_rank(self, rank: int) -> int:
        """The default group's rank of group rank ``rank`` (what
        point-to-point operations name their peer by)."""
        if self.group is None:
            return rank
        import torch.distributed as dist
        return dist.get_global_rank(self.group, rank)
