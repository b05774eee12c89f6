"""Shape-bucket algebra for the serving scheduler.

A *bucket* is the unit of coalescing: every request that can legally
ride the same cached :class:`~repro_torch.engine.plan.DwtPlan` execution
maps to one :class:`BucketKey` — the full plan configuration, the
device, the image geometry and the transform direction.  Requests inside
a bucket stack onto the free leading batch dimension of the plan (every
registered backend accepts batched ``(..., H, W)`` input), and the batch
dimension is padded up to the next power of two (capped at the
scheduler's ``max_batch``), so a bucket only ever resolves
``log2(max_batch) + 1`` distinct plans — the plan cache stays warm at
any traffic level.

Stacking happens on the host, into one flat buffer per batch (pinned
on a CUDA server, so the batch goes to the card in one copy); results
come back the same way and every request gets numpy views into them.
Requests and results are trees of arrays — a bare image or volume, a
:class:`~repro_torch.engine.pyramid.Pyramid`, ``Pyramid3`` or
``WaveletPacket2D`` — flattened and rebuilt explicitly
(:func:`flatten_tree` / :func:`unflatten_tree`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.engine.pyramid import Pyramid, Pyramid3, WaveletPacket2D

OPS = ("dwt2", "idwt2", "dwt3", "idwt3", "wpt2", "iwpt2")
#: ops whose geometry carries a temporal axis (..., T, H, W)
OPS_3D = ("dwt3", "idwt3")
#: ops keyed on a packet-tree leaf set
OPS_PACKET = ("wpt2", "iwpt2")


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Everything that must match for two requests to share one batched
    plan execution: the transform direction, the image geometry (the
    shape bucket), the device and every plan-key configuration field.
    3-D ops add the temporal extent ``t`` (0 for 2-D ops); packet ops add
    the canonical leaf tuple ``packet`` (None otherwise)."""

    op: str                 # one of OPS
    h: int
    w: int
    dtype: str
    wavelet: str
    scheme: str
    levels: int
    backend: str
    optimize: bool
    fuse: str
    boundary: str
    compute_dtype: str
    tap_opt: str
    device: str = "cuda"
    t: int = 0
    packet: Optional[Tuple[str, ...]] = None

    def plan_kwargs(self, batch: int) -> dict:
        """``repro_torch.engine.get_plan`` arguments for this bucket at
        one padded batch size."""
        if self.op in OPS_3D:
            shape = (batch, self.t, self.h, self.w)
        else:
            shape = (batch, self.h, self.w)
        kw = dict(wavelet=self.wavelet, scheme=self.scheme,
                  levels=self.levels, shape=shape,
                  dtype=self.dtype, backend=self.backend,
                  optimize=self.optimize, fuse=self.fuse,
                  boundary=self.boundary,
                  compute_dtype=self.compute_dtype,
                  tap_opt=self.tap_opt, device=self.device)
        if self.op in OPS_3D:
            kw["ndim"] = 3
        if self.packet is not None:
            kw["packet"] = self.packet
        return kw


@dataclasses.dataclass
class Request:
    """One enqueued transform request."""

    payload: object         # np.ndarray (forward) | host tree (inverse)
    future: object          # asyncio.Future resolved at scatter time
    t: float                # enqueue timestamp (event-loop clock)
    attempts: int = 0       # dead-worker re-dispatch count


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A declared bucket for startup warmup: the image geometry plus the
    transform configuration the deployment expects to serve (the device
    is the server's)."""

    shape: Tuple[int, int]            # (H, W)
    wavelet: str = "cdf97"
    scheme: str = "ns-polyconv"
    levels: int = 1
    dtype: str = "float32"
    backend: str = "cuda"
    optimize: bool = False
    fuse: str = "levels"
    boundary: str = "periodic"
    compute_dtype: str = "float32"
    tap_opt: str = "full"

    def key(self, op: str = "dwt2", device: str = "cuda") -> BucketKey:
        return BucketKey(op=op, h=int(self.shape[0]), w=int(self.shape[1]),
                         dtype=self.dtype, wavelet=self.wavelet,
                         scheme=self.scheme, levels=int(self.levels),
                         backend=self.backend, optimize=self.optimize,
                         fuse=self.fuse, boundary=self.boundary,
                         compute_dtype=self.compute_dtype,
                         tap_opt=self.tap_opt, device=str(device))


def padded_batch(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at ``max_batch``: the batch sizes
    a bucket's plans are actually built for."""
    if n <= 0:
        raise ValueError(f"batch must be positive, got {n}")
    return min(max_batch, 1 << (n - 1).bit_length())


def bucket_batches(max_batch: int) -> List[int]:
    """Every padded batch size a bucket can execute at (warmup targets)."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b <<= 1
    sizes.append(max_batch)
    return sizes


# -- trees of arrays ---------------------------------------------------

def flatten_tree(tree) -> list:
    """The arrays of a request or result, in a fixed order: a bare array
    is one leaf; a Pyramid / Pyramid3 its LL then every detail band,
    coarsest level first; a WaveletPacket2D its leaves in path order."""
    if isinstance(tree, (Pyramid, Pyramid3)):
        return [tree.ll] + [d for dd in tree.details for d in dd]
    if isinstance(tree, WaveletPacket2D):
        return list(tree.leaves)
    return [tree]


def unflatten_tree(like, leaves: Sequence):
    """``like``'s structure rebuilt around ``leaves`` (the inverse of
    :func:`flatten_tree`)."""
    leaves = list(leaves)
    if isinstance(like, (Pyramid, Pyramid3)):
        it = iter(leaves[1:])
        details = [tuple(next(it) for _ in dd) for dd in like.details]
        return type(like)(ll=leaves[0], details=details)
    if isinstance(like, WaveletPacket2D):
        return WaveletPacket2D(paths=tuple(like.paths), leaves=leaves)
    (leaf,) = leaves
    return leaf


def split_flat(flat, shapes: Sequence[Tuple[int, ...]]) -> list:
    """Views of a flat (1-D numpy array or torch tensor) buffer in the
    given shapes, back to back."""
    out, off = [], 0
    for shape in shapes:
        shape = tuple(shape)
        n = int(np.prod(shape, dtype=np.int64))
        out.append(flat[off:off + n].reshape(shape))
        off += n
    return out


def stacked_numel(payload, pad_to: int) -> int:
    """Elements of a batch of ``pad_to`` requests shaped like
    ``payload``, stacked."""
    return pad_to * sum(int(np.asarray(leaf).size)
                        for leaf in flatten_tree(payload))


def stack_trees(payloads: Sequence, pad_to: int, out=None):
    """Stack request trees (bare images or volumes, pyramids, packet
    trees) on the host into one zero-padded batched tree: every leaf of
    every request onto a new leading batch axis, padded with zeros up to
    ``pad_to``.  With ``out`` (a flat numpy array of
    :func:`stacked_numel` elements, e.g. a pinned host buffer's view) the
    stacked leaves are views into it, back to back, so the whole batch
    moves to the card in one copy."""
    cols = [[np.asarray(leaf) for leaf in flatten_tree(p)]
            for p in payloads]
    first = cols[0]
    shapes = [(pad_to,) + leaf.shape for leaf in first]
    if out is None:
        stacked = [np.empty(s, leaf.dtype) for s, leaf in zip(shapes, first)]
    else:
        stacked = split_flat(out, shapes)
    n = len(payloads)
    for i, dst in enumerate(stacked):
        for j, col in enumerate(cols):
            dst[j] = col[i]
        dst[n:] = 0
    return unflatten_tree(payloads[0], stacked)


def scatter_tree(tree, n: int) -> list:
    """Split one batched host tree (numpy leaves) into ``n``
    per-request trees of zero-copy views."""
    leaves = flatten_tree(tree)
    return [unflatten_tree(tree, [leaf[i] for leaf in leaves])
            for i in range(n)]


def request_key(x_shape, dtype, *, op: str, wavelet: str, scheme: str,
                levels: int, backend: str, optimize: bool, fuse: str,
                boundary: str, compute_dtype: str, tap_opt: str,
                device: str = "cuda", packet=None) -> BucketKey:
    """Bucket key for one request.  For inverse requests ``x_shape`` is
    the *reconstructed image/volume* shape (``ll.shape << levels``), so
    both directions of the same configuration share one geometry key
    space.  3-D ops take ``(T, H, W)`` shapes; packet ops carry a
    ``packet`` spec, normalized to the canonical leaf tuple so every
    spelling of the same tree shares one bucket."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; available: {OPS}")
    want = 3 if op in OPS_3D else 2
    if len(x_shape) != want:
        what = "(T, H, W) volumes" if want == 3 else "(H, W) images"
        raise ValueError(
            f"serving {op!r} requests are single {what}; got shape "
            f"{tuple(x_shape)} — split batches client-side (the server "
            f"re-batches across requests)")
    t = int(x_shape[0]) if want == 3 else 0
    if op in OPS_PACKET:
        if packet is None:
            raise ValueError(f"op {op!r} requires a packet spec")
        from repro_torch.core import packets as PK
        tree = PK.PacketTree.from_spec(packet)
        packet = tree.leaves
        levels = tree.depth
    elif packet is not None:
        raise ValueError(f"op {op!r} does not take a packet spec")
    return BucketKey(op=op, h=int(x_shape[-2]), w=int(x_shape[-1]),
                     dtype=str(np.dtype(dtype)), wavelet=wavelet,
                     scheme=scheme, levels=int(levels), backend=backend,
                     optimize=bool(optimize), fuse=fuse, boundary=boundary,
                     compute_dtype=compute_dtype, tap_opt=tap_opt,
                     device=str(device), t=t, packet=packet)
