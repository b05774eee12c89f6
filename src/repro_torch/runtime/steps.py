"""Train / prefill / decode steps for every model family: the port's
copy of ``repro.runtime.steps``.

``train_step``: loss -> grads (autograd, ``grad_accum`` microbatches) ->
optional DWT compression with error feedback -> AdamW.  Cross-entropy
projects to the vocabulary in sequence chunks of ``CE_CHUNK``, each
under ``torch.utils.checkpoint``, so no ``(B, chunk, vocab)`` logits
survive as autograd residuals.

The same ``train_step`` is the sharded step: given a :class:`TrainState`
whose leaves are DTensors placed by
:func:`repro_torch.distributed.sharding.make_state_shardings` (and a
batch placed by ``make_batch_shardings``), DTensor's sharding
propagation inserts the collectives, as GSPMD does for the reference's
pjit step.  Tensors the model builds for itself (RoPE tables, masks,
positions, recurrent states) are plain and count as replicated
(``implicit_replication``).  Each gradient is placed as its parameter;
compression transforms the global leaf; AdamW runs on the local shards.

:func:`make_train_step_podwise` is the multi-pod step: each pod computes
gradients on its rows of the batch, and the only cross-pod traffic is
an explicit all-reduce over the ``pod`` group of the compressed slice
(or of the raw gradients when compression is off).

The steps are functional, as the reference's: they return a new
:class:`TrainState` (new parameter, optimizer and error-feedback trees)
and leave the one given as it was.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch import telemetry as T
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import compression as CMP
from repro_torch.distributed import sharding as SH
from repro_torch.models import common as C
from repro_torch.models import lm
from repro_torch.optim import adamw

CE_CHUNK = 256
AUX_COEF = 0.01


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    efb: Any              # error-feedback state ({} when compression off)
    step: torch.Tensor    # int32, 0-d, on the host


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     run: RunConfig, device="cuda") -> TrainState:
    """Fresh state on ``device``: an :class:`~repro_torch.models.lm.LM`'s
    parameters drawn from ``gen`` (a generator on that device)."""
    params = lm.LM(cfg, generator=gen, device=device).tree()
    efb = (CMP.init_error_feedback(params)
           if run.grad_compression.startswith("dwt") else {})
    return TrainState(params, adamw.init(params), efb,
                      torch.tensor(0, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------

def _logsumexp(logits):
    """``torch.logsumexp`` over the last dim; over a vocabulary split
    across ranks, from the max and the sum of exponentials reduced
    across them (a few numbers per position) rather than from gathered
    logits."""
    if not SH.split_across_ranks(logits, -1):
        return torch.logsumexp(logits, dim=-1)
    # reduced to replicas explicitly: DTensor would otherwise scatter the
    # partial sums over the batch, and the backward gather the logits
    top = SH.reduced(logits.detach().amax(dim=-1, keepdim=True))
    return torch.log(SH.reduced(torch.sum(torch.exp(logits - top),
                                          dim=-1))) + top[..., 0]


def _gold(logits, labels):
    """The labels' logits; over a vocabulary split across ranks, as a
    sum of the logits masked to each label (a partial sum reduced across
    the ranks; its backward stays split, where the gather's scatters
    into gathered logits)."""
    if not SH.split_across_ranks(logits, -1):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = (labels[..., None] == vocab).to(logits.dtype)
    return torch.sum(logits * hit, dim=-1)


def _ce_chunk(embed_params, h, l, m, cfg):
    logits = C.unembed(embed_params, h, cfg).float()
    lse = _logsumexp(logits)
    # a vocab-sharded gather on one rank is a masked partial sum: reduced
    # before the index drops its dim (DTensor's mask keeps the gather's
    # shape)
    gold = SH.reduced(_gold(logits, l))
    nll = (lse - gold) * m
    return torch.sum(nll), torch.sum(m)


def chunked_ce(embed_params, hidden: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig,
               chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean CE over masked positions; vocab projection done per chunk.

    hidden: (B, S, D); labels/mask: (B, S).
    """
    b, s, d = hidden.shape
    ch = min(chunk, s)
    while s % ch:
        ch -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, ch):
        t, c = checkpoint(_ce_chunk, embed_params, hidden[:, i:i + ch],
                          labels[:, i:i + ch], mask[:, i:i + ch], cfg,
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            run: RunConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ the MoE aux loss) for every family."""
    remat = run.remat != "none"
    if cfg.family == "encdec":
        hidden, aux = lm.whisper_hidden(params, batch["enc_embeds"],
                                        batch["dec_tokens"], cfg, remat=remat)
        tokens = batch["dec_tokens"]
    else:
        hidden, aux = lm.forward_hidden(params, batch["tokens"], cfg,
                                        embeds=batch.get("patch_embeds"),
                                        remat=remat)
        tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1).long()
    mask = torch.cat(
        [torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                    device=tokens.device),
         torch.zeros(tokens[:, :1].shape, dtype=torch.float32,
                     device=tokens.device)], dim=1)
    ce = chunked_ce(params["embed"], hidden, labels, mask, cfg)
    loss = ce + AUX_COEF * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _detached(metrics):
    return {k: SH.to_global(v.detach()) for k, v in metrics.items()}


def _as_leaf(g, p):
    """Gradient ``g`` placed as its parameter ``p`` (a DTensor gradient
    may come out of the backward pass partial or otherwise sharded)."""
    if SH.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _sharded(tree) -> bool:
    return any(SH.is_dtensor(t) for t in pytree.leaves(tree))


def _constants_replicated(tree):
    """``implicit_replication()`` when ``tree`` holds DTensors: the plain
    tensors the model builds (RoPE tables, masks, positions, states)
    then count as replicated over the mesh."""
    if not _sharded(tree):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _microbatch(v, n: int, i: int):
    """Microbatch ``i`` of ``n`` of batch leaf ``v``: rows ``i * B/n`` to
    ``(i + 1) * B/n``.  A DTensor leaf is split on each rank, its own
    rows in ``n`` parts, so that every microbatch stays placed as the
    batch is and nothing is sent (on a one-rank mesh that is the same
    split).  Where ``n`` does not divide a rank's rows, the microbatch
    is the global rows, gathered and placed by the batch rule
    (:func:`repro_torch.distributed.sharding.batch_axes`)."""
    if not SH.is_dtensor(v):
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    from torch.distributed.tensor import DTensor
    local = v.to_local()
    if local.shape[0] % n == 0:
        part = local.reshape(n, local.shape[0] // n, *local.shape[1:])[i]
        return DTensor.from_local(part, v.device_mesh, v.placements,
                                  run_check=False)
    rows = v.full_tensor().reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    return SH.distribute(rows, SH.make_batch_shardings(v.device_mesh,
                                                       rows))


def grads_and_metrics(params, batch, cfg: ModelConfig, run: RunConfig):
    """Gradients (float32 sums over the ``grad_accum`` microbatches, each
    divided by their count) and the **last** microbatch's metrics, as the
    reference's scan gives them.  (A batch of DTensors splits into
    microbatches rank by rank, :func:`_microbatch`: the same mean
    gradient, and the metrics of other rows than a single device's.)"""
    # differentiate with respect to aliases of the leaves, so any tree
    # (an LM's parameters, a step's output, a restored checkpoint) works
    leaves = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    params = pytree.unflatten(params, leaves)
    if run.grad_accum <= 1:
        loss, metrics = lm_loss(params, batch, cfg, run)
        grads = torch.autograd.grad(loss, leaves)
        return (pytree.unflatten(params, [_as_leaf(g, p) for g, p in
                                          zip(grads, leaves)]),
                _detached(metrics))
    n = run.grad_accum
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    metrics = None
    for i in range(n):
        mb = {k: _microbatch(v, n, i) for k, v in batch.items()}
        loss, metrics = lm_loss(params, mb, cfg, run)
        for a, g, p in zip(acc, torch.autograd.grad(loss, leaves), leaves):
            a.add_(_as_leaf(g, p).to(torch.float32) / n)
        metrics = _detached(metrics)
    return pytree.unflatten(params, acc), metrics


def compression_levels(run: RunConfig) -> int:
    return int(run.grad_compression.split(":")[1]) \
        if ":" in run.grad_compression else 2


def train_step(state: TrainState, batch, cfg: ModelConfig, run: RunConfig
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, on one device or, for a state of DTensors, on
    their mesh (see the module docstring).

    Under ``REPRO_TORCH_TELEMETRY=spans`` the step and its three parts are
    device spans (CUDA events on the card): ``train.step`` around
    ``train.grads``, ``train.compress`` (when compression is on; the DWT
    plans' ``execute.*`` spans nest in it) and ``train.adamw``."""
    dev = pytree.leaves(state.params)[0].device
    with _constants_replicated(state.params), \
            T.device_span("train.step", dev,
                          compression=run.grad_compression):
        with T.device_span("train.grads", dev):
            grads, metrics = grads_and_metrics(state.params, batch, cfg,
                                               run)
        efb = state.efb
        if run.grad_compression.startswith("dwt"):
            with T.device_span("train.compress", dev):
                grads, efb = CMP.compress_with_feedback(
                    grads, efb, state.step, compression_levels(run),
                    run.compression_wavelet)
        with T.device_span("train.adamw", dev):
            params, opt, om = adamw.apply(grads, state.opt, state.params,
                                          run)
    metrics.update(om)
    return TrainState(params, opt, efb, state.step + 1), metrics


class PodReduce:
    """What the podwise step's gradient all-reduce moved: ``calls`` and
    ``bytes`` (the payload of each call, summed; the metrics' mean is
    not counted).  ``zero()`` before a run, read after it."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def zero(self):
        self.calls = self.bytes = 0


POD_REDUCE = PodReduce()


def _pod_view(t, sub, pod_dim: int):
    """DTensor ``t`` on a mesh with a ``pod`` dim (replicated over it)
    as the same local tensor on the pod's sub-mesh ``sub``; anything
    else as it is."""
    if not SH.is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor
    where = [pl for i, pl in enumerate(t.placements) if i != pod_dim]
    return DTensor.from_local(t.to_local(), sub, where, run_check=False,
                              shape=t.shape, stride=t.stride())


def _mesh_view(t, mesh, pod_dim: int):
    """The inverse of :func:`_pod_view`: a sub-mesh DTensor back on
    ``mesh``, replicated over ``pod``."""
    if not SH.is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    where = list(t.placements)
    where.insert(pod_dim, Replicate())
    return DTensor.from_local(t.to_local(), mesh, where, run_check=False,
                              shape=t.shape, stride=t.stride())


def make_train_step_podwise(mesh, cfg: ModelConfig, run: RunConfig):
    """Multi-pod train step: an explicit (compressed) cross-pod
    all-reduce.  ``mesh`` is a ``DeviceMesh`` with a ``pod`` dim
    (:func:`repro_torch.launch.mesh.make_debug_mesh` /
    ``make_production_mesh`` with ``multi_pod=True``).

    The step takes a :class:`TrainState` placed by
    ``make_state_shardings(mesh, ...)``, whose rules never name ``pod``:
    parameters and optimizer state are replicated over pods.  Its
    ``efb`` is the exception: plain tensors, each rank's own.  The step
    takes the global batch (the same on every rank) and

    * computes gradients on its pod's ``B / n_pods`` rows, through
      :func:`grads_and_metrics` over the pod's ``(data, model)`` sub-mesh
      (the sharded step's path, the batch placed by the rules);
    * exchanges, as its only cross-pod traffic, the 4^-L compressed
      slice of every leaf through ``compress_with_feedback(reduce_fn=)``,
      or the raw gradients' local shards when compression is off: an
      all-reduce ``SUM`` over ``mesh.get_group("pod")`` divided by
      ``n_pods``, written out rather than ``ReduceOp.AVG`` so that gloo
      and NCCL compute the same thing;
    * applies AdamW as the sharded step does.  Metrics are the mean over
      pods.

    Counted in :data:`POD_REDUCE` (bytes and calls of the gradient
    payload); under ``REPRO_TORCH_TELEMETRY=spans`` the spans are
    ``train_step``'s plus ``train.pod_reduce`` around each collective.

    Known caveat (the reference's design): the error-feedback residual
    is genuinely pod-local state (standard distributed EF keeps local
    error memories).  Checkpointing or resharding ``efb`` would collapse
    it to one pod's copy; averaging it instead would cost a full-size
    cross-pod all-reduce, defeating the compression.
    """
    import torch.distributed as dist
    names = SH.axis_names(mesh)
    if "pod" not in names:
        raise ValueError(f"the podwise step needs a 'pod' mesh dim; the "
                         f"mesh has {names}")
    compress = run.grad_compression.startswith("dwt")
    levels = compression_levels(run)
    pod_dim = names.index("pod")
    n_pods = mesh.shape[pod_dim]
    group = mesh.get_group("pod")
    pod = mesh.get_local_rank("pod")
    sub = mesh[tuple(a for a in names if a != "pod")]

    def pod_mean(t, count=True):
        with T.device_span("train.pod_reduce", t.device):
            out = t.contiguous().clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            if count:
                POD_REDUCE.calls += 1
                POD_REDUCE.bytes += out.numel() * out.element_size()
            return out / n_pods

    def raw_mean(g):
        if not SH.is_dtensor(g):
            return pod_mean(g)
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(pod_mean(g.to_local()), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())

    def step(state: TrainState, batch):
        def rows(a):
            return a.reshape(n_pods, a.shape[0] // n_pods, *a.shape[1:])[pod]

        local = {k: rows(v) for k, v in batch.items()}
        if _sharded(state.params):
            local = SH.distribute_tree(local,
                                       SH.make_batch_shardings(sub, local))
        to_pod = lambda tree: pytree.tree_map(
            lambda t: _pod_view(t, sub, pod_dim), tree)
        params, opt = to_pod(state.params), to_pod(state.opt)
        dev = pytree.leaves(params)[0].device
        with _constants_replicated(params), \
                T.device_span("train.step", dev,
                              compression=run.grad_compression, pods=n_pods):
            with T.device_span("train.grads", dev):
                grads, metrics = grads_and_metrics(params, local, cfg, run)
            efb = state.efb
            if compress:
                with T.device_span("train.compress", dev):
                    grads, efb = CMP.compress_with_feedback(
                        grads, efb, state.step, levels,
                        run.compression_wavelet, reduce_fn=pod_mean)
            else:
                grads = pytree.tree_map(raw_mean, grads)
            metrics = {k: pod_mean(v, count=False)
                       for k, v in metrics.items()}
            with T.device_span("train.adamw", dev):
                params, opt, om = adamw.apply(grads, opt, params, run)
        metrics.update(om)
        back = lambda tree: pytree.tree_map(
            lambda t: _mesh_view(t, mesh, pod_dim), tree)
        return TrainState(back(params), back(opt), efb,
                          state.step + 1), metrics

    return step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(params, batch, cfg: ModelConfig, max_len: int):
    """Full-context prefill -> (last logits, populated decode cache).
    Whisper encodes and computes the cross K/V; its logits are zeros."""
    with _constants_replicated(params):
        if cfg.family == "encdec":
            enc = batch["enc_embeds"]
            cache = lm.whisper_prefill(params, enc, cfg, enc.shape[0])
            return torch.zeros((enc.shape[0], C.pad_vocab(cfg.vocab_size)),
                               dtype=torch.float32, device=enc.device), cache
        return lm.prefill(params, batch["tokens"], cfg, max_len,
                          embeds=batch.get("patch_embeds"))


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One new token against the cache."""
    with _constants_replicated(params):
        if cfg.family == "encdec":
            return lm.whisper_decode_step(params, cache, tokens, cfg)
        return lm.decode_step(params, cache, tokens, cfg)
