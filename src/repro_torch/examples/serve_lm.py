"""Serving example: batched prefill + autoregressive decode with KV cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    [--arch mixtral-8x7b]

Uses the smoke config of any registry architecture; demonstrates the
prefill -> decode_step handoff (the functions the decode_32k / long_500k
dry-run cells run), greedy sampling, and per-token latency.

The port of ``examples/serve_lm.py``, with the same flags, defaults and
lines.  What changed in the port:

* parameters, prompts and whisper's encoder input come from
  ``torch.Generator`` s on the device seeded 0, 1 and 2 (the
  reference's ``jax.random`` keys; the values differ);
* prefill and decode run eagerly on the card (``device="cuda"``; the
  reference jits the decode step), or on the CPU with ``device="cpu"``,
  and the host clock is read after a ``torch.cuda.synchronize``;
* :func:`generate` can feed given tokens instead of its greedy picks
  (``teacher``), which is how its logits are held against a full
  forward.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.engine.plan import resolve_device
from repro_torch.models import lm
from repro_torch.runtime import steps


def init(cfg, batch, prompt_len, device="cuda"):
    """Parameters, prompts (``batch`` x ``prompt_len`` token ids) and,
    for the encoder-decoder family, encoder embeddings, on ``device``."""
    dev = resolve_device(device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(gen(0), cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen(1), device=dev)
    enc = None
    if cfg.family == "encdec":
        enc = torch.randn((batch, prompt_len, cfg.d_model),
                          generator=gen(2), device=dev) * 0.02
    return params, prompts, enc


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params, cfg, prompts, new_tokens, enc=None, teacher=None):
    """Prefill the prompts (whisper: encode ``enc`` and start from token
    0) and decode ``new_tokens - 1`` more greedily, or feeding
    ``teacher``'s columns in turn; returns the tokens (a ``batch`` x
    ``new_tokens`` array), the logits of the prefill (decoder-only
    families) and of every decode step, and the host times."""
    dev = prompts.device
    b, prompt_len = prompts.shape
    max_len = prompt_len + new_tokens
    logits_seen = []
    prefill_s = None
    if cfg.family == "encdec":
        cache = lm.whisper_prefill(params, enc, cfg, b)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        decode = lambda c, t: lm.whisper_decode_step(params, c, t, cfg)
    else:
        _sync(dev)
        t0 = time.time()
        logits, cache = lm.prefill(params, prompts, cfg, max_len)
        _sync(dev)
        prefill_s = time.time() - t0
        print(f"prefill {prompt_len} tokens x{b}: {prefill_s:.2f}s")
        logits_seen.append(logits)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        decode = lambda c, t: steps.decode_step(params, c, t, cfg)

    out_tokens = [tok]
    _sync(dev)
    t0 = time.time()
    for i in range(new_tokens - 1):
        feed = tok if teacher is None else teacher[:, i:i + 1]
        logits, cache = decode(cache, feed)
        logits_seen.append(logits)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out_tokens.append(tok)
    _sync(dev)
    dt = time.time() - t0
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    ms = dt / max(new_tokens - 1, 1) * 1000
    print(f"decoded {new_tokens - 1} tokens x{b} in {dt:.2f}s"
          f" ({ms:.0f} ms/token incl. dispatch)")
    print("sample generations (token ids):")
    for row in range(min(2, b)):
        print(f"  seq{row}: {gen[row][:16].tolist()} ...")
    return dict(tokens=gen, logits=logits_seen, prefill_s=prefill_s,
                decode_s=dt, ms_per_token=ms)


def serve(arch="mixtral-8x7b", batch=4, prompt_len=32, new_tokens=32,
          device="cuda", cfg=None):
    """``arch``'s SMOKE config (or ``cfg``) initialised on ``device`` and
    served greedily; returns :func:`generate`'s dict with the config,
    parameters, prompts and encoder input."""
    if cfg is None:
        cfg, _ = get_config(arch, smoke=True)
    params, prompts, enc = init(cfg, batch, prompt_len, device)
    out = generate(params, cfg, prompts, new_tokens, enc=enc)
    return dict(out, cfg=cfg, params=params, prompts=prompts, enc=enc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)
    serve(args.arch, args.batch, args.prompt_len, args.new_tokens)


if __name__ == "__main__":
    main()
