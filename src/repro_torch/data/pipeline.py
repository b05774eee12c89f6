"""Deterministic sharded data pipeline with exact resume (the port's copy
of the reference's, numpy only: synthetic batches equal the reference's
bit for bit; a ``.bin`` corpus is seeded by :func:`path_seed`).

Two sources behind one interface:

* ``SyntheticSource`` — seeded Zipf-ish token streams (used by the smoke
  tests, examples and benchmarks; no external data gates).
* ``BinTokenSource`` — memory-mapped ``uint16/uint32`` token files
  (``.bin``), the standard pretraining-corpus format.

Determinism/fault-tolerance contract: ``batch_at(step)`` is a pure
function of (seed, step, shard) — a restarted/elastically-resized job
replays exactly the batches it would have seen, because the stream is
indexed, never iterated.  This is what checkpoint/restart resumes from
(checkpoint stores just ``step``).
"""
from __future__ import annotations

import dataclasses
import zlib
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticSource:
    """Seeded synthetic token stream (Zipf exponent ~1 + n-gram structure
    so losses actually decrease during the example training runs)."""

    vocab_size: int
    seed: int = 0

    def tokens(self, step: int, shard: int, batch: int, seq: int
               ) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        v = self.vocab_size
        # zipf-ish marginal
        base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
        base = np.minimum(base - 1, v - 1)
        # inject learnable bigram structure: even positions predict odd
        out = base.copy()
        out[:, 1::2] = (out[:, 0::2] * 31 + 7) % v
        return out.astype(np.int32)


def path_seed(path: str) -> int:
    """A 16-bit seed from a corpus path, the same in every process.

    The reference seeds from ``hash(path) & 0xFFFF``; ``str`` hashes are
    salted per process (``PYTHONHASHSEED``), so a restarted job would
    replay other batches.  The port takes the CRC-32 of the path's UTF-8
    bytes instead, keeping ``batch_at`` a pure function of (path, step,
    shard)."""
    return zlib.crc32(str(path).encode("utf-8")) & 0xFFFF


@dataclasses.dataclass
class BinTokenSource:
    """Memory-mapped token-file corpus (one flat token stream)."""

    path: str
    vocab_size: int
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")

    def tokens(self, step: int, shard: int, batch: int, seq: int
               ) -> np.ndarray:
        n = len(self._data)
        per = batch * (seq + 1)
        rng = np.random.default_rng(
            np.random.SeedSequence([path_seed(self.path), step, shard]))
        starts = rng.integers(0, n - seq - 1, size=batch)
        return np.stack([self._data[s:s + seq] for s in starts]
                        ).astype(np.int32)


@dataclasses.dataclass
class Pipeline:
    """Shape-aware batch factory for one data-parallel shard."""

    cfg: ModelConfig
    source: SyntheticSource
    shard: int = 0
    num_shards: int = 1

    def batch_at(self, step: int, shape: ShapeConfig
                 ) -> Dict[str, np.ndarray]:
        b = max(shape.global_batch // self.num_shards, 1)
        s = shape.seq_len
        cfg = self.cfg
        if cfg.family == "encdec":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.source.seed, step, self.shard]))
            return {
                "enc_embeds": rng.standard_normal(
                    (b, s, cfg.d_model)).astype(np.float32) * 0.02,
                "dec_tokens": self.source.tokens(
                    step, self.shard, b, cfg.max_target_len),
            }
        batch = {"tokens": self.source.tokens(step, self.shard, b, s)}
        if cfg.family == "vlm" and cfg.frontend_stub:
            n_patches = min(1024, s // 4)
            rng = np.random.default_rng(
                np.random.SeedSequence([self.source.seed, step, self.shard,
                                        1]))
            batch["patch_embeds"] = rng.standard_normal(
                (b, n_patches, cfg.d_model)).astype(np.float32) * 0.02
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            from repro_torch.configs.base import TRAIN_4K
            yield self.batch_at(step, TRAIN_4K)
            step += 1


def make_pipeline(cfg: ModelConfig, seed: int = 0, shard: int = 0,
                  num_shards: int = 1,
                  bin_path: Optional[str] = None) -> Pipeline:
    if bin_path and Path(bin_path).exists():
        src = BinTokenSource(bin_path, cfg.vocab_size)
    else:
        src = SyntheticSource(cfg.vocab_size, seed)
    return Pipeline(cfg=cfg, source=src, shard=shard, num_shards=num_shards)
