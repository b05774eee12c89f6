"""Autotuned block-size table: measured best window-kernel blocks per
configuration and device.

A sweep (``chip_smoke.py`` phase 3f, or any caller of
:func:`save_entry`) measures ``block_target`` candidates per ``(scheme,
shape, fuse, backend)`` and persists the winner into a small JSON table
(``BLOCK_TABLE_TORCH.json`` at the root of the checkout by default, or
the path in ``$REPRO_TORCH_BLOCK_TABLE``).
:func:`repro_torch.engine.plan.build_plan` consults it before falling
back to :data:`~repro_torch.kernels.tap_window.BLOCK_TARGET`.  An entry
is a plane-space *target*: it still passes the shared-memory guard
(:func:`~repro_torch.kernels.tap_window.fit_block`), so no entry can
produce a block that does not fit.

Entries are **measured on one device**, so every key carries the
fingerprint of the device the *plan* runs on
(:func:`device_fingerprint`: ``"cuda:<name>"`` or ``"cpu:cpu"``):
``key = "scheme|HxW|fuse|backend|fp"``.  One process runs CPU and CUDA
plans side by side, so the fingerprint is taken per plan key, never
from the process's first device.  :func:`lookup` returns only entries of
the key's device; entries for another device (or without a fingerprint)
fall back to the default and are counted in :data:`DEVICE_FALLBACKS`
(surfaced through ``repro_torch.engine.stats()["block_table"]``).

The loaded table is memoized per process and re-read only when the
``$REPRO_TORCH_BLOCK_TABLE`` path changes or :func:`clear_cache` is
called (:func:`save_entry` clears it), so plan-cache misses never pay
repeated disk I/O.
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import threading
from typing import Optional, Tuple

import torch

from repro_torch import ioutil
from repro_torch import telemetry as T

TABLE_ENV = "REPRO_TORCH_BLOCK_TABLE"
# src/repro_torch/engine/autotune.py -> engine -> repro_torch -> src -> root
DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "BLOCK_TABLE_TORCH.json"

# device-mismatch observability: entries that exist for this config but
# were tuned on another device (or predate fingerprinting) and were
# therefore NOT applied
DEVICE_FALLBACKS = T.counter(
    "repro_block_table_device_fallbacks_total",
    "block-table entries skipped because they were tuned on a different "
    "device (or predate fingerprinting)")

#: dict-style view of the counter (the reference's alias)
COUNTERS = T.CounterAlias({
    "device_fallbacks": ("repro_block_table_device_fallbacks_total", {}),
})

_cache: dict = {"path": None, "table": {}}
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _fingerprint(device: str) -> str:
    from repro_torch.engine.plan import resolve_device  # plan -> autotune
    d = resolve_device(device)          # a CUDA device with no card raises
    if d.type == "cuda":
        return ("cuda:" + torch.cuda.get_device_name(d.index)).replace(
            "|", "/")
    return "cpu:cpu"


def device_fingerprint(device) -> str:
    """Stable identity of the device a plan key runs on:
    ``"cuda:" + torch.cuda.get_device_name(index)`` (e.g.
    ``cuda:NVIDIA H100 80GB HBM3``) or ``"cpu:cpu"``.  ``|`` is reserved
    as the table-key separator and sanitized out."""
    return _fingerprint(str(device))


def table_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(TABLE_ENV, str(DEFAULT_PATH)))


def table_key(scheme: str, shape: Tuple[int, int], fuse: str,
              backend: str, fingerprint: Optional[str] = None) -> str:
    base = f"{scheme}|{shape[0]}x{shape[1]}|{fuse}|{backend}"
    return base if fingerprint is None else f"{base}|{fingerprint}"


def load_table() -> dict:
    """Load the block table, memoized per process: the file is read once
    per ``$REPRO_TORCH_BLOCK_TABLE`` path and served from memory
    afterwards (no per-lookup ``stat``), until the path changes or
    :func:`clear_cache` invalidates it.  Missing file -> empty table."""
    path = str(table_path())
    with _lock:
        if _cache["path"] == path:
            return _cache["table"]
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    if not isinstance(table, dict):
        table = {}
    with _lock:
        _cache.update(path=path, table=table)
    return table


def clear_cache() -> None:
    with _lock:
        _cache.update(path=None, table={})


def lookup(scheme: str, shape: Tuple[int, int], fuse: str, backend: str,
           device) -> Optional[Tuple[int, int]]:
    """Best measured block target for one configuration **on the given
    device**, or None (use the static default).  Entries tuned on another
    device — or written before fingerprinting — never apply; they bump
    :data:`DEVICE_FALLBACKS` instead."""
    table = load_table()
    if not table:
        return None
    base = table_key(scheme, shape, fuse, backend)
    entry = table.get(table_key(scheme, shape, fuse, backend,
                                device_fingerprint(device)))
    if entry is None:
        if base in table or any(k.startswith(base + "|") for k in table):
            DEVICE_FALLBACKS.inc()
        return None
    try:
        bh, bw = int(entry[0]), int(entry[1])
    except (TypeError, ValueError, IndexError):
        return None
    return (bh, bw) if bh > 0 and bw > 0 else None


def save_entry(scheme: str, shape: Tuple[int, int], fuse: str, backend: str,
               block: Tuple[int, int], path=None,
               fingerprint: Optional[str] = None, device="cuda") -> None:
    """Merge one winner into the table on disk (read-modify-write),
    keyed by ``device``'s fingerprint unless one is given."""
    p = pathlib.Path(path) if path is not None else table_path()
    table = {}
    if p.exists():
        try:
            with open(p) as f:
                table = json.load(f)
        except (OSError, ValueError):
            table = {}
    fp = fingerprint if fingerprint is not None else \
        device_fingerprint(device)
    table[table_key(scheme, shape, fuse, backend, fp)] = [int(block[0]),
                                                          int(block[1])]
    # atomic replace: a kill mid-save leaves the previous complete table
    ioutil.atomic_write_text(
        str(p), json.dumps(table, indent=1, sort_keys=True) + "\n")
    clear_cache()
