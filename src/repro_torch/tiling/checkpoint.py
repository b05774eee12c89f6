"""Journaled band checkpoints: killable, resumable gigapixel streams.

A multi-hour :func:`~repro_torch.tiling.stream.stream_dwt2` over a
memory-mapped gigapixel image should not restart from scratch when the
process is killed.  This module gives the streaming executor a
write-ahead checkpoint:

* the output pyramid lives in ``.npy``-backed memmaps inside the
  checkpoint directory (created once, reopened on resume);
* after each band's rows are written, the memmaps are flushed and ONE
  checksummed record is fsync-appended to ``journal.jsonl`` — the
  write-ahead contract: a band is trusted if and only if its journal
  record is durable, so a kill at any instant loses at most the band
  in flight;
* ``manifest.json`` pins the full stream configuration; a resume with
  any differing parameter is refused (:class:`CheckpointMismatch`)
  rather than silently blending two transforms.

Resume skips journaled bands and recomputes the rest.  Every band runs
the same elementwise arithmetic whatever else ran, so the resumed
pyramid is bit-identical to an uninterrupted run on every backend.
The manifest, journal records and checksums are byte for byte the
reference package's: a checkpoint either package wrote reads back in
the other.

A torn tail line (kill mid-append) fails its checksum, is dropped, and
is counted in ``stats()["torn_records"]``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import ioutil

MANIFEST = "manifest.json"
JOURNAL = "journal.jsonl"
_VERSION = 1


class CheckpointMismatch(ValueError):
    """Resume attempted with a configuration that differs from the one
    recorded in the checkpoint's manifest."""


def _record(band: int) -> str:
    payload = json.dumps({"band": int(band)}, sort_keys=True)
    return json.dumps({"band": int(band),
                       "crc": ioutil.line_checksum(payload)})


def _read_journal(path: str) -> Tuple[set, int]:
    """Valid-prefix read of the band journal: (completed bands, torn
    records dropped).  Any unparsable or checksum-failing line is torn —
    only a kill mid-append produces one, and only at the tail."""
    done: set = set()
    torn = 0
    if not os.path.exists(path):
        return done, torn
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                band = int(rec["band"])
                payload = json.dumps({"band": band}, sort_keys=True)
                if not ioutil.checksum_ok(payload, rec["crc"]):
                    raise ValueError("checksum mismatch")
            except (ValueError, KeyError, TypeError):
                torn += 1
                continue
            done.add(band)
    return done, torn


class BandCheckpoint:
    """One streaming run's durable state: config manifest, memmapped
    output pyramid, and the fsync'd journal of completed bands.

    Built by :func:`open_checkpoint`; the streaming executor writes each
    band's rows directly into :attr:`ll` / :attr:`details` (ordinary
    ndarray views backed by files) and calls :meth:`commit_band` once
    the band is fully written.
    """

    def __init__(self, path: str, config: Dict, *, resumed: bool,
                 completed: set, torn: int,
                 ll: np.ndarray, details: List[Tuple[np.ndarray, ...]]):
        self.path = path
        self.config = config
        self.resumed = resumed
        self.completed = completed
        self.torn_records = torn
        self.ll = ll
        self.details = details

    @property
    def nr_bands(self) -> int:
        return int(self.config["nr"])

    @property
    def complete(self) -> bool:
        return len(self.completed) >= self.nr_bands

    def commit_band(self, band: int) -> None:
        """Durably mark ``band`` done: flush its memmapped rows, then
        fsync-append the journal record (data before journal — a
        journaled band is always readable)."""
        self.ll.flush()
        for det in self.details:
            for plane in det:
                plane.flush()
        ioutil.fsync_append(os.path.join(self.path, JOURNAL),
                            _record(band))
        self.completed.add(int(band))

    def stats(self) -> dict:
        return {"path": self.path, "resumed": self.resumed,
                "bands_done": len(self.completed),
                "bands_total": self.nr_bands,
                "torn_records": self.torn_records}


def _plane_shapes(h: int, w: int, levels: int) -> Tuple[Tuple[int, int],
                                                        list]:
    """Output geometry, coarsest-first details (engine convention)."""
    ll = (h >> levels, w >> levels)
    det = [(h >> (lvl + 1), w >> (lvl + 1))
           for lvl in (levels - 1 - k for k in range(levels))]
    return ll, det


def _open_planes(path: str, config: Dict, mode: str):
    h, w, levels = config["h"], config["w"], config["levels"]
    dtype = np.dtype(config["dtype"])
    ll_shape, det_shapes = _plane_shapes(h, w, levels)
    ll = np.lib.format.open_memmap(
        os.path.join(path, "ll.npy"), mode=mode, dtype=dtype,
        shape=ll_shape)
    details = [
        tuple(np.lib.format.open_memmap(
            os.path.join(path, f"det_{k}_{j}.npy"), mode=mode,
            dtype=dtype, shape=det_shapes[k]) for j in range(3))
        for k in range(levels)]
    return ll, details


def open_checkpoint(path: str, config: Dict) -> BandCheckpoint:
    """Create (or resume) the band checkpoint at directory ``path``.

    ``config`` is the full stream configuration (transform parameters +
    image geometry + band count); on resume it must match the manifest
    exactly or :class:`CheckpointMismatch` is raised with the first
    differing key.
    """
    path = os.fspath(path)
    config = {k: config[k] for k in sorted(config)}
    manifest_path = os.path.join(path, MANIFEST)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            saved = json.load(f)
        if saved.get("version") != _VERSION:
            raise CheckpointMismatch(
                f"checkpoint {path!r} has version "
                f"{saved.get('version')!r}, expected {_VERSION}")
        old = saved.get("config", {})
        for k in sorted(set(old) | set(config)):
            a, b = old.get(k), config.get(k)
            # JSON round-trips tuples as lists; compare canonically
            if json.loads(json.dumps(a)) != json.loads(json.dumps(b)):
                raise CheckpointMismatch(
                    f"checkpoint {path!r} was written with {k}={a!r} "
                    f"but this stream uses {k}={b!r}; pass a fresh "
                    f"checkpoint directory to change configuration")
        done, torn = _read_journal(os.path.join(path, JOURNAL))
        ll, details = _open_planes(path, config, mode="r+")
        return BandCheckpoint(path, config, resumed=True, completed=done,
                              torn=torn, ll=ll, details=details)
    os.makedirs(path, exist_ok=True)
    ll, details = _open_planes(path, config, mode="w+")
    ioutil.atomic_write_text(
        manifest_path,
        json.dumps({"version": _VERSION, "config": config},
                   sort_keys=True, indent=1))
    return BandCheckpoint(path, config, resumed=False, completed=set(),
                          torn=0, ll=ll, details=details)
