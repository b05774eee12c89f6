"""Persistent per-plan execution trace store (JSONL).

One :class:`TraceRecord` per measured plan execution: the full
configuration of a :class:`~repro_torch.engine.plan.PlanKey`, the
fingerprint of the device it was measured on (the key's ``device`` enters
here, not as a config field), the measured wall-clock, the launch count
and the modelled device-memory bytes (the cost-model features, see
:mod:`repro_torch.profiler.model`).  Records append to a JSON-lines file
— ``PROFILE_STORE_TORCH.jsonl`` at the root of the checkout by default,
or the path in ``$REPRO_TORCH_PROFILE_STORE`` — so stores can be merged
across machines (records of other devices are filtered out at query
time by fingerprint) and re-read to reproduce identical predictions.

The line format is the reference package's (same ``v``, same field
names, same crc32 over the canonical payload): for one record both
packages write the same line, and each parses the other's.  The reader
drops (and counts, in
``repro_profile_store_corrupt_records_total{reason}``) any line that
fails to parse or checksum, so a kill mid-append or a bad hand-merge
costs one record instead of poisoning predictions.  Lines without a
``crc`` field are accepted.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
from typing import List, Optional, Tuple

from repro_torch import ioutil
from repro_torch import telemetry as T
from repro_torch.engine.autotune import device_fingerprint
from repro_torch.faults import inject as FI

CORRUPT_RECORDS = T.counter(
    "repro_profile_store_corrupt_records_total",
    "trace-store lines dropped at read time (torn tail, checksum "
    "mismatch, unknown schema)", labelnames=("reason",))

STORE_ENV = "REPRO_TORCH_PROFILE_STORE"
# src/repro_torch/profiler/store.py -> profiler -> repro_torch -> src -> root
DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "PROFILE_STORE_TORCH.jsonl"

#: PlanKey fields that identify *what* is being transformed — everything
#: except the (backend, fuse, tap_opt) choice dimensions the auto
#: selector optimizes over (the device is the record's fingerprint)
CONFIG_FIELDS = ("wavelet", "scheme", "levels", "shape", "dtype",
                 "optimize", "boundary", "compute_dtype", "tiles")
#: the choice dimensions
CHOICE_FIELDS = ("backend", "fuse", "tap_opt")


def store_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(STORE_ENV, str(DEFAULT_PATH)))


def runtime_meta(device="cuda") -> dict:
    """Attribution metadata for trace records and the chip script's
    output: which device and software stack produced a measurement.
    ``plain_kernels`` is true on the CPU, where the ``"cuda"`` backend
    runs the kernels' plain versions, so its times are theirs."""
    import platform as _platform

    import torch

    from repro_torch.engine.plan import resolve_device
    d = resolve_device(device)
    name = torch.cuda.get_device_name(d.index) if d.type == "cuda" else "cpu"
    return {"device_kind": name,
            "platform": d.type,
            "fingerprint": device_fingerprint(d),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "python_version": _platform.python_version(),
            "plain_kernels": d.type == "cpu"}


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One measured plan execution."""

    fingerprint: str                  # device identity (type:name)
    wavelet: str
    scheme: str
    levels: int
    shape: Tuple[int, ...]
    dtype: str
    backend: str
    optimize: bool
    fuse: str
    boundary: str
    compute_dtype: str
    tap_opt: str
    tiles: Optional[Tuple[int, int]]
    block: Optional[Tuple[int, int]]  # block target the plan was built at
    time_s: float                     # measured median wall-clock/execution
    hbm_bytes: int                    # modelled bytes (cost-model feature)
    launches: int                     # modelled launches (cost-model feature)
    meta: dict = dataclasses.field(default_factory=dict)

    def matches_key(self, key) -> bool:
        """True when this record measures the same *configuration* as
        ``key`` (all PlanKey fields except the backend/fuse/tap_opt
        choice dimensions)."""
        return all(getattr(self, f) == getattr(key, f)
                   for f in CONFIG_FIELDS)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["v"] = 1
        payload = json.dumps(d, sort_keys=True, default=str)
        d["crc"] = ioutil.line_checksum(payload)
        return json.dumps(d, sort_keys=True, default=str)

    @classmethod
    def from_json(cls, line: str) -> Optional["TraceRecord"]:
        rec, _reason = parse_line(line)
        return rec

    @classmethod
    def _from_dict(cls, d: dict) -> Optional["TraceRecord"]:
        try:
            return cls(
                fingerprint=str(d["fingerprint"]),
                wavelet=str(d["wavelet"]), scheme=str(d["scheme"]),
                levels=int(d["levels"]),
                shape=tuple(int(v) for v in d["shape"]),
                dtype=str(d["dtype"]), backend=str(d["backend"]),
                optimize=bool(d["optimize"]), fuse=str(d["fuse"]),
                boundary=str(d["boundary"]),
                compute_dtype=str(d["compute_dtype"]),
                tap_opt=str(d["tap_opt"]),
                tiles=(None if d.get("tiles") is None
                       else tuple(int(v) for v in d["tiles"])),
                block=(None if d.get("block") is None
                       else tuple(int(v) for v in d["block"])),
                time_s=float(d["time_s"]), hbm_bytes=int(d["hbm_bytes"]),
                launches=int(d["launches"]),
                meta=dict(d.get("meta") or {}))
        except (KeyError, TypeError, ValueError):
            return None


def parse_line(line: str) -> Tuple[Optional[TraceRecord], Optional[str]]:
    """Parse one store line -> ``(record, None)`` or ``(None, reason)``
    with reason in {"parse", "checksum", "schema"}.  Lines with no
    ``crc`` field skip the checksum gate."""
    try:
        d = json.loads(line)
    except ValueError:
        return None, "parse"
    if not isinstance(d, dict):
        return None, "schema"
    crc = d.pop("crc", None)
    if crc is not None:
        payload = json.dumps(d, sort_keys=True, default=str)
        try:
            ok = ioutil.checksum_ok(payload, crc)
        except (TypeError, ValueError):
            ok = False
        if not ok:
            return None, "checksum"
    if d.pop("v", None) != 1:
        return None, "schema"
    rec = TraceRecord._from_dict(d)
    return (rec, None) if rec is not None else (None, "schema")


def record_from_key(key, block, time_s: float, hbm_bytes: int,
                    launches: int, meta: Optional[dict] = None
                    ) -> TraceRecord:
    """Build a :class:`TraceRecord` for a measurement of ``key`` on the
    key's device."""
    return TraceRecord(
        fingerprint=device_fingerprint(key.device),
        wavelet=key.wavelet, scheme=key.scheme, levels=key.levels,
        shape=tuple(key.shape), dtype=key.dtype, backend=key.backend,
        optimize=key.optimize, fuse=key.fuse, boundary=key.boundary,
        compute_dtype=key.compute_dtype, tap_opt=key.tap_opt,
        tiles=key.tiles,
        block=None if block is None else (int(block[0]), int(block[1])),
        time_s=float(time_s), hbm_bytes=int(hbm_bytes),
        launches=int(launches), meta=dict(meta or {}))


class TraceStore:
    """Append-only JSONL store of :class:`TraceRecord` s.

    Loads lazily and caches by ``(mtime_ns, size)`` so repeated queries
    (one per plan-cache miss under ``backend="auto"``) re-read the file
    only after it changed; malformed lines are skipped and counted.
    Thread-safe: serving workers may resolve plans concurrently.
    """

    def __init__(self, path=None):
        self.path = pathlib.Path(path) if path is not None else store_path()
        self._stamp = None
        self._records: List[TraceRecord] = []
        self._lock = threading.Lock()

    def _load(self) -> List[TraceRecord]:
        with self._lock:
            try:
                st = self.path.stat()
                stamp = (st.st_mtime_ns, st.st_size)
            except OSError:
                self._stamp, self._records = None, []
                return self._records
            if stamp == self._stamp:
                return self._records
            records = []
            try:
                FI.maybe_inject("profiler.store_read", path=str(self.path))
                with open(self.path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        rec, reason = parse_line(line)
                        if rec is not None:
                            records.append(rec)
                        else:
                            CORRUPT_RECORDS.inc(reason=reason)
            except OSError:
                records = []
            self._stamp, self._records = stamp, records
            return records

    def records(self, fingerprint: Optional[str] = None
                ) -> List[TraceRecord]:
        """All records (optionally only those measured on one device)."""
        recs = self._load()
        if fingerprint is None:
            return list(recs)
        return [r for r in recs if r.fingerprint == fingerprint]

    def append(self, record: TraceRecord) -> None:
        self.extend([record])

    def extend(self, records) -> None:
        records = list(records)
        if not records:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        FI.maybe_inject("profiler.store_write", path=str(self.path),
                        n=len(records))
        # one buffered write + fsync: a kill leaves at most one torn
        # tail line, which parse_line detects (checksum) on re-read
        text = "".join(rec.to_json() + "\n" for rec in records)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())
            self._stamp = None           # force re-read on next query

    def __len__(self) -> int:
        return len(self._load())
