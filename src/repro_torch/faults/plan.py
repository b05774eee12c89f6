"""Deterministic fault plans: *which* seams fail, *how*, and *when*.

A :class:`FaultPlan` is the parsed, seeded form of the
``$REPRO_TORCH_FAULTS`` environment variable (or a scenario file): a map
from **injection sites** — the seams of the stack, mirroring the span
taxonomy of :mod:`repro_torch.telemetry` — to typed :class:`FaultSpec`
s.  The plan is the single source of truth the injection hooks
(:mod:`repro_torch.faults.inject`) consult; when no plan is active every
hook is a one-branch no-op.  Grammar, sites and seeded streams are the
reference package's: the same text and seed fire on the same draws.

Grammar (``$REPRO_TORCH_FAULTS``)::

    FAULTS  := ENTRY ("," ENTRY)*
    ENTRY   := SITE "=" SPEC
    SPEC    := [KIND ":"] TRIGGER [":" SECONDS]
    KIND    := raise | hang | slow | corrupt          (default: raise)
    TRIGGER := probability float in (0, 1] | once | always
    SECONDS := float delay for hang/slow (default: hang 30.0, slow 0.01)

Examples::

    REPRO_TORCH_FAULTS="pyramid.launch=0.05"           # 5% of launches raise
    REPRO_TORCH_FAULTS="execute.forward=once"          # first call raises
    REPRO_TORCH_FAULTS="serve.batch=slow:0.5:0.02"     # 50% of batches +20 ms
    REPRO_TORCH_FAULTS="execute.forward=corrupt:once"  # NaN-poison one output
    REPRO_TORCH_FAULTS="@scenario.json"                # load a scenario file

A scenario file is JSON: ``{"seed": 7, "faults": {"site": "spec", ...}}``.

Determinism: every site draws from its own :class:`random.Random`
stream seeded from ``(seed, site)`` (``$REPRO_TORCH_FAULTS_SEED``,
default 0),
so the fire pattern of one site never depends on how many times another
site was hit — two runs of the same single-threaded workload under the
same seed inject the same faults.  (Across *threads* the k-th draw of a
site goes to whichever call arrives k-th; use ``once``/``always`` for
exact cross-thread determinism.)
"""
from __future__ import annotations

import dataclasses
import json
import threading
import zlib
from random import Random
from typing import Dict, Optional

SEED_ENV = "REPRO_TORCH_FAULTS_SEED"
FAULTS_ENV = "REPRO_TORCH_FAULTS"

#: typed failure modes an injection site can produce
KINDS = ("raise", "hang", "slow", "corrupt")

#: every registered injection site, mirroring the span taxonomy — the
#: reference's twelve, each wired where the reference has it (engine,
#: tiling, streaming, serving, profiler store)
SITES = (
    "plan.build",            # engine: DwtPlan resolution
    "execute.forward",       # engine: forward executor dispatch
    "execute.inverse",       # engine: inverse executor dispatch
    "pyramid.launch",        # cuda: fused-pyramid kernel launch (K2/K3)
    "tiling.halo_gather",    # tiling: halo-window gather
    "stream.host_gather",    # streaming: host-side band read
    "stream.h2d_dispatch",   # streaming: band h2d copy + async dispatch
    "stream.drain",          # streaming: device->host band drain
    "serve.batch",           # serve: batched plan execution (worker)
    "serve.stack_h2d",       # serve: host stack + device transfer
    "profiler.store_read",   # profiler: JSONL trace-store read
    "profiler.store_write",  # profiler: JSONL trace-store append
)

#: default sleep per kind (seconds): "hang" outlives any sane request
#: deadline (recovery must come from the caller's deadline, not the
#: fault ending); "slow" models a straggler
DEFAULT_HANG_S = 30.0
DEFAULT_SLOW_S = 0.01


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault: what a site does when its trigger fires."""

    site: str
    kind: str                      # "raise" | "hang" | "slow" | "corrupt"
    prob: Optional[float] = None   # None with once/always
    once: bool = False             # fire exactly once, then disarm
    delay_s: Optional[float] = None  # hang/slow sleep override

    @property
    def sleep_s(self) -> float:
        if self.delay_s is not None:
            return self.delay_s
        return DEFAULT_HANG_S if self.kind == "hang" else DEFAULT_SLOW_S


def _parse_spec(site: str, text: str) -> FaultSpec:
    parts = text.split(":")
    kind = "raise"
    if parts and parts[0] in KINDS:
        kind = parts.pop(0)
    if not parts or not parts[0]:
        raise ValueError(
            f"fault spec for site {site!r} has no trigger "
            f"(got {text!r}); expected [kind:]prob|once|always[:seconds]")
    trigger, rest = parts[0], parts[1:]
    prob: Optional[float] = None
    once = False
    if trigger == "once":
        once = True
    elif trigger == "always":
        pass
    else:
        try:
            prob = float(trigger)
        except ValueError:
            raise ValueError(
                f"fault trigger for site {site!r} must be a probability, "
                f"'once' or 'always'; got {trigger!r}") from None
        if not 0.0 < prob <= 1.0:
            raise ValueError(
                f"fault probability for site {site!r} must be in (0, 1], "
                f"got {prob}")
    delay_s: Optional[float] = None
    if rest:
        if len(rest) > 1:
            raise ValueError(
                f"fault spec for site {site!r} has trailing fields: {text!r}")
        try:
            delay_s = float(rest[0])
        except ValueError:
            raise ValueError(
                f"fault delay for site {site!r} must be seconds (float), "
                f"got {rest[0]!r}") from None
    return FaultSpec(site=site, kind=kind, prob=prob, once=once,
                     delay_s=delay_s)


def parse_faults(text: str) -> Dict[str, FaultSpec]:
    """Parse the ``$REPRO_TORCH_FAULTS`` grammar into per-site specs.

    Unknown sites are an actionable error (typo'd sites silently never
    firing would make a chaos run vacuously green).
    """
    specs: Dict[str, FaultSpec] = {}
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"malformed fault entry {entry!r}; expected site=spec "
                f"(grammar: repro_torch.faults.plan)")
        site, _, spec = entry.partition("=")
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; registered sites: "
                f"{', '.join(SITES)}")
        specs[site] = _parse_spec(site, spec.strip())
    return specs


def load_scenario(path: str) -> "FaultPlan":
    """Load a scenario file: ``{"seed": int, "faults": {site: spec}}``."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("faults"), dict):
        raise ValueError(
            f"scenario file {path!r} must be a JSON object with a "
            f"'faults' mapping of site -> spec string")
    specs: Dict[str, FaultSpec] = {}
    for site, spec in doc["faults"].items():
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} in {path!r}; registered "
                f"sites: {', '.join(SITES)}")
        specs[site] = _parse_spec(site, str(spec))
    return FaultPlan(specs, seed=int(doc.get("seed", 0)))


class FaultPlan:
    """A seeded, armed set of :class:`FaultSpec` s.

    ``should_fire(site, kinds)`` performs the (deterministic) trigger
    draw and returns the spec when the site's fault fires *and* its kind
    is one the hook can express (raise/hang/slow at call sites,
    corrupt at value sites) — a corrupt spec never consumes draws at a
    raise-only hook and vice versa.  Thread-safe: one lock guards the
    draw + fire-count update.
    """

    def __init__(self, specs: Dict[str, FaultSpec], seed: int = 0):
        self.specs = dict(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rng: Dict[str, Random] = {
            site: Random(zlib.crc32(f"{self.seed}:{site}".encode()))
            for site in self.specs}
        self.fired: Dict[str, int] = {site: 0 for site in self.specs}

    @classmethod
    def from_text(cls, text: str, seed: int = 0) -> "FaultPlan":
        text = text.strip()
        if text.startswith("@"):
            return load_scenario(text[1:])
        return cls(parse_faults(text), seed=seed)

    def should_fire(self, site: str, kinds=KINDS) -> Optional[FaultSpec]:
        spec = self.specs.get(site)
        if spec is None or spec.kind not in kinds:
            return None
        with self._lock:
            if spec.once and self.fired[site] > 0:
                return None
            if spec.prob is not None \
                    and self._rng[site].random() >= spec.prob:
                return None
            self.fired[site] += 1
        return spec

    def stats(self) -> dict:
        """Armed sites and per-site fire counts (``engine.stats()``)."""
        return {"seed": self.seed,
                "sites": {site: {"kind": s.kind,
                                 "trigger": ("once" if s.once else
                                             "always" if s.prob is None
                                             else s.prob),
                                 "fired": self.fired[site]}
                          for site, s in sorted(self.specs.items())}}

    def __repr__(self) -> str:
        arms = ", ".join(f"{s}={self.specs[s].kind}" for s in self.specs)
        return f"FaultPlan(seed={self.seed}, {arms})"
