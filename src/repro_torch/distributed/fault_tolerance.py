"""Liveness bookkeeping: heartbeats, stragglers, deaths and quorum.

The parts of the reference's ``distributed/fault_tolerance.py`` the
serving runtime uses (:mod:`repro_torch.serve.scheduler`): a coordinator
tracks hosts — here, the server's device workers beating in-process —
by the age of their last heartbeat.  A host silent for
``soft_timeout_s`` is a straggler, one silent for ``hard_timeout_s``
(or reported dead out of band, :meth:`HeartbeatTracker.mark_dead`) is
dead; a dead host calls for an elastic restart (the server spawns a
replacement worker), and with quorum present stragglers may be skipped.
Pure logic with an injectable clock, so tests need not sleep.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class FaultToleranceConfig:
    soft_timeout_s: float = 30.0     # straggler: may skip this step
    hard_timeout_s: float = 300.0    # dead: trigger elastic restart
    quorum_fraction: float = 0.75    # min fraction of hosts per update


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    step: int = 0
    # set by mark_dead(): a death *reported* by the runtime (a crashed
    # serving worker) rather than inferred from heartbeat age — the host
    # counts as dead immediately
    marked_dead: bool = False


class HeartbeatTracker:
    """Coordinator-side liveness bookkeeping (pure logic: the transport
    is whatever delivers :meth:`beat` calls)."""

    def __init__(self, hosts: List[str],
                 cfg: Optional[FaultToleranceConfig] = None,
                 clock=time.monotonic):
        self.cfg = cfg or FaultToleranceConfig()
        self.clock = clock
        now = clock()
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_heartbeat=now) for h in hosts}

    def register(self, host: str) -> None:
        """Add a host mid-run (elastic grow / replacement worker)."""
        self.hosts[host] = HostState(last_heartbeat=self.clock())

    def beat(self, host: str, step: int) -> None:
        st = self.hosts[host]
        st.last_heartbeat = self.clock()
        st.step = step
        st.marked_dead = False          # a beating host is alive again

    def mark_dead(self, host: str) -> None:
        """Report a death detected out of band (a crash) — takes effect
        immediately, without waiting out ``hard_timeout_s``."""
        self.hosts[host].marked_dead = True

    def stragglers(self) -> List[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if not st.marked_dead
                and self.cfg.soft_timeout_s
                <= now - st.last_heartbeat < self.cfg.hard_timeout_s]

    def dead(self) -> List[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if st.marked_dead
                or now - st.last_heartbeat >= self.cfg.hard_timeout_s]

    def have_quorum(self) -> bool:
        alive = len(self.hosts) - len(self.dead()) - len(self.stragglers())
        return alive >= self.cfg.quorum_fraction * len(self.hosts)

    def should_restart_elastic(self) -> bool:
        """Dead host(s) -> restart them (a replacement worker)."""
        return len(self.dead()) > 0

    def should_skip_stragglers(self) -> bool:
        """Quorum present but stragglers exist -> proceed without them."""
        return self.have_quorum() and len(self.stragglers()) > 0
