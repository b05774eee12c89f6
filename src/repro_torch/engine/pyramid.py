"""The engine's output container (leaf module — imports only torch).

Kept dependency-free so both :mod:`repro_torch.engine.plan` and
:mod:`repro_torch.core.transform` can import it without an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

Detail = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class Pyramid:
    """Multi-level DWT output: coarsest LL + per-level detail triples
    ``(HL, LH, HH)`` (coarsest first)."""

    ll: torch.Tensor
    details: List[Detail]

    @property
    def levels(self) -> int:
        return len(self.details)
