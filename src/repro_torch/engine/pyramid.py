"""The engine's output containers (leaf module — imports only torch).

Kept dependency-free so both :mod:`repro_torch.engine.plan` and
:mod:`repro_torch.core.transform` can import it without an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

Detail = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: one 3-D level's detail subbands, in this order:
#: (tL·HL, tL·LH, tL·HH, tH·LL, tH·HL, tH·LH, tH·HH) — the three spatial
#: details of the temporal low band, then all four subbands of the
#: temporal high band (only tL·LL recurses)
Detail3 = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class Pyramid:
    """Multi-level DWT output: coarsest LL + per-level detail triples
    ``(HL, LH, HH)`` (coarsest first)."""

    ll: torch.Tensor
    details: List[Detail]

    @property
    def levels(self) -> int:
        return len(self.details)


@dataclasses.dataclass
class Pyramid3:
    """Multi-level 3-D (t+2D) DWT output: the coarsest tLLL
    approximation volume plus per-level 7-subband detail tuples
    (coarsest first, see :data:`Detail3`).  Every subband is a
    ``(..., T/2^l, H/2^l, W/2^l)`` volume."""

    ll: torch.Tensor
    details: List[Detail3]

    @property
    def levels(self) -> int:
        return len(self.details)


@dataclasses.dataclass
class WaveletPacket2D:
    """2-D wavelet packet coefficients: one tensor per leaf of the
    admissible packet tree, in canonical leaf order (``paths`` matches
    ``PlanKey.packet``; see :mod:`repro_torch.core.packets`)."""

    paths: Tuple[str, ...]
    leaves: List[torch.Tensor]

    @property
    def depth(self) -> int:
        return max(len(p) for p in self.paths)

    def __getitem__(self, path: str) -> torch.Tensor:
        try:
            return self.leaves[self.paths.index(path)]
        except ValueError:
            raise KeyError(
                f"no packet leaf {path!r}; leaves: {self.paths}") from None

    def items(self):
        return list(zip(self.paths, self.leaves))
