"""Architecture registry: ``--arch <id>`` resolution + shape applicability.

Every assigned (architecture x shape) cell is enumerated here, including
explicit SKIP rows with reasons (DESIGN.md §Arch-applicability) so the
40-cell accounting in EXPERIMENTS.md is auditable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import (dbrx_132b, granite_34b, minitron_8b,
                                 mixtral_8x7b, phi4_mini_3_8b, pixtral_12b,
                                 qwen2_0_5b, rwkv6_3b, whisper_medium,
                                 zamba2_2_7b)
from repro_torch.configs.base import (ALL_SHAPES, ModelConfig, RunConfig,
                                      ShapeConfig)

_MODULES = {
    "qwen2-0.5b": qwen2_0_5b,
    "minitron-8b": minitron_8b,
    "granite-34b": granite_34b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "whisper-medium": whisper_medium,
    "zamba2-2.7b": zamba2_2_7b,
    "rwkv6-3b": rwkv6_3b,
    "mixtral-8x7b": mixtral_8x7b,
    "dbrx-132b": dbrx_132b,
    "pixtral-12b": pixtral_12b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False
               ) -> Tuple[ModelConfig, RunConfig]:
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{sorted(_MODULES)}") from None
    return (mod.SMOKE if smoke else mod.FULL), mod.RUN


# Sub-quadratic long-context capability (long_500k eligibility).
_LONG_OK = {
    "zamba2-2.7b": "SSM state, O(1)/token",
    "rwkv6-3b": "recurrent state, O(1)/token",
    "mixtral-8x7b": "sliding-window KV (4096) ring buffer",
}


def shape_applicability(arch_id: str, shape: ShapeConfig
                        ) -> Optional[str]:
    """None if the cell runs; otherwise the skip reason."""
    cfg, _ = get_config(arch_id)
    if shape.name == "long_500k":
        if arch_id in _LONG_OK:
            return None
        if cfg.family == "encdec":
            return ("SKIP: enc-dec with 448-position decoder; 500k "
                    "autoregressive decode does not exist for this arch")
        return "SKIP: full attention (O(n^2) scores, unbounded KV cache)"
    return None


def all_cells() -> List[Tuple[str, ShapeConfig, Optional[str]]]:
    """The full 40-cell grid with skip annotations."""
    out = []
    for arch in ARCH_IDS:
        for shape in ALL_SHAPES:
            out.append((arch, shape, shape_applicability(arch, shape)))
    return out
