"""Fitted cost model: predict wall-clock for unseen plan configurations.

The features are the two quantities the port already models for every
plan — device-memory bytes moved (``plan.executor.hbm_bytes``: the window
kernel's ``scheme_hbm_bytes`` per level, the fused-pyramid kernels'
``pyramid_hbm_bytes``, the unique bytes on ``"torch"``/``"conv"``) and
kernel launches per execution (``plan.launches``) — and
:func:`config_features` computes both with the models of the plan's
executor (:mod:`repro_torch.engine.executor`), at the blocks the
shared-memory guard picks for the key's block target, without building
the plan or encoding a table.  Per ``(backend, fuse)`` group on one
device:

* with >= :data:`MIN_FIT` records, a least-squares linear model
  ``t ~ a*bytes + b*launches + c`` captures the bandwidth/overhead
  split;
* every prediction is refined by the nearest measured neighbour in the
  group (nearest in log-byte distance), scaled by the byte ratio — with
  few records this degrades to pure nearest-neighbour extrapolation.

:class:`CostModel` is the reference's, numpy only: on one record set its
fits and predictions equal the reference's bit for bit, and a store that
round-trips through disk reproduces identical predictions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

MIN_FIT = 3          # records per group before a linear fit is attempted


def config_features(key, backend: Optional[str] = None,
                    fuse: Optional[str] = None,
                    tap_opt: Optional[str] = None,
                    block: Optional[Tuple[int, int]] = None) -> dict:
    """Cost-model features of one configuration: the modelled
    device-memory bytes of one forward execution (batch dims included)
    and its kernel launches — ``plan.executor.hbm_bytes()`` and
    ``plan.launches`` of the plan :func:`~repro_torch.engine.plan.
    build_plan` would build, computed by the models of its executor from
    level specs resolved without encoding a table.  ``backend``/
    ``fuse``/``tap_opt`` override the key's fields so candidate
    configurations are featurized from one base key; ``block`` is the
    block target (None: the block table's entry for the key's device,
    else the default, as ``build_plan`` picks it).  Tiled keys are
    featurized as monolithic, as the reference does (the per-group model
    absorbs the gather and stitch)."""
    from repro_torch.engine import backends as B
    from repro_torch.engine import executor as X
    from repro_torch.engine import plan as P

    key = dataclasses.replace(
        key, backend=backend if backend is not None else key.backend,
        fuse=fuse if fuse is not None else key.fuse,
        tap_opt=tap_opt if tap_opt is not None else key.tap_opt,
        tiles=None)
    if (key.packet is not None or key.ndim == 3) and key.fuse == "pyramid":
        key = dataclasses.replace(key, fuse="levels")   # build_plan demotes
    bk = B.get_backend(key.backend)
    target = P.block_target_of(key, bk, block)
    if key.fuse == "pyramid" and bk.pyramid_kernel:
        _, _, fwd_kprogs, _, blocks, why = P.pyramid_blocks(
            key, key.shape[-2], key.shape[-1], target)
        if why is None:
            return {"hbm_bytes": X.Pyramid.model_bytes(key, blocks,
                                                       fwd_kprogs),
                    "launches": X.Pyramid.LAUNCHES}
    specs = P.resolve_levels(key, bk, target)
    kind = X.kind(key)
    return {"hbm_bytes": kind.model_bytes(bk, key, specs, "forward"),
            "launches": kind.model_launches(bk, key, specs)}


@dataclasses.dataclass
class CostModel:
    """Per-(backend, fuse) wall-clock predictor over one device's records.

    ``groups`` maps ``(backend, fuse)`` to sorted ``(bytes, launches,
    time_s)`` rows; ``coef`` to the fitted ``(a, b, c)`` of
    ``t = a*bytes + b*launches + c`` (None below :data:`MIN_FIT`
    records)."""

    groups: Dict[Tuple[str, str], List[Tuple[int, int, float]]]
    coef: Dict[Tuple[str, str], Optional[Tuple[float, float, float]]]

    @classmethod
    def fit(cls, records) -> "CostModel":
        import numpy as np
        groups: Dict[Tuple[str, str], List[Tuple[int, int, float]]] = {}
        for r in records:
            groups.setdefault((r.backend, r.fuse), []).append(
                (int(r.hbm_bytes), int(r.launches), float(r.time_s)))
        coef = {}
        for g, rows in groups.items():
            rows.sort()                      # deterministic in the set
            if len(rows) >= MIN_FIT:
                a = np.array([[b, l, 1.0] for b, l, _ in rows], np.float64)
                y = np.array([t for _, _, t in rows], np.float64)
                sol, *_ = np.linalg.lstsq(a, y, rcond=None)
                coef[g] = (float(sol[0]), float(sol[1]), float(sol[2]))
            else:
                coef[g] = None
        return cls(groups=groups, coef=coef)

    def can_predict(self, backend: str, fuse: str) -> bool:
        return bool(self.groups.get((backend, fuse)))

    def predict(self, backend: str, fuse: str, hbm_bytes: int,
                launches: int) -> Optional[float]:
        """Predicted seconds per execution, or None when no record of
        this ``(backend, fuse)`` group exists on this device (the model
        never extrapolates across execution strategies it has not
        seen)."""
        rows = self.groups.get((backend, fuse))
        if not rows:
            return None
        nn = min(rows, key=lambda r: (abs(math.log(max(hbm_bytes, 1)
                                                   / max(r[0], 1))), r))
        t_nn = nn[2] * (max(hbm_bytes, 1) / max(nn[0], 1))
        c = self.coef.get((backend, fuse))
        if c is not None:
            t_lin = c[0] * hbm_bytes + c[1] * launches + c[2]
            if t_lin > 0:
                return 0.5 * (t_nn + t_lin)
        return t_nn
