"""The benchmark's inputs, made on the device from the seed.

A configuration's ``data`` block names the array's axes (keys of the
configuration holding their sizes), how many trailing axes carry
spatial structure, and the structure itself: a sum of smooth random
fields, each drawn on a coarse grid of the given spacing and upsampled
(bilinear over two axes, trilinear over three), plus white noise, in
the given weights, scaled to the sample range and rounded to whole
levels.  The fields keep the detail subbands of every level far from
zero, as photographed or scanned content does.

Everything is drawn with one ``torch.Generator`` on the device in a few
large calls, so the same seed gives the same samples, and set-up pays
milliseconds for gigabytes.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

#: seeds are taken modulo this, so any whole number is a seed
SEED_MODULUS = 2 ** 63


def shape_of(config: dict) -> tuple:
    """The data array's shape: the configuration's sizes of the axes in
    ``data.axes``, outermost first."""
    return tuple(int(config[axis]) for axis in config["data"]["axes"])


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MODULUS)
    return gen


def _field(shape: Sequence[int], spatial: int, spacing: int,
           gen: torch.Generator, device) -> torch.Tensor:
    """A random field on a grid of ``spacing``, upsampled over the
    trailing ``spatial`` axes to ``shape``."""
    lead, space = tuple(shape[:-spatial]), tuple(shape[-spatial:])
    coarse = tuple(math.ceil(n / spacing) + 1 for n in space)
    n = math.prod(lead)
    grid = torch.rand((n, 1) + coarse, generator=gen, device=device)
    mode = {2: "bilinear", 3: "trilinear"}[spatial]
    out = F.interpolate(grid, size=space, mode=mode, align_corners=True)
    return out.reshape(shape)


def make(config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's data array for ``seed``, float32, whole
    sample levels in ``[0, 2**bits - 1]``."""
    spec = config["data"]
    shape = shape_of(config)
    gen = generator(seed, device)
    top = float(2 ** int(config["bits"]) - 1)
    x = torch.rand(shape, generator=gen, device=device).mul_(spec["noise"])
    for spacing, weight in spec["fields"]:
        x.add_(_field(shape, int(spec["spatial_axes"]), int(spacing), gen,
                      device), alpha=float(weight))
    total = float(spec["noise"]) + sum(w for _, w in spec["fields"])
    return x.mul_(top / total).round_().clamp_(0.0, top)
