"""Lossless round trips: a reversible integer transform held to exact
equality, one client in a closed loop.

The traffic of :mod:`portbench.drivers.roundtrip` (``transform``,
``split``, ``inflight``, ``check_sample``; its window, warm-up and
requests are that module's) over integer samples, plus:

``dc_shift``
    the DC level shift of ISO/IEC 15444-1 Annex G for unsigned samples,
    ``2 ** (bits - 1)`` of the configuration's ``bits``: subtracted from
    every sample of the seed's data, which is then cast to int32, before
    any request (the program and the reference read the same shifted
    samples).

A lossless archive promises two things, and the check counts each
exactly (:func:`compare`): the subbands are the ones the standard
defines, so any decoder reads them (``fwd_mismatch``: pyramid samples
that differ from the reference's), and the inverse returns every sample
(``inv_mismatch``: reconstructed samples that differ from the request's
input).  The control is the same lifting in float32 without the floors,
rounded to int32 at the end.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import check as CK
from portbench.drivers import Prepared
from portbench.drivers import roundtrip as RT
from portbench.drivers.roundtrip import request, run, warm  # noqa: F401
from portbench.window import Kept, split_rows

#: the integer dtype of the requests
DTYPE = torch.int32


def prepare(program, config: dict, traffic: dict, device) -> Prepared:
    shift = 2 ** (int(config["bits"]) - 1)
    if int(traffic["dc_shift"]) != shift:
        raise ValueError(f"dc_shift {traffic['dc_shift']} is not "
                         f"2**(bits - 1) = {shift} of {config['bits']}-bit "
                         f"samples")
    return RT.prepare(program, config, traffic, device)


def inputs(data: torch.Tensor, traffic: dict) -> List[torch.Tensor]:
    x = data.sub_(float(traffic["dc_shift"])).to(DTYPE)
    del data
    return split_rows(x, int(traffic["split"]))


def control(reference, config: dict, traffic: dict, device,
            dtype: torch.dtype = torch.float32) -> RT.EntryPoints:
    """The reference computed in float32, where it drops the floors,
    its outputs rounded to int32: the float 5/3 of a lossy coder in the
    lossless coder's place."""
    levels = int(config["levels"][traffic["transform"]])

    def rounded(t):
        return t.round().to(DTYPE)

    def forward(x):
        ll, details = reference.dwt2(x.to(device), levels, dtype=dtype)
        return rounded(ll), [tuple(rounded(t) for t in d) for d in details]

    def inverse(pyr):
        return rounded(reference.idwt2(*pyr, dtype=dtype))

    return RT.EntryPoints(forward=forward, inverse=inverse,
                          flatten=lambda pyr: RT._flat(*pyr))


def _mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Samples of ``got`` that differ from ``want`` (all of them where
    the shapes differ)."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


def compare(reference, config: dict, traffic: dict, x: torch.Tensor,
            kept: Kept) -> Dict[str, float]:
    """``fwd_mismatch`` and ``inv_mismatch`` of one round trip of ``x``,
    one block of frames at a time; ``kept.tensors`` is the program's
    flat pyramid (LL, then each level's details, coarsest first) and its
    reconstruction, last."""
    levels = int(config["levels"][traffic["transform"]])
    pyramid, rec = kept.tensors[:-1], kept.tensors[-1]
    # a pyramid short of subbands mismatches in every sample it lacks
    fwd = x.numel() if len(pyramid) != 1 + 3 * levels else 0
    inv = 0
    for blk in CK.blocks(x.shape[0], math.prod(x.shape[1:])):
        ll, details = reference.dwt2(x[blk], levels)
        for got, ref in zip(pyramid, RT._flat(ll, details)):
            fwd += _mismatches(got[blk], ref)
        del ll, details
        inv += _mismatches(rec[blk], x[blk])
    return {"fwd_mismatch": float(fwd), "inv_mismatch": float(inv)}
