"""The window kernel's CPU-side contract (``repro_torch.kernels.tap_window``).

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).  Here:

* the plain version ``tap_window_ref`` against the reference's Pallas
  window kernel run as its own tests run it (interpret mode, through
  ``apply_steps_pallas``), and swept against the reference's jnp
  executor over every wavelet x scheme;
* the encoded program table against a NumPy walk of it that mirrors
  ``csrc/tap_window.cu`` block by block — regions, slot reuse, term
  offsets, output masks and the ragged edge — bit for bit against the
  plain version;
* the SMEM guard, the wrapper's checks and its launch counter.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as JC
from repro.compiler import execute as JCX
from repro.core.schemes import SCHEMES
from repro.engine.plan import scheme_steps as j_scheme_steps
from repro.kernels import polyphase as JPP

from repro_torch import compiler as TC
from repro_torch.engine.plan import scheme_steps as t_scheme_steps
from repro_torch.kernels import polyphase as TPP
from repro_torch.kernels import tap_window as TW

WAVELETS = ("cdf53", "cdf97", "dd137")
# tests/test_differential.py CROSS_TOL["float32"]
TOL = dict(rtol=2e-4, atol=2e-5)


def _planes(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(4)]


# ---------------------------------------------------------------------------
# plain version vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("cdf97", "ns-polyconv", False, False, "scheme"),
    ("dd137", "sep-lifting", True, False, "none"),
    ("cdf53", "ns-conv", False, True, "scheme"),
])
def test_plain_matches_pallas_window_kernel(case):
    """Batched, non-smooth 37x53 planes through the reference's Pallas
    kernel in interpret mode vs the port's window path on the CPU."""
    wavelet, scheme, optimize, inverse, fuse = case
    planes = _planes((2, 37, 53), seed=1)
    ref = JPP.apply_steps_pallas(
        j_scheme_steps(wavelet, scheme, optimize, inverse),
        [jnp.asarray(p) for p in planes], fuse=fuse, block=(16, 32),
        interpret=True)
    got = TPP.apply_steps_cuda(
        t_scheme_steps(wavelet, scheme, optimize, inverse),
        [torch.from_numpy(p) for p in planes], fuse=fuse)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_plain_matches_reference_jnp_executor(wavelet, scheme):
    """Every program, direction, compile level and fuse mode through
    ``tap_window_ref`` vs the reference's ``run_planes`` on the same
    program, on batched odd planes."""
    planes = _planes((2, 11, 13), seed=2)
    jp = [jnp.asarray(p) for p in planes]
    tp = [torch.from_numpy(p) for p in planes]
    for optimize, inverse, opt, fuse in itertools.product(
            (False, True), (False, True), ("off", "exact", "full"),
            ("none", "scheme")):
        jprogs = JC.compile_scheme_programs(wavelet, scheme, optimize,
                                            inverse, opt, fuse)
        tprogs = TC.compile_scheme_programs(wavelet, scheme, optimize,
                                            inverse, opt, fuse)
        for jprog, tprog in zip(jprogs, tprogs):
            ref = JCX.run_planes(jprog, jp)
            win = TW.encode(tprog, TW.fit_block((tprog,), 11, 13))
            got = TW.tap_window(win, tp)
            for r, g in zip(ref, got):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ---------------------------------------------------------------------------
# the encoded table, walked as csrc/tap_window.cu walks it
# ---------------------------------------------------------------------------

def _bf16(a):
    """Round float32 to bfloat16 (round to nearest even), kept in float32."""
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def emulate(win, planes):
    """NumPy walk of ``win.table`` over every block, mirroring the kernel:
    mod-indexed window loads, one region per node, reads at
    ``pos + offset`` from shared-memory slots (NaN until written),
    masked stores of the block core.  Asserts that every read stays in
    one slot the node does not write."""
    bf = win.compute_dtype == "bfloat16"
    rnd = _bf16 if bf else (lambda a: a)
    tab = win.table
    n_nodes, n_terms, n_slots, r = (int(v) for v in tab[:4])
    nodes = tab[4:4 + 8 * n_nodes].reshape(-1, 8)
    terms = tab[4 + 8 * n_nodes:].reshape(-1, 4)
    assert len(terms) == n_terms
    nb, hp, wp = planes[0].shape
    bh, bw = win.block
    wh, ww = bh + 2 * r, bw + 2 * r
    plane = wh * ww
    outs = [np.full_like(p, np.nan) for p in planes]
    for y0 in range(0, hp, bh):
        for x0 in range(0, wp, bw):
            slots = np.full((nb, max(n_slots, 1) * plane), np.nan,
                            np.float32)
            rows = (y0 - r + np.arange(wh)) % hp
            cols = (x0 - r + np.arange(ww)) % wp
            for kind, j, dst, qm, qn, t0, nt, mask in nodes:
                if kind == 0:
                    ys, xs = np.arange(wh), np.arange(ww)
                    acc = rnd(planes[j][:, rows][:, :, cols]
                              .reshape(nb, -1))
                else:
                    ys, xs = np.arange(qn, wh - qn), np.arange(qm, ww - qm)
                    pos = (ys[:, None] * ww + xs[None, :]).ravel()
                    acc = np.zeros((nb, pos.size), np.float32)
                    for t, (off, op, bits, _) in enumerate(
                            terms[t0:t0 + nt]):
                        src = (pos + off) // plane
                        assert (src == src[0]).all() and src[0] != dst
                        s = slots[:, pos + off]
                        assert not np.isnan(s).any(), "read before write"
                        c = np.array(bits, np.int32).view(np.float32)
                        v = s if op == 0 else (-s if op == 1
                                               else rnd(s * c))
                        acc = v if t == 0 else rnd(acc + v)
                pos = (ys[:, None] * ww + xs[None, :]).ravel()
                if dst >= 0:
                    slots[:, dst * plane + pos] = acc
                if mask:
                    vals = acc.reshape(nb, len(ys), len(xs))
                    cy = ys[(ys >= r) & (ys < r + bh)]
                    cx = xs[(xs >= r) & (xs < r + bw)]
                    gy, gx = y0 + cy - r, x0 + cx - r
                    keep_y, keep_x = gy < hp, gx < wp
                    block = vals[:, (cy - ys[0])[keep_y]][
                        :, :, (cx - xs[0])[keep_x]]
                    for k in range(4):
                        if mask >> k & 1:
                            outs[k][:, gy[keep_y][:, None],
                                    gx[keep_x][None, :]] = block
    return outs


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_encoded_table_matches_plain_version(wavelet, scheme):
    """Small blocks and a ragged 11x13 plane: many blocks per launch,
    partial edge blocks and periodic wrap on every side."""
    planes = _planes((2, 11, 13), seed=3)
    tp = [torch.from_numpy(p) for p in planes]
    for optimize, inverse, opt, fuse in itertools.product(
            (False, True), (False, True), ("off", "full"),
            ("none", "scheme")):
        for prog in TC.compile_scheme_programs(wavelet, scheme, optimize,
                                               inverse, opt, fuse):
            win = TW.encode(prog, (4, 8))
            want = TW.tap_window_ref(win, tp)
            got = emulate(win, planes)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("io", (np.float32, np.float16))
@pytest.mark.parametrize("fuse", ("none", "scheme"))
def test_encoded_table_bf16_compute_matches_plain_version(fuse, io):
    planes = _planes((2, 9, 12), seed=4, dtype=io)
    tp = [torch.from_numpy(p) for p in planes]
    for scheme in ("ns-polyconv", "sep-lifting"):
        for prog in TC.compile_scheme_programs("cdf97", scheme, False, False,
                                               "full", fuse):
            win = TW.encode(prog, (8, 8), "bfloat16")
            want = TW.tap_window_ref(win, tp)
            got = emulate(win, [p.astype(np.float32) for p in planes])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.astype(io), w.numpy())


def test_layout_frees_slots_after_last_reader():
    """Liveness: the fused 9/7 program needs far fewer slots than nodes,
    and output nodes that nothing reads take none."""
    prog = TC.compile_scheme_programs("cdf97", "ns-polyconv", False, False,
                                      "full", "scheme")[0]
    lay = TW.layout(prog)
    assert lay.n_slots < len(prog.nodes)
    for o in prog.outputs:
        readers = [nd for nd in prog.nodes if any(t.src == o
                                                  for t in nd.terms)]
        assert (lay.slots[o] == -1) == (not readers)


# ---------------------------------------------------------------------------
# SMEM guard, wrapper checks, launch counter
# ---------------------------------------------------------------------------

def test_fit_block_keeps_target_when_it_fits():
    progs = TC.compile_scheme_programs("cdf97", "ns-polyconv", False, False,
                                       "full", "scheme")
    assert TW.fit_block(progs, 1024, 1024) == TW.BLOCK_TARGET
    assert all(TW.smem_bytes(p, TW.BLOCK_TARGET) <= TW.SMEM_LIMIT
               for p in progs)


def test_fit_block_shrinks_then_raises():
    progs = TC.compile_scheme_programs("dd137", "ns-conv", False, False,
                                       "off", "scheme")
    full = TW.smem_bytes(progs[0], TW.BLOCK_TARGET)
    block = TW.fit_block(progs, 1024, 1024, limit=full // 2)
    assert block[0] * block[1] < TW.BLOCK_TARGET[0] * TW.BLOCK_TARGET[1]
    assert TW.smem_bytes(progs[0], block) <= full // 2
    with pytest.raises(TW.SmemError, match="even at the minimum block"):
        TW.fit_block(progs, 1024, 1024, limit=1024)


def test_every_program_fits_the_default_block():
    for w, s, opt, inv, lvl, fuse in itertools.product(
            WAVELETS, SCHEMES, (False, True), (False, True),
            ("off", "exact", "full"), ("none", "scheme")):
        progs = TC.compile_scheme_programs(w, s, opt, inv, lvl, fuse)
        assert TW.fit_block(progs, 1024, 1024) == TW.BLOCK_TARGET


def test_wrapper_checks_and_cpu_path_does_not_count():
    prog = TC.compile_scheme_programs("cdf53", "ns-conv", False, False,
                                      "full", "none")[0]
    win = TW.encode(prog, (8, 8))
    planes = [torch.randn(1, 8, 8) for _ in range(4)]
    before = TW.KERNEL.launches
    TW.tap_window(win, planes)
    assert TW.KERNEL.launches == before       # plain version: no launch
    with pytest.raises(ValueError, match="takes 4 planes"):
        TW.tap_window(win, planes[:3])
    with pytest.raises(ValueError, match=r"\(B, hp, wp\)"):
        TW.tap_window(win, [p[0] for p in planes])
    with pytest.raises(TypeError, match="unsupported"):
        TW.tap_window(win, [p.double() for p in planes])
    with pytest.raises(ValueError, match="disagree"):
        TW.tap_window(win, planes[:3] + [torch.randn(1, 8, 9)])
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        TW.encode(prog, (8, 8), "float16")


@pytest.mark.parametrize("dtype", (torch.float16, torch.bfloat16))
def test_plain_version_keeps_io_dtype(dtype):
    prog = TC.compile_scheme_programs("cdf97", "ns-polyconv", False, False,
                                      "full", "scheme")[0]
    win = TW.encode(prog, (8, 8))
    planes = [torch.randn(2, 8, 12).to(dtype) for _ in range(4)]
    outs = TW.tap_window(win, planes)
    ref = TW.tap_window(win, [p.float() for p in planes])
    for o, r in zip(outs, ref):
        assert o.dtype == dtype and o.shape == r.shape
        np.testing.assert_allclose(o.float().numpy(), r.to(dtype).float()
                                   .numpy(), rtol=0, atol=0)
