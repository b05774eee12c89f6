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


def walk_table(tab, nb, inputs, sink, rnd):
    """NumPy walk of one program table (``csrc/window_common.cuh``) over
    a batch of ``nb`` windows, as ``window::walk`` does it: ``inputs`` is
    the input stage, four ``(nb, wh*ww)`` float32 windows; waves run in
    order over their flat ranges ``[lo, hi)``, each node of a wave in
    turn: starting at -0.0 it adds, left to right, each term's read
    (rounded to the compute dtype) times its coefficient, reading at
    ``pos + offset`` from the stage; then its values go to its slot and,
    with their flat positions, to ``sink(mask, q, vals)``.  Shared memory
    is one flat array (NaN until written) laid out as the kernel lays it
    out: front pad, the stage, the slots, the back pad; every read a pass
    makes, the overrun past ``hi`` included, must land inside it, and no
    node reads a slot its own wave writes."""
    (_, n_waves, n_nodes, n_terms, n_slots, halo, wh, ww, front, back,
     elems, _) = (int(v) for v in tab[:TW._HEADER])
    plane = wh * ww
    waves = tab[TW._HEADER:TW._HEADER + TW._WAVE_INTS * n_waves].reshape(
        -1, TW._WAVE_INTS)
    at = TW._HEADER + TW._WAVE_INTS * n_waves
    nodes = tab[at:at + TW._NODE_INTS * n_nodes].reshape(-1, TW._NODE_INTS)
    at += TW._NODE_INTS * n_nodes
    assert len(tab) == at + 2 * n_terms
    terms = tab[at:].reshape(n_terms, 2)
    size = front + (4 + n_slots) * plane + back
    mem = np.full((nb, size), np.nan, np.float32)
    base = front                                    # the input stage
    mem[:, base:base + 4 * plane] = np.concatenate(
        [np.asarray(x, np.float32).reshape(nb, plane) for x in inputs], 1)
    assert elems in TW.ELEMS_CHOICES
    overrun = 32 * (elems - 1)
    for n0, nn, lo, hi in waves:
        q = np.arange(lo, hi)
        written = {4 + int(nodes[n, 2]) // plane
                   for n in range(n0, n0 + nn) if nodes[n, 2] >= 0}
        vals = []
        for t0, nt, _, _ in nodes[n0:n0 + nn]:
            acc = np.full((nb, q.size), -0.0, np.float32)
            for off, bits in terms[t0:t0 + nt]:
                assert 0 <= base + lo + off and \
                    base + hi + overrun + off <= size, \
                    "read outside the shared memory"
                # the source: the plane the offset lands in (a shift moves
                # it by less than half a plane)
                assert int(np.floor(off / plane + 0.5)) not in written, \
                    "a wave reads a slot it writes"
                c = np.array(bits, np.int32).view(np.float32)
                acc = rnd(acc + rnd(rnd(mem[:, base + q + off]) * c))
            vals.append(acc)
        for (_, _, dst, mask), acc in zip(nodes[n0:n0 + nn], vals):
            if dst >= 0:
                mem[:, base + 4 * plane + dst + q] = acc
            if mask:
                sink(mask, q, acc)


def emulate(win, planes):
    """NumPy walk of ``win.table`` over every tile, mirroring the kernel:
    mod-indexed input windows, the wave walk (:func:`walk_table`), masked
    stores of the tile core."""
    bf = win.compute_dtype == "bfloat16"
    rnd = _bf16 if bf else (lambda a: a)
    r = int(win.table[5])
    nb, hp, wp = planes[0].shape
    bh, bw = win.block
    wh, ww = bh + 2 * r, bw + 2 * r
    assert (int(win.table[6]), int(win.table[7])) == (wh, ww)
    outs = [np.full_like(p, np.nan) for p in planes]
    for y0 in range(0, hp, bh):
        for x0 in range(0, wp, bw):
            rows = (y0 - r + np.arange(wh)) % hp
            cols = (x0 - r + np.arange(ww)) % wp

            def sink(mask, q, vals, y0=y0, x0=x0):
                y, x = q // ww, q % ww
                gy, gx = y0 + y - r, x0 + x - r
                keep = ((y >= r) & (y < r + bh) & (x >= r) & (x < r + bw)
                        & (gy < hp) & (gx < wp))
                for k in range(4):
                    if mask >> k & 1:
                        outs[k][:, gy[keep], gx[keep]] = vals[:, keep]
            walk_table(win.table, nb,
                       [p[:, rows][:, :, cols] for p in planes], sink, rnd)
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


# the main path's level-0 programs (cdf97, tap_opt="full"): barriers per
# tile (one after the inputs, one per dependency wave), nodes per wave,
# terms (one shared read each per position)
MAIN_PROGRAMS = {("ns-polyconv", "scheme"): (5, [6, 4, 6, 4], 92),
                 ("ns-polyconv", "none"): (3, [6, 4], 46),
                 ("sep-lifting", "none"): (2, [4], 8)}


@pytest.mark.parametrize("inverse", (False, True))
@pytest.mark.parametrize("scheme,fuse", list(MAIN_PROGRAMS))
def test_wave_schedule_of_main_path_programs(scheme, fuse, inverse):
    """One barrier per dependency wave (21 -> 5 on the fused level,
    11 -> 3 and 5 -> 2 on the steps), in the table header as in the
    layout; a node's wave is one more than its sources' highest."""
    barriers, per_wave, terms = MAIN_PROGRAMS[(scheme, fuse)]
    for prog in TC.compile_scheme_programs("cdf97", scheme, False, inverse,
                                           "full", fuse):
        lay = TW.layout(prog)
        win = TW.encode(prog, TW.BLOCK_TARGET)
        assert (lay.barriers, lay.n_terms) == (barriers, terms)
        assert [len(lay.wave_nodes(w)) for w in
                range(1, lay.n_waves + 1)] == per_wave
        assert (win.barriers, win.terms) == (barriers, terms)
        assert int(win.table[1]) == len(per_wave)
        waves = [lay.waves[i] for i in lay.order]
        assert waves == sorted(waves) and max(waves) == barriers - 1
        for i in lay.order:
            assert lay.waves[i] == 1 + max(lay.waves[t.src]
                                           for t in prog.nodes[i].terms)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_wave_liveness_never_overwrites_a_live_slot(scheme):
    """Every program: a slot is taken only once the last wave that reads
    its holder has run, and no node reads a slot its own wave writes."""
    for w, optimize, inverse, opt, fuse in itertools.product(
            WAVELETS, (False, True), (False, True), ("off", "exact", "full"),
            ("none", "scheme")):
        for prog in TC.compile_scheme_programs(w, scheme, optimize, inverse,
                                               opt, fuse):
            lay = TW.layout(prog)
            last = {}
            for i in lay.order:
                for t in prog.nodes[i].terms:
                    last[t.src] = max(last.get(t.src, 0), lay.waves[i])
            for i in lay.order:
                wave, s = lay.waves[i], lay.slots[i]
                assert (s >= 0) == (last.get(i, 0) > wave)
                if s < 0:
                    continue
                for h in lay.order:
                    if h != i and lay.slots[h] == s and lay.waves[h] < wave:
                        assert last[h] < wave, (h, i)
                for j in lay.wave_nodes(wave):
                    assert all(lay.slots[t.src] != s
                               for t in prog.nodes[j].terms)


@pytest.mark.parametrize("scheme,fuse", list(MAIN_PROGRAMS))
def test_smem_bytes_is_what_the_kernel_lays_out(scheme, fuse):
    """The guard's size: the table (rounded to 16 bytes), the front pad,
    the input stage, the slots and the back pad, from the table header,
    exactly; and the block the guard picks at the main path's level 0
    leaves MIN_RESIDENT blocks resident."""
    prog = TC.compile_scheme_programs("cdf97", scheme, False, False, "full",
                                      fuse)[0]
    block = TW.fit_block((prog,), 1024, 1024)
    win = TW.encode(prog, block)
    n_slots, halo, wh, ww, front, back = (int(v) for v in win.table[4:10])
    assert (wh, ww) == win.window and halo == prog.halo
    assert (front, back) == TW.pads(halo, ww, win.elems)
    table = -(-len(win.table) // 4) * 4
    assert win.smem_bytes == 4 * (table + front + (4 + n_slots) * wh * ww
                                  + back)
    assert TW.resident_blocks(win.smem_bytes) >= TW.MIN_RESIDENT
    # the fused 9/7 level: ten slots beside the input stage; at (32, 64)
    # one block fits an SM, so the guard halves the target to (32, 32)
    if fuse == "scheme":
        assert block == (32, 32) and n_slots == 10
        assert TW.resident_blocks(TW.smem_bytes(prog, (32, 64))) == 1
    else:
        assert block == ((32, 32) if scheme == "ns-polyconv" else (32, 64))


@pytest.mark.parametrize("scheme,fuse,block,elems", [
    ("ns-polyconv", "scheme", (32, 32), 6),  # waves of 1222-1294: one pass
    ("ns-polyconv", "none", (32, 32), 6),
    ("sep-lifting", "none", (32, 64), 9),    # 2110 positions: one pass
    ("ns-polyconv", "scheme", (32, 64), 4),  # 2172-2446: three of 4 or 6
])
def test_positions_per_thread_fit_the_waves(scheme, fuse, block, elems):
    """The encoder picks the count of positions per thread that needs the
    fewest pass slots over the waves (the smaller on a tie), writes it to
    the header and sizes the back pad for it."""
    prog = TC.compile_scheme_programs("cdf97", scheme, False, False, "full",
                                      fuse)[0]
    win = TW.encode(prog, block)
    assert win.elems == elems
    wh, ww = win.window
    slots = {e: sum(-(-(hi - lo) // (TW.THREADS * e)) * e
                    for lo, hi in TW.wave_ranges(TW.layout(prog), wh, ww))
             for e in TW.ELEMS_CHOICES}
    assert slots[elems] == min(slots.values())
    assert TW.pads(prog.halo, ww, elems)[1] >= \
        prog.halo * ww + prog.halo + 32 * (elems - 1)
    with pytest.raises(ValueError, match="elems 5"):
        TW.table_rows(prog, TW.layout(prog), wh, ww, prog.halo, "float32",
                      5)


# ---------------------------------------------------------------------------
# SMEM guard, wrapper checks, launch counter
# ---------------------------------------------------------------------------

def test_fit_block_keeps_target_when_it_fits():
    """The target is kept where every launch fits and leaves MIN_RESIDENT
    blocks resident (the sep-lifting steps); the fused 9/7 level fits the
    limit at the target but would leave one block resident, so the guard
    halves it."""
    progs = TC.compile_scheme_programs("cdf97", "sep-lifting", False, False,
                                       "full", "none")
    assert TW.fit_block(progs, 1024, 1024) == TW.BLOCK_TARGET
    progs = TC.compile_scheme_programs("cdf97", "ns-polyconv", False, False,
                                       "full", "scheme")
    assert all(TW.smem_bytes(p, TW.BLOCK_TARGET) <= TW.SMEM_LIMIT
               for p in progs)
    assert TW.fit_block(progs, 1024, 1024) == (32, 32)


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
    """Every program fits the shared-memory limit at the target block, and
    the guard's block leaves MIN_RESIDENT blocks resident."""
    for w, s, opt, inv, lvl, fuse in itertools.product(
            WAVELETS, SCHEMES, (False, True), (False, True),
            ("off", "exact", "full"), ("none", "scheme")):
        progs = TC.compile_scheme_programs(w, s, opt, inv, lvl, fuse)
        assert all(TW.smem_bytes(p, TW.BLOCK_TARGET) <= TW.SMEM_LIMIT
                   for p in progs)
        block = TW.fit_block(progs, 1024, 1024)
        assert TW.resident_blocks(max(TW.smem_bytes(p, block)
                                      for p in progs)) >= TW.MIN_RESIDENT


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
