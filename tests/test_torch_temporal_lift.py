"""The temporal lifting kernel's encoding and wrapper, on the CPU.

``repro_torch.kernels.temporal_lift`` runs one level of the 3-D
transform's temporal pass in one CUDA launch.  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); here its
table is checked against each wavelet's program, a walk of the table that
mirrors ``csrc/temporal_lift.cu`` chunk by chunk (halos, wrap, the even
split into chunks, every index checked in bounds) is held bit for bit
against the plain pass, and the wrapper's checks and CPU path are run.
"""
import itertools

import numpy as np
import pytest
import torch

import repro_torch as R
from repro_torch.compiler import temporal as TP
from repro_torch.core import wavelets as W
from repro_torch.engine import backends as B
from repro_torch.kernels import temporal_lift as TL

WAVELETS = ("cdf53", "cdf97", "dd137")
#: (before, after) frames each band is staged with beyond a chunk's own
#: pairs: the programs' summed one-sided reach
REACH = {("cdf53", False): ((1, 1), (1, 0)),
         ("cdf53", True): ((0, 1), (1, 1)),
         ("cdf97", False): ((2, 2), (2, 1)),
         ("cdf97", True): ((1, 2), (2, 2)),
         ("dd137", False): ((3, 3), (2, 1)),
         ("dd137", True): ((1, 2), (3, 3))}


def _float(bits) -> float:
    return float(np.array(bits, np.int32).view(np.float32))


def _volume(shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("wavelet,inverse",
                         itertools.product(WAVELETS, (False, True)))
def test_table_encodes_the_program(wavelet, inverse):
    prog = TP.compile_temporal(wavelet, inverse)
    wv = W.get_wavelet(wavelet)
    t = TL.encode(prog).table
    steps = [st for st in prog.steps if st.taps]
    assert t[0] == len(steps) == 2 * wv.K
    assert ((t[1], t[2]), (t[3], t[4])) == REACH[(wavelet, inverse)]
    assert TL.encode(prog).reach.total == sum(t[1:5])
    scaled = wv.zeta != 1.0
    assert t[5] == (0 if not scaled else 2 if inverse else 1)
    assert (_float(t[6]), _float(t[7])) == (
        float(np.float32(prog.s_scale)), float(np.float32(prog.d_scale)))
    assert len(t) == TL._HEADER + TL._STEP_INTS * len(steps)
    for j, st in enumerate(steps):
        rec = t[TL._HEADER + j * TL._STEP_INTS:][:TL._STEP_INTS]
        assert rec[0] == (st.target == "d") and rec[3] == len(st.taps)
        assert [(int(rec[4 + 2 * i]), _float(rec[5 + 2 * i]))
                for i in range(len(st.taps))] == [
            (-k, float(np.float32(c))) for k, c in st.taps]
        assert not rec[4 + 2 * len(st.taps):].any()
    # the last step updates the chunk's own pairs only: nothing reads its
    # target after it
    assert TL.encode(prog).reach.steps[-1] == (0, 0)
    # bf16 compute rounds each coefficient as coef() does
    tb = TL.encode(prog, torch.bfloat16).table
    c0 = steps[0].taps[0][1]
    assert _float(tb[TL._HEADER + 5]) == float(
        torch.tensor(c0, dtype=torch.bfloat16))


def emulate(lift, x_s, x_d, chunk=None):
    """The kernel's walk over one volume's bands ``(P, N)`` (N columns),
    as csrc/temporal_lift.cu runs it: per chunk, stage both bands with
    their halo (mod P), scale first (inverse), run each step over its
    region, write the chunk's own pairs (scaled after: forward)."""
    t = lift.table
    bf16 = lift.compute_dtype == torch.bfloat16

    def rnd(v):
        return v.to(torch.bfloat16).float() if bf16 else v

    n_steps, sb, sa, db, da, mode = (int(v) for v in t[:6])
    ks, kd = _float(t[6]), _float(t[7])
    pairs = x_s.shape[0]
    chunks, frames = lift.chunking(pairs, chunk)
    out_s = torch.empty_like(x_s, dtype=torch.float32)
    out_d = torch.empty_like(out_s)
    longest = 0
    for c in range(chunks):
        c0 = c * pairs // chunks
        n = (c + 1) * pairs // chunks - c0
        longest = max(longest, n)
        bufs = {}
        for name, x, before, after, k in (("s", x_s, sb, sa, ks),
                                          ("d", x_d, db, da, kd)):
            rows = [(c0 - before + i) % pairs
                    for i in range(before + n + after)]
            v = rnd(x[rows].float())
            if mode == 2:
                v = rnd(v * k)
            bufs[name] = [v, before]
        for j in range(n_steps):
            rec = [int(v) for v in t[TL._HEADER + j * TL._STEP_INTS:][
                :TL._STEP_INTS]]
            tgt, src = ("d", "s") if rec[0] else ("s", "d")
            (tv, tb), (sv, sbb) = bufs[tgt], bufs[src]
            for i in range(-rec[1], n + rec[2]):
                assert 0 <= i + tb < tv.shape[0]
                acc = tv[i + tb]
                for m in range(rec[3]):
                    at = i + rec[4 + 2 * m] + sbb
                    assert 0 <= at < sv.shape[0], "read outside the stage"
                    acc = rnd(acc + rnd(sv[at] * _float(rec[5 + 2 * m])))
                tv[i + tb] = acc
        for name, out, k in (("s", out_s, ks), ("d", out_d, kd)):
            v, before = bufs[name]
            v = v[before:before + n]
            out[c0:c0 + n] = rnd(v * k) if mode == 1 else v
    assert 2 * longest + lift.reach.total <= frames
    return out_s.to(x_s.dtype), out_d.to(x_s.dtype)


@pytest.mark.parametrize("wavelet,cdt,io", [
    ("cdf53", torch.float32, torch.float32),
    ("cdf97", torch.float32, torch.float32),
    ("dd137", torch.float32, torch.float32),
    ("cdf97", torch.bfloat16, torch.float32),
    ("dd137", torch.bfloat16, torch.bfloat16),
    ("cdf97", torch.float32, torch.float16)])
def test_emulated_walk_equals_the_plain_pass(wavelet, cdt, io):
    fwd = TP.compile_temporal(wavelet)
    inv = TP.compile_temporal(wavelet, inverse=True)
    for t, chunk in ((2, None), (4, None), (6, 1), (14, 2), (70, None),
                     (70, 5)):
        x = _volume((t, 3, 5), seed=t, dtype=io)
        lo, hi = TP.temporal_forward(x, fwd, cdt)
        got = emulate(TL.encode(fwd, cdt), x[0::2].reshape(t // 2, -1),
                      x[1::2].reshape(t // 2, -1), chunk)
        assert torch.equal(got[0], lo.reshape(t // 2, -1))
        assert torch.equal(got[1], hi.reshape(t // 2, -1))
        back = TP.temporal_inverse(lo, hi, inv, cdt)
        s, d = emulate(TL.encode(inv, cdt), lo.reshape(t // 2, -1),
                       hi.reshape(t // 2, -1), chunk)
        assert torch.equal(s, back[0::2].reshape(t // 2, -1))
        assert torch.equal(d, back[1::2].reshape(t // 2, -1))


def test_chunking_keeps_the_halo_over_read_small():
    for wavelet, inverse in REACH:
        lift = TL.encode(TP.compile_temporal(wavelet, inverse))
        for pairs in (1, 2, 31, 32, 33, 233, 466, 932, 4099):
            chunks, frames = lift.chunking(pairs)
            assert 1 <= chunks <= pairs
            assert frames == 2 * -(-pairs // chunks) + lift.reach.total
            if pairs >= max(TL.CHUNK, 4 * lift.reach.total):
                assert chunks * lift.reach.total <= 0.125 * 2 * pairs
    # the vol3d levels at 9/7: 29, 14 and 7 chunks of 32-34 pairs
    lift = TL.encode(TP.compile_temporal("cdf97"))
    assert [lift.chunking(p) for p in (932, 466, 233)] == [
        (29, 73), (14, 75), (7, 75)]
    with pytest.raises(ValueError, match="shared memory"):
        lift.chunking(100000, chunk=1000)


def test_wrapper_checks_raise():
    """The checks of a launch, on meta tensors (they run every check a
    CUDA tensor does and stop before the launch); a CPU tensor runs the
    plain pass, which raises on odd T too."""
    fwd = TP.compile_temporal("cdf97")
    inv = TP.compile_temporal("cdf97", inverse=True)
    x = _volume((2, 6, 4, 8)).to("meta")
    with pytest.raises(ValueError, match="temporal axis must be even"):
        TL.temporal_lift_forward(x[:, :5], fwd)
    with pytest.raises(ValueError, match="temporal axis must be even"):
        TL.temporal_lift_forward(_volume((2, 5, 4, 8)), fwd)
    with pytest.raises(TypeError, match="I/O dtype torch.float64"):
        TL.temporal_lift_forward(x.double(), fwd)
    with pytest.raises(ValueError, match="compute dtype"):
        TL.temporal_lift_forward(x, fwd, torch.float16)
    with pytest.raises(ValueError, match="takes a forward program"):
        TL.temporal_lift_forward(x, inv)
    with pytest.raises(ValueError, match="takes an inverse program"):
        TL.temporal_lift_inverse(x, x, fwd)
    with pytest.raises(ValueError, match="bands disagree"):
        TL.temporal_lift_inverse(x, x[:1], inv)
    with pytest.raises(ValueError, match=r"must be \(\.\.\., T, H, W\)"):
        TL.temporal_lift_forward(x[0, 0], fwd)
    with pytest.raises(ValueError, match="runs on cuda or cpu tensors"):
        TL.temporal_lift_forward(x, fwd)


def test_layouts_the_kernel_cannot_address_are_made_contiguous():
    """Contiguous volumes and views along T launch in place; a transposed
    plane, a strided W, one channel of a channels-last video and batch
    dims that do not collapse to one stride are made contiguous first."""
    x = _volume((2, 6, 4, 8))
    assert TL._layout(x) == (2, 192)
    assert TL._layout(x[:, 1::2]) == (2, 192)
    assert TL._layout(x[1:, :, :1]) == (1, 0)
    assert TL._addressable(x)[0] is x
    for bad in (x.transpose(-1, -2), x[..., ::2],
                _volume((6, 4, 8, 3))[..., 0],
                _volume((3, 2, 6, 4, 8))[::2, :, ::2].transpose(0, 1)):
        assert TL._layout(bad) is None
        t, (batch, stride) = TL._addressable(bad)
        assert t.is_contiguous() and torch.equal(t, bad)
        assert batch == bad.shape[:-3].numel()
        assert stride == (t.shape[-3:].numel() if batch > 1 else 0)


@pytest.mark.parametrize("io,cdt", [(torch.float32, torch.float32),
                                    (torch.float16, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_wrapper_on_cpu_is_the_plain_pass(io, cdt):
    fwd = TP.compile_temporal("dd137")
    inv = TP.compile_temporal("dd137", inverse=True)
    x = _volume((2, 3, 4, 6, 5), dtype=io)
    before = TL.KERNEL.launches
    lo, hi = TL.temporal_lift_forward(x, fwd, cdt)
    want = TP.temporal_forward(x, fwd, cdt)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    assert torch.equal(TL.temporal_lift_inverse(lo, hi, inv, cdt),
                       TP.temporal_inverse(lo, hi, inv, cdt))
    assert TL.KERNEL.launches == before     # the plain version counts none


def test_backends_route_the_temporal_pass():
    """"cuda" runs the pass through the kernel's wrapper, "torch" and
    "conv" the plain pass; dwt3 on "cuda" (CPU tensors) equals "torch"
    bit for bit."""
    cuda, torch_be = B.get_backend("cuda"), B.get_backend("torch")
    assert type(cuda).temporal_forward is not B.Backend.temporal_forward
    assert type(torch_be).temporal_forward is B.Backend.temporal_forward
    assert type(B.get_backend("conv")).temporal_inverse \
        is B.Backend.temporal_inverse
    x = _volume((2, 8, 16, 8))
    kw = dict(wavelet="cdf97", device="cpu")
    got = R.dwt3(x, backend="cuda", levels=2, **kw)
    want = R.dwt3(x, backend="torch", levels=2, **kw)
    assert torch.equal(got.ll, want.ll)
    assert torch.equal(R.idwt3(got, backend="cuda", **kw),
                       R.idwt3(want, backend="torch", **kw))


@pytest.mark.parametrize("layout", ["transposed", "channels_last"])
def test_dwt3_on_cuda_takes_any_layout(layout):
    """dwt3/idwt3 on "cuda" of a volume whose planes the kernel cannot
    address in place equals "torch" bit for bit (on the card the wrapper
    launches on a contiguous copy: tests/test_torch_cuda.py)."""
    if layout == "transposed":
        x = _volume((2, 8, 8, 16)).transpose(-1, -2)
    else:
        x = _volume((8, 16, 8, 3))[..., 0]
    kw = dict(wavelet="cdf97", device="cpu", levels=2)
    got = R.dwt3(x, backend="cuda", **kw)
    want = R.dwt3(x, backend="torch", **kw)
    assert torch.equal(got.ll, want.ll)
    assert all(torch.equal(g, w) for gd, wd in zip(got.details, want.details)
               for g, w in zip(gd, wd))
    kw.pop("levels")
    assert torch.equal(R.idwt3(got, backend="cuda", **kw),
                       R.idwt3(want, backend="torch", **kw))
