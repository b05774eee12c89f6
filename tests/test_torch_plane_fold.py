"""K1 reads a level's image and writes it back: the polyphase split folded
into its gather, the merge into its sink (``kernels/polyphase.py``
``apply_steps_cuda``, ``kernels/tap_window.py``, ``csrc/tap_window.cu``).

On the CPU the "cuda" backend runs K1's plain version.  Here its image
path is held bit for bit (``torch.equal``) to the route it replaced: the
image split into four contiguous planes, the programs run on the planes,
the inverse's planes interleaved by ``core.schemes.from_planes``; and
``repro_plane_folds_total`` counts one fold a level in every workload
that runs K1's level hooks, with no plane-copy bytes where the inputs are
contiguous.  The kernel itself is held to the same on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2e), and its image
addressing to the plain version by a NumPy walk here
(``tests/test_torch_window.py``).
"""
import pytest
import torch

import repro_torch as R
from repro_torch import compiler as C
from repro_torch import engine as TE
from repro_torch import telemetry as T
from repro_torch.core import schemes as S
from repro_torch.engine import executor as X
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import tap_window as TW

CPU = dict(backend="cuda", device="cpu")

#: (I/O dtype, compute dtype)
DTYPES = {"f32": (torch.float32, "float32"),
          "f16": (torch.float16, "float32"),
          "bf16": (torch.bfloat16, "float32"),
          "bf16-compute": (torch.float32, "bfloat16")}


@pytest.fixture(autouse=True)
def _counters():
    """The port's counters on and zeroed for each test."""
    prev = T.mode()
    T.set_mode("counters")
    T.reset()
    yield
    T.CONFIG.apply(prev)
    T.reset()


def _image(case, dtype, seed=0):
    """The level's image of one shape case: batch dims; planes whose
    tiles end ragged (37x53); planes narrower than the halo (3x5, every
    window wraps); a non-contiguous view."""
    g = torch.Generator().manual_seed(seed)
    shape = {"batch": (2, 3, 24, 40), "ragged": (2, 74, 106),
             "wrap": (2, 6, 10), "strided": (2, 40, 24)}[case]
    x = torch.randn(shape, generator=g).to(dtype)
    return x.transpose(-1, -2) if case == "strided" else x


def _spec(x, fuse, compute_dtype):
    plan = TE.get_plan(shape=tuple(x.shape), levels=1, fuse=fuse,
                       dtype=str(x.dtype).split(".")[-1],
                       compute_dtype=compute_dtype, cache=TE.PlanCache(),
                       **CPU)
    return plan.level_specs[0], plan.key


def _split_then_planes(x, windows):
    """The route the image path replaced: four contiguous planes, then
    every launch on planes."""
    planes = [p.reshape((-1,) + p.shape[-2:]).contiguous()
              for p in S.to_planes(x)]
    for win in windows:
        planes = TW.tap_window(win, planes)
    return tuple(p.reshape(x.shape[:-2] + p.shape[-2:]) for p in planes)


def _planes_then_merge(planes, windows):
    lead = planes[0].shape[:-2]
    planes = [p.reshape((-1,) + p.shape[-2:]).contiguous() for p in planes]
    for win in windows:
        planes = TW.tap_window(win, planes)
    x = S.from_planes(planes)
    return x.reshape(lead + x.shape[-2:])


@pytest.mark.parametrize("case", ["batch", "ragged", "wrap", "strided"])
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("fuse", ["none", "scheme"])
def test_level_hooks_equal_split_and_merge_bit_for_bit(fuse, dtypes, case):
    """The "cuda" backend's level hooks on an image (forward) and on four
    planes (inverse) equal the split-then-planes and
    planes-then-from_planes route, every output bit for bit."""
    io, cdt = DTYPES[dtypes]
    x = _image(case, io)
    spec, key = _spec(x, fuse, cdt)
    got = X.cuda_level_forward(x, spec, key)
    want = _split_then_planes(x, spec.fwd_windows)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == io and g.shape == w.shape
        assert torch.equal(g, w)
    planes = got
    if case == "strided":
        # non-contiguous planes into the inverse
        planes = tuple(p.transpose(-1, -2).contiguous().transpose(-1, -2)
                       for p in got)
        assert not planes[0].is_contiguous()
    back = X.cuda_level_inverse(planes, spec, key)
    want = _planes_then_merge(planes, spec.inv_windows)
    assert back.dtype == io and back.shape == x.shape
    assert torch.equal(back, want)


@pytest.mark.parametrize("fuse", ["none", "scheme", "levels"])
def test_dwt2_idwt2_equal_split_and_merge_level_by_level(fuse):
    """Three levels of dwt2 and idwt2 on "cuda" equal the old route run
    level by level on the plan's own windows."""
    x = torch.randn(2, 48, 80, generator=torch.Generator().manual_seed(3))
    plan = TE.get_plan(shape=tuple(x.shape), levels=3, fuse=fuse,
                       cache=TE.PlanCache(), **CPU)
    pyr = R.dwt2(x, levels=3, fuse=fuse, **CPU)
    ll, details = x, []
    for spec in plan.level_specs:
        ll, *det = _split_then_planes(ll, spec.fwd_windows)
        details.append(tuple(det))
    assert torch.equal(pyr.ll, ll)
    for got, want in zip(pyr.details, details[::-1]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    back = R.idwt2(pyr, fuse=fuse, **CPU)
    y = ll
    for spec, det in zip(plan.level_specs[::-1], details[::-1]):
        y = _planes_then_merge((y,) + det, spec.inv_windows)
    assert torch.equal(back, y)


def _folds():
    return {op: PP.PLANE_FOLDS.value(op=op) for op in ("split", "merge")}


def _copied():
    return {op: PP.PLANE_COPY_BYTES.value(op=op) for op in ("split", "merge")}


@pytest.mark.parametrize("workload", ["dwt2", "dwt3", "packets"])
def test_folds_count_one_per_level_and_nothing_is_copied(workload):
    """repro_plane_folds_total: one split a forward level and one merge an
    inverse level (dwt2: 3 levels; dwt3: 2 levels x 2 temporal
    half-bands; packets "full:2": 5 internal nodes), and no plane-copy
    bytes on contiguous inputs."""
    g = torch.Generator().manual_seed(4)
    if workload == "dwt2":
        x = torch.randn(2, 32, 48, generator=g)
        fwd = R.dwt2(x, levels=3, **CPU)
        n = 3
        assert _folds() == {"split": n, "merge": 0}
        R.idwt2(fwd, **CPU)
    elif workload == "dwt3":
        x = torch.randn(8, 16, 16, generator=g)
        fwd = R.dwt3(x, levels=2, **CPU)
        n = 4
        assert _folds() == {"split": n, "merge": 0}
        R.idwt3(fwd, **CPU)
    else:
        x = torch.randn(32, 32, generator=g)
        fwd = R.wpt2(x, packet="full:2", **CPU)
        n = 5
        assert _folds() == {"split": n, "merge": 0}
        R.iwpt2(fwd, **CPU)
    assert _folds() == {"split": n, "merge": n}
    assert _copied() == {"split": 0, "merge": 0}


def test_non_contiguous_image_is_copied_once_and_counted():
    """A non-contiguous image is made contiguous with one copy, counted
    under split; the level's split is still folded, and the result is
    the contiguous image's."""
    xt = torch.randn(2, 40, 24, generator=torch.Generator().manual_seed(5)
                     ).transpose(-1, -2)
    pyr = R.dwt2(xt, levels=2, **CPU)
    assert _copied() == {"split": xt.numel() * 4, "merge": 0}
    assert _folds() == {"split": 2, "merge": 0}
    ref = R.dwt2(xt.contiguous(), levels=2, **CPU)
    assert torch.equal(pyr.ll, ref.ll)


def test_counters_read_the_same_with_no_card():
    """The plain version folds as the kernel does: no merge bytes on the
    inverse (no from_planes stacks), one merge fold."""
    x = torch.randn(1, 16, 16)
    pyr = R.dwt2(x, levels=1, **CPU)
    T.reset()
    R.idwt2(pyr, **CPU)
    assert _folds() == {"split": 0, "merge": 1}
    assert _copied() == {"split": 0, "merge": 0}


def test_wrapper_image_layouts_and_checks():
    """TW.tap_window on an image reads its four polyphase planes; with
    image_out it returns one interleaved image; odd or ill-shaped images
    are refused; the plain version counts no launch."""
    prog = C.compile_scheme_programs("cdf97", "ns-polyconv", False, False,
                                     "full", "scheme")[0]
    win = TW.encode(prog, (8, 8))
    x = torch.randn(2, 12, 20)
    planes = [p.contiguous() for p in S.to_planes(x)]
    before = TW.KERNEL.launches
    got = TW.tap_window(win, x)
    want = TW.tap_window(win, planes)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    img = TW.tap_window(win, x, image_out=True)
    assert img.shape == x.shape and torch.equal(img, S.from_planes(want))
    assert torch.equal(TW.tap_window(win, planes, image_out=True), img)
    assert torch.equal(TW.interleave(planes), x)
    assert TW.KERNEL.launches == before
    with pytest.raises(ValueError, match="H and W even"):
        TW.tap_window(win, torch.randn(2, 11, 20))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        TW.tap_window(win, torch.randn(12, 20))
    with pytest.raises(TypeError, match="unsupported"):
        TW.tap_window(win, x.double())
    with pytest.raises(ValueError, match="H and W even"):
        PP.apply_steps_cuda((), torch.randn(3, 5))


def test_bytes_model_drops_the_split_and_merge():
    """plan_hbm_bytes on the per-level "cuda" path: the window kernel's
    launches alone, each level's scheme_hbm_bytes with no split or merge
    pass; asked for, the pass adds one read and one write of the image."""
    plan = TE.get_plan(shape=(2, 64, 64), levels=2, fuse="none",
                       cache=TE.PlanCache(), **CPU)
    for op, attr in (("forward", "fwd_programs"), ("inverse",
                                                   "inv_programs")):
        want = sum(2 * PP.scheme_hbm_bytes(getattr(s, attr), s.image_shape,
                                           4, s.block)
                   for s in plan.level_specs)
        assert PP.plan_hbm_bytes(plan, op) == want
    s = plan.level_specs[0]
    assert PP.scheme_hbm_bytes(s.fwd_programs, (64, 64), 4, s.block,
                               split_merge=True) - \
        PP.scheme_hbm_bytes(s.fwd_programs, (64, 64), 4, s.block) == \
        2 * 64 * 64 * 4
