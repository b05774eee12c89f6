"""The check that decides ``correct``: the reference against the
program at tiny sizes, the controls and the planted faults failing it,
and the reference's independence."""
import ast
import math
from pathlib import Path

import pytest
import torch

from portbench import check as CK
from portbench.drivers import roundtrip as RT
from portbench.reference import cdf97
from portbench.tests.tiny import run_tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("img2d-dci4k-j2k97-b8", "vol3d-vhm-ct-jp3d97",
         "slice2d-vhm-ct-j2k97")


def _program():
    from portbench import harness
    return harness.import_program()


def test_reference_agrees_with_the_program_on_2d_pyramids():
    R = _program()
    x = torch.rand(2, 3, 32, 64, generator=torch.Generator().manual_seed(1))
    x = (x * 4095).round()
    for fuse, levels in (("pyramid", 4), ("none", 3)):
        pyr = R.dwt2(x, levels=levels, fuse=fuse, device="cpu")
        rec = R.idwt2(pyr, fuse=fuse, device="cpu")
        flat = [pyr.ll] + [t for d in pyr.details for t in d]
        got = RT.compare_frames(cdf97, x, levels, flat, rec)
        assert got["fwd_err"] < 1e-4 and got["inv_err"] < 1e-4, got


def test_reference_agrees_with_the_program_on_volumes():
    R = _program()
    x = torch.rand(16, 32, 32, generator=torch.Generator().manual_seed(2))
    x = (x * 4095).round()
    pyr = R.dwt3(x, levels=3, device="cpu")
    rec = R.idwt3(pyr, device="cpu")
    flat = [pyr.ll] + [t for d in pyr.details for t in d]
    got = RT.compare_volume(cdf97, x, 3, flat, rec)
    assert got["fwd_err"] < 1e-4 and got["inv_err"] < 1e-4, got


def test_reference_round_trip_is_exact_in_float64():
    x = torch.rand(8, 16, 16, dtype=torch.float64)
    ll, det = cdf97.dwt2(x, 3)
    assert torch.allclose(cdf97.idwt2(ll, det), x, atol=1e-12)
    ll3, det3 = cdf97.dwt3(x, 3, rows=4)
    assert torch.allclose(cdf97.idwt3(ll3, det3, rows=4), x, atol=1e-12)
    # the lowpass keeps a constant image's level
    ll, _ = cdf97.dwt2(torch.ones(1, 16, 16, dtype=torch.float64), 2)
    assert torch.allclose(ll, torch.full_like(ll, ll[0, 0, 0].item()))


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "typing", "__future__",
                                           "importlib"), (path.name, n)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_comes_out_not_correct(workload):
    rc, result, err = run_tiny(workload, control=True)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]


def _unchanged(entry):
    """The transform returns its input unchanged: the input's samples
    laid into the pyramid's shapes, and back."""
    def forward(x):
        pyr = entry.forward(x)
        flat = entry.flatten(pyr)
        parts = torch.split(x.reshape(-1), [t.numel() for t in flat])
        for t, p in zip(flat, parts):
            t.copy_(p.reshape(t.shape))
        return pyr

    def inverse(pyr):
        return torch.cat([t.reshape(-1) for t in entry.flatten(pyr)]) \
            .reshape(entry.inverse(pyr).shape)

    return type(entry)(forward, inverse, entry.flatten)


def _half_batch(entry):
    """Half of each request's batch left out: the second half of every
    output along its first axis never written (zeros)."""
    def cut(t):
        t[t.shape[0] // 2:] = 0
        return t

    def forward(x):
        pyr = entry.forward(x)
        for t in entry.flatten(pyr):
            cut(t)
        return pyr

    return type(entry)(forward, lambda p: cut(entry.inverse(p)),
                       entry.flatten)


def _altered_answer(entry):
    """One answer altered where it is produced: one reconstructed
    sample off by 64 levels (1.6% of the 12-bit range)."""
    def inverse(pyr):
        rec = entry.inverse(pyr)
        rec.view(-1)[rec.numel() // 3] += 64.0
        return rec

    return type(entry)(entry.forward, inverse, entry.flatten)


def _altered_coefficient(entry):
    """One coefficient of the pyramid altered where it is produced, by
    64 levels (the inverse then reads it as it is)."""
    def forward(x):
        pyr = entry.forward(x)
        entry.flatten(pyr)[-1].view(-1)[7] += 64.0
        return pyr

    return type(entry)(forward, entry.inverse, entry.flatten)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "altered_answer": _altered_answer,
          "altered_coefficient": _altered_coefficient}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(workload, fault):
    rc, result, err = run_tiny(workload, wrap=FAULTS[fault])
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]


def test_each_configuration_finds_its_reference():
    from portbench import harness
    from portbench import reference as REF
    for w in CELLS:
        config = harness.cell(w)["config_data"]
        ref = REF.load(config["wavelet"])
        for fn in ("dwt2", "idwt2", "dwt3", "idwt3"):
            assert callable(getattr(ref, fn))


def test_the_checks_numbers_judge_nan_and_limits():
    assert CK.judge({"a": 1e-5}, {"a": 1e-4})
    assert not CK.judge({"a": 2e-4}, {"a": 1e-4})
    assert not CK.judge({"a": math.nan}, {"a": 1e-4})
    x = torch.rand(2, 16, 16)
    ll, det = cdf97.dwt2(x, 2)
    flat = [t.float() for t in [ll] + [u for d in det for u in d]]
    flat[1] = flat[1].clone()
    flat[1][0, 0, 0] = math.nan
    got = RT.compare_frames(cdf97, x, 2, flat, x)
    assert got["fwd_err"] == math.inf
