"""The lossless cell (``slice2d-vhm-ct-j2k53``): its exact check failing
the planted faults and the float control at the tiny size, the
reference against the standard's worked numbers, and the readers of the
reversible lifting kernel's spans and counter."""
import sys
import types

import pytest
import torch

from portbench import harness, program
from portbench import trace as TR
from portbench.reference import rev53
from portbench.tests.tiny import run_tiny

CELL = "slice2d-vhm-ct-j2k53"


def _coefficient_off_by_one(entry):
    """One forward coefficient off by 1 where it is produced (the
    inverse then reads it as it is)."""
    def forward(x):
        pyr = entry.forward(x)
        entry.flatten(pyr)[-1].view(-1)[7] += 1
        return pyr

    return type(entry)(forward, entry.inverse, entry.flatten)


def _sample_off_by_one(entry):
    """One reconstructed sample off by 1."""
    def inverse(pyr):
        rec = entry.inverse(pyr)
        rec.view(-1)[rec.numel() // 3] += 1
        return rec

    return type(entry)(entry.forward, inverse, entry.flatten)


@pytest.mark.parametrize("fault,numbers", [
    ("coefficient", ("fwd_mismatch",)),
    ("sample", ("inv_mismatch",)),
    ("control", ("fwd_mismatch", "inv_mismatch"))])
def test_each_planted_fault_comes_out_not_correct(fault, numbers):
    kw = {"coefficient": dict(wrap=_coefficient_off_by_one),
          "sample": dict(wrap=_sample_off_by_one),
          "control": dict(control=True)}[fault]
    rc, result, err = run_tiny(CELL, **kw)
    assert rc == 0, err
    assert result["correct"] is False, result["checks"]
    for k in numbers:
        assert result["checks"][k]["value"] > 0, result["checks"]
    assert result["checks"]["fallbacks"]["value"] == 0


def test_the_reference_gives_annex_fs_numbers():
    """A worked signal by hand from F.4.8.2: d = x_odd - floor((left +
    right) / 2), s = x_even + floor((d_left + d_right + 2) / 4), the
    edges mirrored; and a constant stays in LL alone."""
    x = torch.tensor([[1, 2, 3, 4, 10, -3]])
    y = rev53._sd(x, -1)
    # d: 2 - 2, 4 - 6, -3 - 10 (mirrored: x[6] = x[4]);
    # s: 1 + floor(2 / 4), 3 + floor(0 / 4), 10 + floor(-13 / 4)
    assert y.tolist() == [[1, 0, 3, -2, 6, -13]]
    assert torch.equal(rev53._sr(y, -1), x)
    ll, details = rev53.dwt2(torch.full((1, 8, 8), 7), 3)
    assert torch.equal(ll, torch.full_like(ll, 7))
    assert not any(t.any() for d in details for t in d)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": 7 if cat == "kernel" else 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _doc():
    """One round trip: two forward levels and two inverse levels, one
    launch each inside its ``revlift.*`` span, an empty_like's fill
    outside them.  Microseconds."""
    ev = [_x("user_annotation", "portbench.forward", 0, 100),
          _x("user_annotation", "call.dwt2", 2, 95),
          _x("user_annotation", "revlift.forward", 10, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 2, 1),
          _x("user_annotation", "revlift.forward", 40, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 42, 2, 2),
          _x("cuda_runtime", "cudaMemsetAsync", 70, 2, 3),
          _x("kernel", "rev_lift_forward", 200, 30, 1),
          _x("kernel", "rev_lift_forward", 230, 10, 2),
          _x("gpu_memset", "Memset", 240, 10, 3),
          _x("user_annotation", "portbench.inverse", 110, 100),
          _x("user_annotation", "call.idwt2", 112, 95),
          _x("user_annotation", "revlift.inverse", 120, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 122, 2, 4),
          _x("user_annotation", "revlift.inverse", 150, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 152, 2, 5),
          _x("kernel", "rev_lift_inverse", 250, 10, 4),
          _x("kernel", "rev_lift_inverse", 260, 40, 5)]
    return {"traceEvents": ev}


def _reading(doc, samples):
    r = harness.Reading(setup_s=1.0, window=None, memory_peak_bytes=0,
                        kept_bytes=0, request_samples=samples, itemsize=4,
                        summary=TR.reduce(doc))
    r._program = program.reduce(doc)
    return r


def test_span_readers_read_the_kernels_share_and_roofline():
    # 1e6 samples: 8e6 bytes a call, 2.388 us at 3.35 TB/s
    r = _reading(_doc(), 10 ** 6)
    least_us = 8e6 / 3.35e12 * 1e6
    fwd = harness.reader("revlift_fwd_roofline")(r)
    inv = harness.reader("revlift_inv_roofline")(r)
    assert fwd == pytest.approx(100 * least_us / 40)
    assert inv == pytest.approx(100 * least_us / 50)
    # the memset is glue: 90 of the round trips' 100 us are the kernel's
    assert harness.reader("revlift_pct")(r) == pytest.approx(90.0)
    # a program without the spans reads nothing
    doc = _doc()
    for e in doc["traceEvents"]:
        if e["name"].startswith("revlift."):
            e["name"] = "level.forward"
    old = _reading(doc, 10 ** 6)
    for m in ("revlift_fwd_roofline", "revlift_inv_roofline", "revlift_pct"):
        assert harness.reader(m)(old) is None, m


class _Metric:
    def __init__(self, rows):
        self.rows = rows

    def series(self):
        return self.rows


def test_launch_reader_counts_the_rev_lift_series_only(monkeypatch):
    execs = _Metric([{"labels": {"op": "forward"}, "value": 3},
                     {"labels": {"op": "inverse"}, "value": 3}])
    launches = _Metric([{"labels": {"kernel": "rev_lift"}, "value": 30},
                        {"labels": {"kernel": "tap_window"}, "value": 7}])
    metrics = {"repro_plan_executions_total": execs,
               "repro_kernel_launches_total": launches}
    telemetry = types.SimpleNamespace(REGISTRY=types.SimpleNamespace(
        get=metrics.get))
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", telemetry)
    r = _reading({"traceEvents": []}, 1)
    assert harness.reader("revlift_launches")(r) == 10
    # a program with no rev_lift series (the parent's) reads nothing
    launches.rows = launches.rows[1:]
    assert harness.reader("revlift_launches")(r) is None
