"""The trace reduction and the per-layer readers on a hand-made Chrome
trace, and the end-to-end readers' arithmetic."""
import pytest

from portbench import harness, peaks
from portbench import trace as TR
from portbench.window import Window


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _doc():
    """Two forward calls and one inverse; the second forward's second
    launch never reached the trace.  Times in microseconds."""
    ev = [
        _x("user_annotation", "portbench.forward", 0, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 5, 1),
        _x("cuda_runtime", "cudaGetDevice", 12, 1, 99),
        _x("kernel", "pyramid_forward_kernel", 100, 200, 1),
        _x("user_annotation", "portbench.inverse", 60, 40),
        _x("cpu_op", "aten::empty", 61, 3),
        _x("cuda_runtime", "cudaLaunchCooperativeKernel", 70, 5, 2),
        _x("kernel", "pyramid_inverse_kernel", 300, 100, 2),
        _x("user_annotation", "portbench.forward", 450, 350),
        _x("cpu_op", "aten::reshape", 480, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 520, 5, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 790, 5, 4),
        _x("kernel", "pyramid_forward_kernel", 600, 100, 3),
        {"ph": "i", "name": "instant"},
    ]
    return {"traceEvents": ev}


def test_reduce_reads_busy_idle_and_span_kernels():
    s = TR.reduce(_doc())
    assert s.window_s == pytest.approx(600e-6)            # 100 .. 700
    assert s.busy_s == pytest.approx(400e-6)
    assert s.device_ops["pyramid_forward_kernel"] == pytest.approx(300e-6)
    # one gap, 400 .. 600, while the host was inside aten::reshape
    assert s.idle_gaps == [("aten::reshape", pytest.approx(200e-6))]
    # the second forward lost a launch: only the first counts
    assert s.span_seconds("portbench.forward") == (1, pytest.approx(200e-6))
    assert s.span_seconds("portbench.inverse") == (1, pytest.approx(100e-6))
    b = TR.breakdown(s)
    assert b["device_ops"][0] == ["pyramid_forward_kernel",
                                  pytest.approx(300e-6)]
    assert len(b["idle_gaps"]) == 1


def test_reduce_of_a_trace_without_device_ops_is_none():
    assert TR.reduce(None) is None
    assert TR.reduce({"traceEvents": [_x("cpu_op", "aten::add", 0, 5)]}) \
        is None
    assert TR.breakdown(None) is None


def _reading(summary, samples=1000):
    window = Window(seconds=2.0, latencies_s=[0.01] * 19 + [0.03],
                    calls_s=[100e-6, 300e-6], kept=[])
    return harness.Reading(setup_s=5.0, window=window,
                           memory_peak_bytes=3 * 2 ** 30,
                           kept_bytes=2 ** 30, request_samples=samples,
                           itemsize=4, summary=summary)


def test_readers_compute_their_metrics():
    s = TR.reduce(_doc())
    r = _reading(s)
    read = {m: harness.reader(m)(r) for m in (
        "setup_s", "transform_gsample_s", "transform_p95_ms",
        "peak_mem_gib", "host_call_us", "dwt_fwd_roofline",
        "dwt_inv_roofline", "temporal_share_pct", "device_idle_pct")}
    assert read["setup_s"] == 5.0
    assert read["transform_gsample_s"] == pytest.approx(
        2 * 1000 * 20 / 2.0 / 1e9)
    assert read["transform_p95_ms"] == pytest.approx(10 + 0.05 * 20)
    assert read["peak_mem_gib"] == pytest.approx(2.0)
    assert read["host_call_us"] == pytest.approx(200.0)
    least = peaks.transform_bytes(1000, 4) / peaks.H100_SXM[
        "hbm_bytes_per_s"]
    assert read["dwt_fwd_roofline"] == pytest.approx(100 * least / 200e-6)
    assert read["dwt_inv_roofline"] == pytest.approx(100 * least / 100e-6)
    # no temporal pass on the fused 2-D path: nothing to read
    assert read["temporal_share_pct"] is None
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 400 / 600))


def test_temporal_share_counts_only_the_pass_own_kernels():
    """A 3-D round trip: the pass's roll, add and multiply against K1
    and the copies of the 2-D levels' split and merge."""
    kernels = [("void at::native::roll_cuda_kernel<float>(...)", 300),
               ("vectorized_elementwise_kernel<4, at::native::"
                "CUDAFunctor_add<float>, ...>", 200),
               ("vectorized_elementwise_kernel<4, AUnaryFunctor<float, "
                "float, float, MulFunctor<float> >, ...>", 100),
               ("tap_window_kernel<float, 6, false>(...)", 250),
               ("CatArrayBatchedCopy_vectorized<...>", 100),
               ("elementwise_kernel<128, 2, direct_copy_kernel_cuda>", 50)]
    ev = [_x("user_annotation", "portbench.forward", 0, 100)]
    t = 200
    for corr, (name, dur) in enumerate(kernels, start=1):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", corr * 10, 5,
                     corr))
        ev.append(_x("kernel", name, t, dur, corr))
        t += dur
    s = TR.reduce({"traceEvents": ev})
    share = harness.reader("temporal_share_pct")(_reading(s))
    assert share == pytest.approx(100.0 * 600 / 1000)


def test_readers_find_nothing_without_a_trace():
    r = _reading(None)
    for m in ("dwt_fwd_roofline", "dwt_inv_roofline", "temporal_share_pct",
              "device_idle_pct"):
        assert harness.reader(m)(r) is None


def test_tracer_places_its_window_in_the_middle():
    t = TR.Tracer(False, 35, 4, "cpu")
    assert (t.start_at, t.stop_at) == (15.5, 19.5)
    t.tick(16.0)
    assert not t.active and t.prof is None
    t = TR.Tracer(True, 2, 10, "cpu")
    assert (t.start_at, t.stop_at) == (0.0, 2.0)
