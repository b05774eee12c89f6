"""The program's spans and counters as the per-layer readers read them:
a hand-made Chrome trace with the program's ranges inside the harness's,
a CPU profile found on the stack, and the counters per request."""
import sys
import types

import pytest

from portbench import harness, program
from portbench import trace as TR


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _range(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, corr, tid=7)


def _doc():
    """One dwt3/idwt3 round trip whose launches all reached the trace,
    then a forward whose one launch did not.  Microseconds."""
    ev = [
        _range("portbench.forward", 0, 100),
        _range("call.dwt3", 5, 90),
        _range("plan.lookup", 10, 10),
        _range("execute.forward", 25, 65),
        _range("level3.forward", 30, 55),
        _range("temporal.forward", 32, 18),
        _launch(40, 1),
        _range("planes.split", 55, 5),
        _launch(57, 2),
        _launch(70, 3),
        _kernel("roll_cuda_kernel", 200, 30, 1),
        _kernel("direct_copy_kernel_cuda", 230, 10, 2),
        _kernel("tap_window_kernel", 240, 50, 3),
        _range("portbench.inverse", 110, 90),
        _range("call.idwt3", 112, 83),
        _range("plan.lookup", 113, 5),
        _range("execute.inverse", 120, 70),
        _range("level3.inverse", 121, 68),
        _range("planes.merge", 130, 10),
        _launch(135, 4),
        _range("temporal.inverse", 150, 30),
        _launch(160, 5),
        _kernel("CatArrayBatchedCopy", 290, 20, 4),
        _kernel("CUDAFunctor_add", 310, 40, 5),
        _range("portbench.forward", 300, 100),
        _range("call.dwt3", 305, 90),
        _launch(350, 6),
        {"ph": "i", "name": "instant"},
    ]
    return {"traceEvents": ev}


def test_reduce_reads_self_time_first_launch_and_device_time():
    p = program.reduce(_doc())
    calls = p.spans["call.dwt3"]
    assert calls.instances == 2
    assert calls.host_s == pytest.approx(180e-6)
    # 90 less plan.lookup and execute.forward; the second has no child
    assert calls.self_s == pytest.approx((15 + 90) * 1e-6)
    assert p.spans["call.idwt3"].self_s == pytest.approx(8e-6)
    assert p.spans["execute.forward"].self_s == pytest.approx(10e-6)
    assert p.spans["level3.forward"].self_s == pytest.approx(32e-6)
    assert p.spans["plan.lookup"].instances == 2
    assert p.first_launch_s == pytest.approx([35e-6, 23e-6, 45e-6])
    # the second forward lost its launch: its round trip is not counted
    assert p.round_trip_s == pytest.approx(150e-6)
    assert p.spans["temporal.forward"].device_s == pytest.approx(30e-6)
    assert p.spans["level3.forward"].device_s == pytest.approx(90e-6)
    assert p.spans["call.dwt3"].device_s == pytest.approx(90e-6)
    assert p.calls == 3
    assert p.device_pct("temporal.") == pytest.approx(100 * 70 / 150)
    assert p.device_pct("planes.") == pytest.approx(100 * 30 / 150)
    assert p.device_pct("packet.") is None
    assert not any(n.startswith("portbench.") for n in p.spans)


def test_ranges_may_be_host_operations_named_like_spans():
    """In the program's default mode its ranges are host operations of
    the span's name; operators, runtime calls and the profiler's own
    events are not ranges."""
    doc = _doc()
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" \
                and not e["name"].startswith("portbench."):
            e["cat"] = "cpu_op"
    doc["traceEvents"] += [_x("cpu_op", "aten::roll", 33, 10),
                           _x("cpu_op", "cudaFuncSetAttribute", 71, 1),
                           _x("cpu_op", "Activity Buffer Request", 80, 1)]
    p = program.reduce(doc)
    assert p == program.reduce(_doc())
    assert set(p.spans) == set(program.reduce(_doc()).spans)


def test_reduce_of_a_trace_without_program_ranges_is_none():
    assert program.reduce(None) is None
    ev = [e for e in _doc()["traceEvents"]
          if not e.get("name", "").startswith(("call.", "plan.", "exec",
                                                "level3.", "temporal.",
                                                "planes."))]
    assert program.reduce({"traceEvents": ev}) is None


def _reading(doc):
    r = harness.Reading(setup_s=1.0, window=None, memory_peak_bytes=0,
                        kept_bytes=0, request_samples=1, itemsize=4,
                        summary=TR.reduce(doc))
    r._program = program.reduce(doc)
    return r


def test_span_readers_compute_their_metrics():
    r = _reading(_doc())
    read = {m: harness.reader(m)(r) for m in (
        "dispatch_self_us", "first_launch_us", "temporal_pass_pct",
        "plane_copy_pct", "temporal_share_pct")}
    # (15 + 90 + 8) call.* + 15 plan.lookup + (10 + 2) execute.*, 3 calls
    assert read["dispatch_self_us"] == pytest.approx(140 / 3)
    assert read["first_launch_us"] == pytest.approx(103 / 3)
    assert read["temporal_pass_pct"] == pytest.approx(100 * 70 / 150)
    assert read["plane_copy_pct"] == pytest.approx(20.0)
    # the span holds every kernel of the pass the name list finds
    assert read["temporal_pass_pct"] >= read["temporal_share_pct"]
    empty = _reading({"traceEvents": []})
    for m in ("dispatch_self_us", "first_launch_us", "temporal_pass_pct",
              "plane_copy_pct"):
        assert harness.reader(m)(empty) is None, m


class _Metric:
    def __init__(self, rows):
        self.rows = rows

    def series(self):
        return self.rows


def _telemetry(**metrics):
    reg = types.SimpleNamespace(get=lambda name: metrics.get(name))
    return types.SimpleNamespace(REGISTRY=reg)


def test_counter_readers_divide_by_forward_executions(monkeypatch):
    execs = _Metric([{"labels": {"op": "forward"}, "value": 4},
                     {"labels": {"op": "inverse"}, "value": 4}])
    copies = _Metric([{"labels": {"op": "split"}, "value": 4 * 1.3e9},
                      {"labels": {"op": "merge"}, "value": 4 * 2.6e9}])
    launches = _Metric([{"labels": {"kernel": "tap_window"}, "value": 80}])
    monkeypatch.setitem(
        sys.modules, "repro_torch.telemetry",
        _telemetry(repro_plan_executions_total=execs,
                   repro_plane_copy_bytes_total=copies,
                   repro_kernel_launches_total=launches))
    r = _reading({"traceEvents": []})
    assert harness.reader("plane_copy_gb")(r) == pytest.approx(3.9)
    assert harness.reader("kernel_launches")(r) == 20
    # a program without the counters (an older one) reads nothing
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry",
                        _telemetry(repro_plan_executions_total=execs))
    assert harness.reader("plane_copy_gb")(r) is None
    assert harness.reader("kernel_launches")(r) is None


def test_of_rebuilds_the_trace_from_the_runs_profile():
    """A traced run's profile, found on the stack as the harness holds
    it, gives the program's ranges nested as they ran."""
    import torch
    from torch.profiler import record_function
    tracer = TR.Tracer(True, 1.0, 1.0, "cpu")
    tracer.tick(0.0)
    with record_function("portbench.forward"):
        with record_function("call.dwt2"):
            with record_function("plan.lookup"):
                torch.ones(4)
            torch.ones(4) + 1
    tracer.stop()
    reading = types.SimpleNamespace()
    p = program.of(reading)
    assert program.of(reading) is p
    call = p.spans["call.dwt2"]
    assert call.instances == 1 and p.spans["plan.lookup"].instances == 1
    assert 0 < call.self_s < call.host_s
    # its one nested range is plan.lookup
    assert call.host_s - call.self_s == pytest.approx(
        p.spans["plan.lookup"].host_s)
    assert "portbench.forward" not in p.spans
    assert program.of(types.SimpleNamespace()) is not None
