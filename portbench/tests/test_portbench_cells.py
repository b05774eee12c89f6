"""Every cell of BENCHMARK.json end to end on the CPU at a tiny size,
and the benchmark's form."""
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.tiny import SEED, run_tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end_on_cpu(workload, trace):
    rc, result, err = run_tiny(workload, trace=trace)
    assert rc == 0, err
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = harness.cell(workload)
    want = {m["name"] for m in spec["per_layer" if trace
                                    else "end_to_end"]}
    assert set(result["metrics"]) <= want
    if not trace:
        # the CPU reads no device memory; every other end-to-end metric
        assert set(result["metrics"]) == want - {"peak_mem_gib"}
        for m in result["metrics"].values():
            assert m["value"] > 0 and math.isfinite(m["value"])
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
    # the numbers compared, each beside its limit, end standard error
    tail = err.strip().splitlines()[-len(result["checks"]):]
    for line, (k, v) in zip(tail, result["checks"].items()):
        assert line == f"check {k} {float(v['value'])!r} limit " \
                       f"{float(v['limit'])!r}"


def test_everything_is_found_by_name():
    from portbench import drivers
    from portbench import reference as REF
    for w in BENCH["workloads"]:
        spec = harness.cell(w["name"])
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
        driver = drivers.load(spec["traffic_data"]["driver"])
        for fn in ("prepare", "inputs", "warm", "request", "control", "run",
                   "compare"):
            assert callable(getattr(driver, fn)), fn
        assert REF.load(spec["config_data"]["wavelet"])
        assert spec["config_data"]["tiny"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(data)


def test_each_moves_metric_is_reported_where_it_is_read():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in CELLS
            assert harness.reports(e2e[m["moves"]], w, BENCH["end_to_end"])
    for w in CELLS:
        spec = harness.cell(w)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]


def test_benchmark_json_keeps_its_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


_PROBE = """
import io, sys
sys.path.insert(0, {root!r})
from portbench.tests.tiny import run_tiny
rc, result, err = run_tiny({workload!r}, trace={trace!r})
assert rc == 0 and result["correct"], err
print(sorted({{n.split(".")[0] for n in sys.modules}}))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_no_run_loads_jax_or_the_jax_package(workload):
    code = _PROBE.format(root=str(ROOT), workload=workload, trace=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_a_loaded_jax_package_ends_the_run_without_a_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", type(sys)("repro"))
    rc, result, err = run_tiny(CELLS[0])
    assert rc != 0 and result is None
    assert "repro" in err


def test_a_reader_that_loads_the_jax_package_ends_the_run(monkeypatch):
    """The look for the JAX stack comes after every reader has run: a
    planted reader loads a stub ``repro``."""
    real = harness.reader

    def planted(metric):
        read = real(metric)

        def loads_repro(reading):
            sys.modules["repro"] = type(sys)("repro")
            return read(reading)

        return loads_repro

    monkeypatch.setattr(harness, "reader", planted)
    try:
        rc, result, err = run_tiny(CELLS[0])
    finally:
        sys.modules.pop("repro", None)
    assert rc != 0 and result is None
    assert "repro" in err.strip().splitlines()[-1]


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = _PROBE.format(root=str(tmp_path), workload=CELLS[0], trace=False)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload):
    """On the card: ``python -m pytest -m cuda portbench/tests``."""
    import io

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, SEED, 2.0, False, out=out, err=err,
                     t_age=0.0)
    assert rc == 0, err.getvalue()[-3000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {
        m["name"] for m in harness.cell(workload)["end_to_end"]}
