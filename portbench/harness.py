"""One run of one workload: set-up, the measured window, the check, the
result line.

Everything a workload is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in ``portbench/configs/``; its
traffic, a data file in ``portbench/traffic/`` that names its driver in
``portbench/drivers/`` (:mod:`portbench.drivers`); the reference of the
configuration's wavelet in ``portbench/reference/``; the limits of its
check in ``portbench/limits/``; and a reader for each metric it reports
in ``portbench/metrics/<metric>.py`` (a function ``read(reading)`` that
returns the value, or None where it finds nothing to read).

The program under test is the PyTorch and CUDA package ``repro_torch``
under ``src/`` of the checkout; nothing here imports the JAX package.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, TextIO

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
#: top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's settings a run fixes, so that the environment it is
#: started in does not steer the path it measures
PROGRAM_ENV_CLEARED = (
    "REPRO_TORCH_TELEMETRY", "REPRO_TORCH_TELEMETRY_PROFILER",
    "REPRO_TORCH_TELEMETRY_RING", "REPRO_TORCH_FAULTS",
    "REPRO_TORCH_FAULTS_SEED", "REPRO_TORCH_RESILIENCE",
    "REPRO_TORCH_RESILIENCE_RETRIES", "REPRO_TORCH_RESILIENCE_VERIFY",
    "REPRO_TORCH_PYRAMID_SMEM_LIMIT")
#: the warning torch's sync debug mode gives at a synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"


def process_age() -> Optional[float]:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - \
            ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# Finding a workload by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str, end_to_end: List[dict]) -> bool:
    """Whether ``workload`` reports ``metric``: listed under the metric's
    ``workloads``, or, without that key, wherever the end-to-end metric
    it moves (or, for an end-to-end metric, every workload)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moved = metric.get("moves")
    if moved is None:
        return True
    return any(m["name"] == moved and reports(m, workload, end_to_end)
               for m in end_to_end)


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The workload's entry with its configuration, traffic, limits and
    the metrics it reports (``end_to_end`` and ``per_layer``)."""
    bench = bench if bench is not None else load_json(BENCHMARK)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}; "
                       f"workloads: {[w['name'] for w in bench['workloads']]}")
    entry = dict(found[0])
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    entry["config_data"] = load_json(ROOT / conf["file"])
    entry["traffic_data"] = load_json(HERE / "traffic"
                                      / f"{entry['traffic']}.json")
    e2e = bench["end_to_end"]
    entry["end_to_end"] = [m for m in e2e if reports(m, name, e2e)]
    entry["per_layer"] = [m for m in bench["per_layer"]
                          if reports(m, name, e2e)]
    return entry


def reader(metric: str) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Environment and the program
# ---------------------------------------------------------------------------

def fix_environment(scratch: Path) -> None:
    """Build caches at fixed paths inside the checkout; the program's
    profile store and block table in this run's own scratch directory,
    so that nothing one run writes steers the next; the program's
    settings at their defaults."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["REPRO_TORCH_PROFILE_STORE"] = str(scratch / "store.jsonl")
    os.environ["REPRO_TORCH_BLOCK_TABLE"] = str(scratch / "blocks.json")
    for key in PROGRAM_ENV_CLEARED:
        os.environ.pop(key, None)


def import_program():
    """``repro_torch`` from the checkout's ``src``."""
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise ImportError(f"repro_torch comes from {repro_torch.__file__}, "
                          f"not from this checkout's {src}")
    return repro_torch


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def power_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

class Reading(types.SimpleNamespace):
    """What one run measured, for the metric readers: ``setup_s``,
    ``window`` (:class:`portbench.window.Window`), ``memory_peak_bytes``,
    ``kept_bytes`` (the check's kept outputs), ``request_samples``,
    ``itemsize`` and ``summary`` (:class:`portbench.trace.Summary` of a
    traced run, else None)."""


def _log(err: TextIO, text: str) -> None:
    print(text, file=err, flush=True)


def run(name: str, seed: int, seconds: float, trace: bool,
        device_type: str = "cuda", config_overrides: Optional[dict] = None,
        control: bool = False, wrap: Optional[Callable] = None,
        out: TextIO = sys.stdout, err: TextIO = sys.stderr,
        t_age: Optional[float] = None) -> int:
    """Run one workload and print its result line; returns the exit
    code.  ``device_type="cpu"`` (the CPU tests) runs the kernels' plain
    versions and skips the look for a card; ``config_overrides`` shrink
    the configuration for them; ``control`` puts the check's control in
    the program's place: the reference computed in bfloat16; ``wrap``
    wraps the entry points (the tests' planted faults); ``t_age`` is the
    process's age to count set-up from (read from ``/proc`` if None)."""
    t_begin = time.perf_counter()
    age = process_age() if t_age is None else t_age
    origin = t_begin - (age or 0.0)
    scratch = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(name, seed, seconds, trace, device_type,
                    config_overrides or {}, control, wrap, out, err,
                    origin, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run(name, seed, seconds, trace, device_type, overrides, control, wrap,
         out, err, origin, scratch) -> int:
    spec = cell(name)
    config = dict(spec["config_data"], **overrides)
    traffic = spec["traffic_data"]
    parts: Dict[str, float] = {}

    t = time.perf_counter()
    fix_environment(scratch)
    import torch
    if device_type == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < int(spec["chips"])):
        _log(err, f"portbench: {name} needs {spec['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(1)
    program = import_program()
    from repro_torch.faults import degrade
    from portbench import check as CK
    from portbench import data as D
    from portbench import drivers
    from portbench import reference as REF
    from portbench import trace as TR
    driver = drivers.load(traffic["driver"])
    reference = REF.load(config["wavelet"])
    parts["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cuda = device_type == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    parts["cuda_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    prepared = driver.prepare(program, config, traffic, device)
    parts["extension_load_s"] = time.perf_counter() - t
    _log(err, f"portbench: {prepared.describe}")

    t = time.perf_counter()
    inputs = driver.inputs(D.make(config, seed, device), traffic)
    if cuda:
        torch.cuda.synchronize()
    parts["data_s"] = time.perf_counter() - t

    entry = driver.control(reference, config, traffic, device) \
        if control else prepared.entry
    if wrap is not None:
        entry = wrap(entry)
    t = time.perf_counter()
    driver.warm(entry, inputs, traffic)
    syncs = _syncs(torch, lambda: driver.request(entry, inputs[0])) \
        if cuda else 0
    tracer = TR.Tracer(trace, seconds, traffic["trace_seconds"],
                       device_type)
    tracer.warm()
    parts["warmup_s"] = time.perf_counter() - t
    fallbacks_before = _fallbacks(degrade)

    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - origin
    _log(err, "portbench: setup " + " ".join(
        f"{k}={v:.3f}" for k, v in parts.items())
        + f" syncs_per_request={syncs} setup_s={setup_s:.3f}")
    gc.disable()
    try:
        window = driver.run(entry, inputs, traffic, seconds, seed,
                            device_type, tracer)
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    fallbacks = _fallbacks(degrade) - fallbacks_before
    _log(err, f"portbench: card {power_line() if cuda else 'cpu'}; "
              f"{window.completed} requests in {window.seconds:.3f} s")

    # the program's state goes before the reference runs
    degraded, request_shape = prepared.degraded, prepared.request_shape
    del entry, prepared
    program.clear_plan_cache()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    limit = CK.limits(name)
    numbers = dict.fromkeys(limit, 0.0)
    for kept in window.kept:
        got = driver.compare(reference, config, traffic, inputs[kept.slot],
                             kept)
        numbers.update({k: max(numbers.get(k, 0.0), v)
                        for k, v in got.items()})
    numbers["fallbacks"] = float(fallbacks + degraded)
    correct = bool(window.kept) and CK.judge(numbers, limit)
    _log(err, f"portbench: check of {len(window.kept)} requests took "
              f"{time.perf_counter() - t:.3f} s")
    kept_bytes = window.kept_bytes
    del window.kept[:]

    summary = TR.reduce(tracer.export(scratch / "trace.json")) \
        if trace else None
    reading = Reading(
        setup_s=setup_s, window=window, memory_peak_bytes=peak,
        kept_bytes=kept_bytes,
        request_samples=math.prod(request_shape),
        itemsize=getattr(torch, config["dtype"]).itemsize, summary=summary)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(spec["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = summary.busy_s if summary else 0.0
        dev["window_s"] = summary.window_s if summary else 0.0
    result = {"correct": correct, "attempted": window.completed,
              "failed": 0, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = TR.breakdown(summary)
    result["checks"] = {k: {"value": numbers[k], "limit": limit[k]}
                        for k in limit}

    # the last step before the result: whatever ran after the window
    # (the check, the trace's reduction, every reader) has loaded what
    # it loads
    loaded = forbidden_modules()
    if loaded:
        _log(err, "portbench: modules of the JAX stack or the JAX package "
                  "are loaded: " + ", ".join(loaded))
        return 3
    for k in limit:
        _log(err, f"check {k} {float(numbers[k])!r} limit "
                  f"{float(limit[k])!r}")
    print(json.dumps(result), file=out, flush=True)
    return 0


def _syncs(torch, one_request) -> int:
    """Synchronising calls in one request, as torch's sync debug mode
    counts them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one_request()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def _fallbacks(degrade) -> int:
    return int(sum(row["value"] for row in degrade.FALLBACKS.series()))
