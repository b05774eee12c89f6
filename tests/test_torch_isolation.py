"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package nor ``ml_dtypes`` (which ships
with JAX only), and importing the port — or driving its CPU paths, the
profiler, a CPU server and a compressed train step included — builds
nothing (each CUDA source is compiled at its kernels' first launch).
The import and the source scan cover every module of the port, the MoE,
RWKV6 and Mamba2 modules and the example entry points among them."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)(\.|\s|$)",
    re.MULTILINE)

_PROBE = """
import importlib, os, pkgutil, sys
import torch
import torch._dynamo  # models/__init__.py imports it; it sets an inductor
import repro_torch    # cache path in the environment when imported
env = dict(os.environ)
names = []
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
# the launch tooling among them; importing starts no process group and
# sets no environment variable (the dry run starts its fake group in main)
assert {"repro_torch.launch.mesh", "repro_torch.launch.specs",
        "repro_torch.launch.analysis", "repro_torch.launch.dryrun",
        "repro_torch.distributed.sharding"} <= set(names), names
# the entry points among them; importing one runs nothing
assert {"repro_torch.examples." + m for m in (
    "quickstart", "dwt_image_codec", "train_lm", "wavelet_compression_demo",
    "serve_lm")} <= set(names), names
import torch.distributed as dist
assert not (dist.is_available() and dist.is_initialized())
assert dict(os.environ) == env
for fuse in ("none", "pyramid"):
    pyr = repro_torch.dwt2(torch.ones(2, 16, 16), levels=2, fuse=fuse,
                           device="cpu")
    rec = repro_torch.idwt2(pyr, fuse=fuse, device="cpu")
    assert torch.allclose(rec, torch.ones(2, 16, 16), atol=1e-4)
    # the tiling slice: tiled plans and the out-of-core stream
    tiled = repro_torch.dwt2(torch.ones(2, 32, 32), levels=2, fuse=fuse,
                             tiles=(16, 16), device="cpu")
    rec = repro_torch.idwt2(tiled, fuse=fuse, tiles=(16, 16), device="cpu")
    assert torch.allclose(rec, torch.ones(2, 32, 32), atol=1e-4)
    streamed = repro_torch.stream_dwt2(torch.ones(32, 32).numpy(), levels=2,
                                       tiles=(16, 16), fuse=fuse,
                                       device="cpu")
    assert streamed.ll.shape == (8, 8)
# the profiler and serving slice: a CPU serve_map resolving "auto", a
# warmed store, and the inverse path
import numpy as np
from repro_torch import profiler, serve
imgs = [np.full((16, 16), float(i), np.float32) for i in range(3)]
pyrs = serve.serve_map(imgs, config=serve.ServeConfig(device="cpu",
                                                      max_batch=2),
                       levels=2, backend="auto")
assert [p.ll.shape for p in pyrs] == [(4, 4)] * 3
recs = profiler.warm_store(shape=(1, 16, 16), levels=1, reps=1,
                           device="cpu")
key = repro_torch.PlanKey("cdf97", "ns-polyconv", 1, (1, 16, 16), "float32",
                          "auto", False, "none", "periodic", device="cpu")
assert recs and profiler.choose(key).source == "store"
# the LM slice: a compressed train step, prefill and decode on the CPU
import dataclasses
from repro_torch.configs.registry import get_config
from repro_torch.runtime import steps
cfg, run = get_config("qwen2-0.5b", smoke=True)
run = dataclasses.replace(run, grad_compression="dwt:2")
state = steps.init_train_state(torch.Generator().manual_seed(0), cfg, run,
                               device="cpu")
toks = torch.randint(0, cfg.vocab_size, (4, 32),
                     generator=torch.Generator().manual_seed(1))
state, metrics = steps.train_step(state, {"tokens": toks}, cfg, run)
assert int(state.step) == 1 and bool(torch.isfinite(metrics["loss"]))
logits, cache = steps.prefill_step(state.params, {"tokens": toks[:, :8]},
                                   cfg, 16)
logits, cache = steps.decode_step(state.params, cache, toks[:, 8:9], cfg)
assert int(cache["pos"]) == 9
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
from repro_torch.kernels import pyramid_window, tap_window
for lib in (tap_window.LIBRARY, pyramid_window.LIBRARY):
    assert lib._lib is None
for k in (tap_window.KERNEL, pyramid_window.FORWARD, pyramid_window.INVERSE):
    assert k.launches == 0
print("ok")
"""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_subprocess_import_pulls_in_no_jax_and_no_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_PROFILE_STORE=str(tmp_path / "store.jsonl"),
               REPRO_TORCH_BLOCK_TABLE=str(tmp_path / "table.json"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_no_jax_and_no_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


#: the port's lower layers, and the layers above them they may not import
LOWER = ("kernels", "compiler", "telemetry")
ABOVE = tuple(f"repro_torch.{m}" for m in ("engine", "tiling", "profiler",
                                           "serve"))


def _imports(path: Path):
    """Every module an import statement of ``path`` names, at any depth
    (a function's deferred imports included), relative ones resolved;
    ``from a import b`` names both ``a`` and ``a.b``."""
    package = ".".join(path.relative_to(PORT.parent).parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:
                base = package.rsplit(".", node.level - 1)[0]
                module = f"{base}.{module}" if module else base
            yield module
            yield from (f"{module}.{a.name}" for a in node.names)


@pytest.mark.parametrize(
    "path", [p for d in LOWER for p in sorted((PORT / d).glob("*.py"))],
    ids=lambda p: f"{p.parent.name}/{p.name}")
def test_lower_layers_import_nothing_above_them(path):
    """kernels/, compiler/ and telemetry/ sit below the engine: none of
    their modules imports the engine, tiling, the profiler or the server,
    at module top or deferred inside a function."""
    hits = sorted({m for m in _imports(path) if m in ABOVE
                   or m.startswith(tuple(a + "." for a in ABOVE))})
    assert not hits, f"{path} imports {hits}"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line;
    copied into an otherwise empty directory it cannot import the port."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone), "--cpu-rehearsal"],
                         env=env, capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
