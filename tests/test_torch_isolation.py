"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, and importing the port builds
nothing (each CUDA source is compiled at its kernels' first launch)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)

_PROBE = """
import importlib, pkgutil, sys
import torch
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
for fuse in ("none", "pyramid"):
    pyr = repro_torch.dwt2(torch.ones(2, 16, 16), levels=2, fuse=fuse,
                           device="cpu")
    rec = repro_torch.idwt2(pyr, fuse=fuse, device="cpu")
    assert torch.allclose(rec, torch.ones(2, 16, 16), atol=1e-4)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
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


def test_subprocess_import_pulls_in_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_no_jax_and_no_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
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
