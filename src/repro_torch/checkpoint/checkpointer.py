"""Atomic checkpoints in the reference's on-disk format (the port's copy
of ``repro.checkpoint.checkpointer``).

Layout of one checkpoint::

    <dir>/step_000123/
        MANIFEST.json        # step, leaf paths, shapes, dtypes
        leaf_000000.npy ...  # one file per leaf, in the reference's order
        COMMITTED            # written last: presence == checkpoint valid

Leaves are taken in ``jax.tree_util`` order (:mod:`repro_torch.pytree`:
dict keys sorted, NamedTuple fields in declaration order) and the
manifest's ``paths`` are spelled as ``jax.tree_util.keystr`` spells
them, so a checkpoint written by either package restores in the other.
Everything is written into ``step_X.tmp`` and renamed after the
COMMITTED marker is in place; ``save_async`` copies the tensors to the
host at once and writes on a worker thread; the ``keep`` newest
checkpoints are retained.

numpy has no bfloat16, so a bfloat16 leaf is saved as its bytes
(``shape + (2,)`` uint8) under its logical dtype name, as the
reference's ``ml_dtypes`` path writes it; restore reads it back through
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree

_NATIVE = set("?bhilqBHILQefdgFD")
_BYTE_VIEWED = {"bfloat16": torch.bfloat16}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """One leaf as (array np.save can write, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name in _BYTE_VIEWED:
            size = t.element_size()
            return (t.reshape(-1).view(torch.uint8).reshape(
                tuple(t.shape) + (size,)).numpy().copy(), name)
        return t.numpy().copy(), name
    a = np.array(leaf)
    if a.dtype.char not in _NATIVE:
        raise TypeError(f"cannot save leaf of dtype {a.dtype}")
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str in _BYTE_VIEWED:
        dt = _BYTE_VIEWED[dtype_str]
        size = torch.empty((), dtype=dt).element_size()
        if a.dtype == np.uint8 and a.ndim and a.shape[-1] == size:
            return torch.from_numpy(np.array(a)).reshape(-1) \
                .view(dt).reshape(a.shape[:-1])
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)
    if str(a.dtype) != dtype_str:
        a = a.astype(np.dtype(dtype_str), copy=False)
    return torch.from_numpy(np.array(a))  # a writable copy, 0-d kept


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- discovery ---------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                try:
                    steps.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    # -- save ---------------------------------------------------------------

    @staticmethod
    def _snapshot(tree):
        flat = pytree.leaves_with_path(tree)
        return ([pytree.keystr(p) for p, _ in flat],
                [_to_host(leaf) for _, leaf in flat])

    def save(self, step: int, tree: Any) -> Path:
        """Synchronous atomic save."""
        return self._write(step, *self._snapshot(tree))

    def save_async(self, step: int, tree: Any) -> None:
        """Snapshot to host memory now, write on a background thread."""
        self.wait()
        paths, host = self._snapshot(tree)

        def run():
            try:
                self._write(step, paths, host)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the pending async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, paths, host) -> Path:
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "format": 1,
            "num_leaves": len(host),
            "paths": paths,
            "shapes": [list(a.shape[:-1]) if dt in _BYTE_VIEWED
                       else list(a.shape) for a, dt in host],
            "dtypes": [dt for _, dt in host],
        }
        for i, (arr, _) in enumerate(host):
            np.save(tmp / f"leaf_{i:06d}.npy", arr, allow_pickle=False)
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        committed = sorted(
            [p for p in self.dir.glob("step_*") if (p / "COMMITTED").exists()],
            key=lambda p: p.name)
        for p in committed[:-self.keep]:
            shutil.rmtree(p)

    # -- restore -------------------------------------------------------------

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``template``.

        Each leaf comes back as a tensor of the checkpoint's dtype on the
        device of the template's leaf (the host for a non-tensor leaf),
        requiring grad where the template's leaf does.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        src = self.dir / f"step_{step:09d}"
        manifest = json.loads((src / "MANIFEST.json").read_text())
        leaves_t = pytree.leaves(template)
        if len(leaves_t) != manifest["num_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['num_leaves']} leaves, template "
                f"has {len(leaves_t)} — structure mismatch")
        out = []
        for i, tl in enumerate(leaves_t):
            t = _from_host(np.load(src / f"leaf_{i:06d}.npy"),
                           manifest["dtypes"][i])
            if tuple(t.shape) != tuple(np.shape(tl)):
                raise ValueError(
                    f"leaf {i} shape {tuple(t.shape)} != template "
                    f"{tuple(np.shape(tl))}")
            if isinstance(tl, torch.Tensor):
                t = t.to(tl.device)
                if tl.requires_grad:
                    t.requires_grad_(True)
            out.append(t)
        return pytree.unflatten(template, out), step
