"""Timing probes of the window kernel (K1) on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.probe [--tree DIR] [--reps N]

Builds variants of the window kernel from the CUDA sources of the
checkout at ``DIR`` (default: this one), each a copy of
``src/repro_torch/csrc`` with one part of the table walk cut out by a text
edit, and times every variant on the main path's level-0 programs
(cdf97, 8 x 1024 x 1024 fp32 planes: the fused ns-polyconv level, the
ns-polyconv step, the sep-lifting step) with CUDA events, median of
``--reps`` launches, in each of the ``--layouts``: ``planes`` (four
planes in and out), ``image-in`` (the level's image read as its four
planes, the split folded into the gather) and ``image-out`` (the four
outputs written as one image, the merge folded into the sink).  Variants that cut barriers or terms compute wrong
values: they are for timing only, and the table says whether each output
equals the unedited kernel's.  A variant whose edit does not apply to the
sources at ``DIR`` is skipped and named.  Every variant is timed at
every block of :data:`CONFIGS`.

The edits (see :data:`VARIANTS`) exist for two walks: one barrier after
every node, and this checkout's, one barrier per dependency wave; so
with ``--tree`` pointing at an older checkout one run can set the two
designs side by side (the probe then imports that checkout's encoder,
restarting itself in a fresh process where it runs as ``-m``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
from pathlib import Path

#: variant -> text edits of the kernel sources, (old, new); a variant
#: applies when every ``old`` of one alternative is found
VARIANTS = {
    "base": [[]],
    # drop the barriers of the walk: after every node or every wave
    "nobar": [[("    }\n    __syncthreads();\n  }\n}",
                "    }\n  }\n}")],
              [("    // barrier after the wave\n    __syncthreads();",
                "    // barrier after the wave")]],
    # no term is evaluated: regions are walked and stored
    "noterms": [[("for (int t = 0; t < nt; ++t) {",
                  "for (int t = 0; t < 0; ++t) {")],
                [("      const int2* end = tm + nd.y;",
                  "      const int2* end = tm;")]],
    # inputs are gathered and stored, no lincomb node runs
    "gather": [[("      eval_node<kBf16>(nd, terms, slots, wh, ww, sink);\n",
                 "")],
               [("    eval_wave<kBf16>(",
                 "    if (false) eval_wave<kBf16>(")]],
    # float inputs through registers instead of cp.async
    "syncstage": [[("constexpr bool kAsyncStage = true;",
                    "constexpr bool kAsyncStage = false;")]],
    # the term loop not unrolled
    "nounroll": [[("#pragma unroll 2\n      for (; tm < end; ++tm) {",
                   "      for (; tm < end; ++tm) {")]],
    # threads per block
    "threads128": [[("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;")]],
    "threads512": [[("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;")]],
    # the walk at a fixed count of positions per thread (the encoder's
    # choice restricted, see ENCODER)
    "elems4": [[]],
    "elems6": [[]],
    "elems9": [[]],
    # one block per tile instead of the resident count looping over tiles
    "pertile": [[("      tiles < static_cast<long long>(per_sm) * sms ? tiles\n"
                  "                                                   : per_sm * sms);",
                  "      tiles);")]],
}

#: encoder constants a variant sets while it is encoded and timed
ENCODER = {"elems4": {"ELEMS_CHOICES": (4,)},
           "elems6": {"ELEMS_CHOICES": (6,)},
           "elems9": {"ELEMS_CHOICES": (9,)}}

#: (label, plane-space block) of the launches timed
CONFIGS = (("32x64", (32, 64)), ("32x32", (32, 32)))

PROGRAMS = (("ns-polyconv fused level", "ns-polyconv", "scheme"),
            ("ns-polyconv step", "ns-polyconv", "none"),
            ("sep-lifting step", "sep-lifting", "none"))


def _patched(tree: Path, out: Path, name: str):
    """Copy the csrc of ``tree`` to ``out/name`` with ``name``'s edits
    (each applied to every source it is found in); None when no
    alternative of the variant applies."""
    src = tree / "src" / "repro_torch" / "csrc"
    dst = out / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    files = {f: f.read_text() for f in sorted(dst.iterdir())}
    for alt in VARIANTS[name]:
        if all(any(old in t for t in files.values()) for old, _ in alt):
            for f, text in files.items():
                for old, new in alt:
                    text = text.replace(old, new)
                f.write_text(text)
            return dst
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]),
                    help="root of the checkout whose kernel sources are "
                         "probed (default: this one)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=1024,
                    help="plane edge (the main path's level 0: 1024)")
    ap.add_argument("--layouts", default="planes",
                    help="comma-separated layouts of the launch: planes, "
                         "image-in, image-out (default: planes)")
    args = ap.parse_args(argv)
    layouts = args.layouts.split(",")
    unknown = set(layouts) - {"planes", "image-in", "image-out"}
    if unknown:
        ap.error(f"unknown layouts {sorted(unknown)}")
    tree = Path(args.tree).resolve()
    loaded = sys.modules.get("repro_torch")
    if loaded is not None and (tree / "src") not in \
            Path(loaded.__file__).resolve().parents:
        # this process holds another checkout's package (``-m``): the
        # encoder must be the probed sources' own, so start a process that
        # imports the tree's
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        return subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             *(sys.argv[1:] if argv is None else argv)], env=env).returncode
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import compiler as C
    from repro_torch.kernels import tap_window as TW
    out = Path(__file__).resolve().parents[2] / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    libs, skipped = {}, []
    for name in args.variants.split(","):
        d = _patched(tree, out, name)
        if d is None:
            skipped.append(name)
            continue
        libs[name] = TW.KernelLibrary(d / "tap_window.cu", TW._bind,
                                      headers=(d / "window_common.cuh",))
    errors = []

    def build(lib):
        try:
            lib.library()
        except Exception as e:         # re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,))
               for lib in libs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, lib in libs.items():
        regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: nvcc {lib.build_seconds} s; {regs}")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    shape = (args.batch, args.size, args.size)
    planes = [torch.randn(shape, generator=g).to(dev) for _ in range(4)]
    # the same samples as one image, for the image-in layout (a tree
    # older than the layouts times planes only)
    image = TW.interleave(planes) if "image-in" in layouts else None
    runs = {"planes": lambda win: TW.tap_window(win, planes),
            "image-in": lambda win: TW.tap_window(win, image),
            "image-out": lambda win: TW.tap_window(win, planes,
                                                   image_out=True)}
    rows = []
    for (label, scheme, fuse), layout in itertools.product(PROGRAMS,
                                                           layouts):
        prog = C.compile_scheme_programs("cdf97", scheme, False, False,
                                         "full", fuse)[0]
        want = None
        run = runs[layout]
        for (name, lib), (conf, block) in itertools.product(libs.items(),
                                                            CONFIGS):
            saved = {k: getattr(TW, k) for k in ENCODER.get(name, {})}
            for k, v in ENCODER.get(name, {}).items():
                setattr(TW, k, v)
            win = TW.encode(prog, block)
            TW.LIBRARY = lib
            TW.KERNEL = TW.Kernel("tap_window", lib)
            got = run(win)
            if layout == "image-out":
                got = (got,)
            torch.cuda.synchronize()
            if want is None:
                want = got
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            for _ in range(3):
                run(win)
            times = []
            for _ in range(args.reps):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run(win)
                e.record()
                e.synchronize()
                times.append(s.elapsed_time(e))
            ms = statistics.median(times)
            grid = list(getattr(TW.KERNEL, "last_grid", ()))
            for k, v in saved.items():
                setattr(TW, k, v)
            rows.append(dict(program=label, layout=layout, variant=name,
                             config=conf, ms=ms, exact=exact,
                             block=list(win.block), smem=win.smem_bytes,
                             grid=grid))
            print(f"{label:24s} {layout:9s} {name:8s} {conf:8s} {ms:.4f} ms  "
                  f"{'exact' if exact else 'wrong (timing only)'}  block "
                  f"{win.block} smem {win.smem_bytes} grid/per-SM {grid}",
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    if skipped:
        print(f"skipped (edit does not apply to {tree}): {skipped}")
    print(json.dumps({"tree": str(tree), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    # run as a file, not as ``-m``: keep this package's directory off the
    # import path (its modules are not top-level ones)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.exit(main())
