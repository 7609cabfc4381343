#!/usr/bin/env python3
"""Times kernels B3 and B4 (csrc/fused3d.cu) on one NVIDIA GPU at one shape
per SB, the plan's slabs a block of the dense H/W kernels (4, 2, 1), with
the device time of each of their kernels. Each row names the H/W kernels it
ran ("h_path"): "factored" for H = 16, 32, 64, 128 (one slab pair a block,
whatever SB the plan gives), "dense" for every other H and for a tree that
has no factored kernels.

    python3 time_fused3d_sb.py [--root DIR] [--variant SB,THREADS,BLOCKS ...]

``--root`` is the checkout whose ``fft_conv_tpu_torch`` is timed (default:
the directory of this script), so that two trees can be compared in one
run on one card, for example a ``git archive`` of the parent commit
unpacked under ``build/``: run parent, change, change, parent. The timing
helpers (``device_ms``, a CUDA graph of 20 calls replayed 30 times, and
``phase_split_ms``, torch.profiler's device time per kernel) are those of
this script's own ``chip_smoke.py``; ``device_ms`` runs the package's
``bench.harness.graph_seconds``, so a tree under ``--root`` must have
``fft_conv_tpu_torch/bench/harness.py``. Inputs come from a torch.Generator
seeded with 0; each row also prints its max abs error against the plain
version. Prints one JSON line per row.

Each ``--variant`` times the rows once more with the factored H/W kernels
built with other constants: the slabs a block holds (kSBF), its threads
(kHwThreads) and the blocks an SM is to hold (kHwBlocks, the launch bounds)
put into a copy of the tree's ``csrc/fused3d.cu``, built with the package's
nvcc flags under ``build/`` and loaded in place of the package's library.
The rows name the variant ("default" is the tree's own library).
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (chain, B, Cin, Cout, D, H, W, K): the 3D benchmark rows (SB = 4; H = 64
# runs the factored H/W kernels) and the largest volumes of chip_smoke.py's
# checks that keep each chain's plan at H = 226 (NBH 114, SB = 2) and H = 454
# (NBH 228, SB = 1), both dense
ROWS = [
    ("B3", 2, 8, 8, 64, 64, 64, 8),
    ("B3", 2, 4, 4, 16, 226, 64, 3),
    ("B3", 2, 2, 2, 12, 454, 64, 3),
    ("B4", 2, 8, 8, 64, 64, 64, 10),
    ("B4", 2, 8, 8, 16, 454, 64, 3),
]


def variant_library(sb, threads, blocks):
    """fused3d.cu of the timed tree built with the factored H/W kernels'
    constants kSBF, kHwThreads and kHwBlocks set to these values."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused3d.cu").read_text()
    for name, value in (("kSBF", sb), ("kHwThreads", threads), ("kHwBlocks", blocks)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            sys.exit(f"time_fused3d_sb.py: no {name} in csrc/fused3d.cu of this tree")
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"fused3d_{sb}_{threads}_{blocks}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variant", action="append", default=[], metavar="SB,THREADS,BLOCKS")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from fft_conv_tpu_torch.kernels import _build, fused3d

    if not torch.cuda.is_available():
        sys.exit("time_fused3d_sb.py needs a CUDA device")
    time_rows(root, "default", smoke, torch, fused3d)
    load = _build.load
    for variant in args.variant:
        lib = variant_library(*(int(v) for v in variant.split(",")))
        _build.load = lambda name, lib=lib: lib if name == "fused3d" else load(name)
        try:
            time_rows(root, variant, smoke, torch, fused3d)
        finally:
            _build.load = load


def time_rows(root, variant, smoke, torch, fused3d):
    """One JSON line per row of ROWS, inputs from a generator seeded with 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for chain, b, cin, cout, d, h, w, k in ROWS:
        x = torch.randn(b, cin, d, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, k, k, k, device=dev, generator=gen) / k ** 1.5
        if chain == "B3":
            spectra = fused3d.kernel_spectra_3d(wt, h)
            launch, reference = fused3d._launch_fused3d, fused3d._fused3d_forward_reference
        else:
            spectra = fused3d.kernel_spectra_tap(wt, h)
            launch, reference = fused3d._launch_fused3d_tap, fused3d._fused3d_tap_reference
        plan = fused3d._plan_for(x.shape, wt.shape, 1)[0]
        h_path = fused3d._h_path(h) if hasattr(fused3d, "_h_path") else "dense"

        def kernel():
            return launch(x, spectra, 1, (k, k, k))

        err = float((kernel() - reference(x, wt)).abs().max())
        print(json.dumps({
            "root": root, "variant": variant, "chain": chain, "shape": [b, cin, cout, d, h, w, k],
            "plan": list(plan), "sb": fused3d._slabs_per_block(plan[1]), "h_path": h_path,
            "max_abs_err": err,
            "ms": smoke.device_ms(kernel),
            "phase_ms": smoke.phase_split_ms(torch, kernel, "fused3d_"),
        }), flush=True)


if __name__ == "__main__":
    main()
