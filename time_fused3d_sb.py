#!/usr/bin/env python3
"""Times kernels B3 and B4 (csrc/fused3d.cu) on one NVIDIA GPU at the 3D
benchmark rows, at the same calls at 48^3 and at the stuffed volumes of the
transposed rows (78^3 at K=8, 82^3 at K=10), and at one shape per SB, the
plan's slabs a block of the dense H/W kernels (4, 2, 1), with the device
time of each of their kernels. Each row names the H/W kernels it ran
("h_path") and the working length of their H transforms ("hw"): "factored"
for every H from 16 to 256 (one slab pair a block, whatever SB the plan
gives; in a tree from before the working lengths, for H = 16, 32, 64, 128
only), "dense" for every other H and for a tree that has no factored
kernels.

    python3 time_fused3d_sb.py [--root DIR] [--main-rows] [--variant SPEC ...]

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
version. Prints one JSON line per row; ``--main-rows`` times the two 64^3
rows only.

Each ``--variant`` times the rows once more with kernels built with other
constants, put into a copy of the tree's ``csrc/fused3d.cu``, built with
the package's nvcc flags under ``build/`` and loaded in place of the
package's library. SPEC is either ``SB,THREADS,BLOCKS``, the factored H/W
kernels' slabs a block (kSBF), threads (kHwThreads) and blocks an SM
(kHwBlocks, the launch bounds), or ``NAME=VALUE[,NAME=VALUE...]`` naming
any ``constexpr int`` of the source, for example the D kernels' tiles:
``kDWarps=4,kDOpb=4`` (fused3d_d_mac: warps and output channels a block),
``kTapBins=32,kTapOpb=2,kTapDC=16`` (fused3d_tap_mac: bins and output
channels a block, valid d a thread), ``kStageBytes=32768``. The rows name
the variant ("default" is the tree's own library).
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
# (chain, B, Cin, Cout, D, H, W, K): the 3D benchmark rows (H = 64 runs the
# factored H/W kernels at their constant split), the same calls at 48^3 (Hw
# = 48 = 8 x 6), the stuffed volumes of the transposed rows (78^3 in two W
# blocks, Hw = 78 = 13 x 6; 82^3, Hw = 84 = 7 x 12), and volumes that keep
# each chain's plan on the dense kernels at H = 300 (NBH 151, SB = 2) and
# H = 454 (NBH 228, SB = 1)
ROWS = [
    ("B3", 2, 8, 8, 64, 64, 64, 8),
    ("B3", 2, 8, 8, 48, 48, 48, 8),
    ("B3", 2, 8, 8, 78, 78, 78, 8),
    ("B3", 2, 4, 4, 16, 300, 64, 3),
    ("B3", 2, 2, 2, 12, 454, 64, 3),
    ("B4", 2, 8, 8, 64, 64, 64, 10),
    ("B4", 2, 8, 8, 48, 48, 48, 10),
    ("B4", 2, 8, 8, 82, 82, 82, 10),
    ("B4", 2, 8, 8, 16, 454, 64, 3),
]


def variant_constants(spec):
    """[(name, value)] of a --variant SPEC."""
    if "=" not in spec:
        return list(zip(("kSBF", "kHwThreads", "kHwBlocks"), (int(v) for v in spec.split(","))))
    return [(name.strip(), int(value)) for name, value in
            (part.split("=") for part in spec.split(","))]


def variant_library(constants):
    """fused3d.cu of the timed tree built with these (name, value)
    constants."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused3d.cu").read_text()
    for name, value in constants:
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            sys.exit(f"time_fused3d_sb.py: no {name} in csrc/fused3d.cu of this tree")
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("fused3d_" + "_".join(f"{n}{v}" for n, v in constants) + ".cu")
    cu.write_text(src)
    so = cu.with_suffix(".so")
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so)), log.stdout + log.stderr


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variant", action="append", default=[], metavar="SPEC")
    parser.add_argument("--main-rows", action="store_true")
    args = parser.parse_args()
    rows = [r for r in ROWS if r[4:6] == (64, 64)] if args.main_rows else ROWS
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from fft_conv_tpu_torch.kernels import _build, fused3d

    if not torch.cuda.is_available():
        sys.exit("time_fused3d_sb.py needs a CUDA device")
    time_rows(root, "default", smoke, torch, fused3d, rows)
    load = _build.load
    for variant in args.variant:
        lib, log = variant_library(variant_constants(variant))
        print(json.dumps({"variant": variant,
                          "registers": {k: v for k, v in smoke.ptxas_registers(log).items()
                                        if "_mac" in k or "_hw_" in k},
                          "spill_bytes": {k: v for k, v in smoke.ptxas_spills(log).items()
                                          if "_mac" in k or "_hw_" in k}}), flush=True)
        _build.load = lambda name, lib=lib: lib if name == "fused3d" else load(name)
        try:
            time_rows(root, variant, smoke, torch, fused3d, rows)
        finally:
            _build.load = load


def time_rows(root, variant, smoke, torch, fused3d, rows):
    """One JSON line per row of ``rows``, inputs from a generator seeded
    with 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for chain, b, cin, cout, d, h, w, k in rows:
        x = torch.randn(b, cin, d, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, k, k, k, device=dev, generator=gen) / k ** 1.5
        # the working length of the H transforms (H itself in a tree from
        # before it)
        hw = fused3d._h_work(h)[0] if hasattr(fused3d, "_h_work") else h
        if chain == "B3":
            spectra = fused3d.kernel_spectra_3d(wt, hw)
            launch, reference = fused3d._launch_fused3d, fused3d._fused3d_forward_reference
        else:
            spectra = fused3d.kernel_spectra_tap(wt, hw)
            launch, reference = fused3d._launch_fused3d_tap, fused3d._fused3d_tap_reference
        plan = fused3d._plan_for(x.shape, wt.shape, 1)[0]
        h_path = fused3d._h_path(h) if hasattr(fused3d, "_h_path") else "dense"

        def kernel():
            return launch(x, spectra, 1, (k, k, k))

        err = float((kernel() - reference(x, wt)).abs().max())
        print(json.dumps({
            "root": root, "variant": variant, "chain": chain, "shape": [b, cin, cout, d, h, w, k],
            "plan": list(plan), "sb": fused3d._slabs_per_block(plan[1]), "h_path": h_path,
            "hw": hw,
            "max_abs_err": err,
            "ms": smoke.device_ms(kernel),
            "phase_ms": smoke.phase_split_ms(torch, kernel, "fused3d_"),
        }), flush=True)


if __name__ == "__main__":
    main()
