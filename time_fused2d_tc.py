#!/usr/bin/env python3
"""Times kernel B2 (csrc/fused2d.cu) under its three precision modes, and
kernel B5, on one NVIDIA GPU at the 2D benchmark rows (B=2, 8 -> 8
channels, 512 x 512, K in {16, 34}), with the device time of each of their
kernels, and holds each tensor-core result to its plain version.

    python3 time_fused2d_tc.py [--root DIR] [--variant NAME=VALUE[,...] ...]

``--root`` is the checkout whose ``fft_conv_tpu_torch`` is timed (default:
the directory of this script), so that two trees can be compared in one
run on one card, for example a ``git archive`` of the parent commit
unpacked under ``build/``: run parent, change, change, parent. The timing
helpers (``device_ms``, a CUDA graph of 20 calls replayed 30 times, and
``phase_split_ms``, torch.profiler's device time per kernel) are those of
this script's own ``chip_smoke.py``. Inputs come from a torch.Generator
seeded with 0. Each row prints its kernel ("B2" or "B5"), its mode, ``ms``,
``phase_ms`` and, under "bf16x3" and "bf16", its errors against the plain
version of the mode (``chip_smoke.close_scaled`` and ``close_bf16_2d``,
"held": whether they pass). Prints one JSON line per row.

Each ``--variant`` times the tensor-core rows once more with
``csrc/fused2d.cu`` built with other values of its ``constexpr int``
constants (for example ``kMacOJ=2,kMacKC=8`` or ``kMacPlaneBytes=65536``,
which also sets the host's ``_TC_PLANE_BYTES``), built with the package's
nvcc flags under ``build/`` and loaded in place of the package's library,
with its tensor-core kernels' registers and spills.
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
# (B, Cin, Cout, H, W, K): the 2D rows of chip_smoke.py
ROWS = [(2, 8, 8, 512, 512, 16), (2, 8, 8, 512, 512, 34)]


def variant_library(constants):
    """fused2d.cu of the timed tree built with these (name, value)
    constants, and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused2d.cu").read_text()
    for name, value in constants:
        src, n = re.subn(rf"\b{name} = \d+( \* \d+)?;", f"{name} = {value};", src)
        if n != 1:
            sys.exit(f"time_fused2d_tc.py: no {name} in csrc/fused2d.cu of this tree")
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("fused2d_" + "_".join(f"{n}{v}" for n, v in constants) + ".cu")
    cu.write_text(src)
    # the tree's headers (bf16_mma.cuh) beside the copy
    so = cu.with_suffix(".so")
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                          str(so), str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so)), log.stdout + log.stderr


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variant", action="append", default=[], metavar="SPEC")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from fft_conv_tpu_torch.kernels import _build, fused2d

    if not torch.cuda.is_available():
        sys.exit("time_fused2d_tc.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    time_rows(root, "default", smoke, torch, fused2d, fused2d.PRECISION_MODES + ("v3",))
    load, plane = _build.load, getattr(fused2d, "_TC_PLANE_BYTES", None)
    for variant in args.variant:
        constants = [(n.strip(), int(v)) for n, v in (p.split("=") for p in variant.split(","))]
        lib, log = variant_library(constants)
        print(json.dumps({"variant": variant,
                          "registers": {k: v for k, v in smoke.ptxas_registers(log).items()
                                        if "_tc" in k},
                          "spill_bytes": {k: v for k, v in smoke.ptxas_spills(log).items()
                                          if "_tc" in k}}), flush=True)
        _build.load = lambda name, lib=lib: lib if name == "fused2d" else load(name)
        fused2d._TC_PLANE_BYTES = dict(constants).get("kMacPlaneBytes", plane)
        try:
            time_rows(root, variant, smoke, torch, fused2d, fused2d.PRECISION_MODES[1:])
        finally:
            _build.load, fused2d._TC_PLANE_BYTES = load, plane


def time_rows(root, variant, smoke, torch, fused2d, modes):
    """One JSON line per row and mode ("v3": B5 under "highest"), inputs
    from a generator seeded with 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, cin, cout, h, w, k in ROWS:
        x = torch.randn(b, cin, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, k, k, device=dev, generator=gen) / (cin * k * k) ** 0.5
        plan = fused2d.tile_plan_2d(k, k, cin, cout)
        spectra = fused2d.kernel_spectra_2d(wt, plan[0], plan[2], plan[3])
        planes = fused2d._planes(spectra)
        for mode in modes:
            if mode == "v3":
                def kernel():
                    return fused2d._launch_fused2d_v3(x, planes, plan, 1, (k, k))
            else:
                def kernel(mode=mode):
                    return fused2d._launch_fused2d(x, spectra, plan, 1, (k, k), mode)
            row = {"root": root, "variant": variant, "kernel": "B5" if mode == "v3" else "B2",
                   "mode": "highest" if mode == "v3" else mode, "K": k, "plan": list(plan)}
            if mode in ("bf16x3", "bf16"):
                y, y_ref = kernel(), fused2d._fused2d_forward_reference(x, wt, mode=mode)
                try:
                    if mode == "bf16x3":
                        mx, mean, sigma = smoke.close_scaled(y, y_ref, "vs plain")
                        ratio = None
                    else:
                        exact = fused2d._fused2d_forward_reference(x.double(), wt.double())
                        mx, mean, sigma, ratio = smoke.close_bf16_2d(y, y_ref, exact, "vs plain")
                    row.update(held=True, max_abs_err=mx, mean_abs_err=mean, sigma=sigma,
                               err_ratio_vs_float64=ratio)
                except RuntimeError as e:
                    row.update(held=False, error=str(e))
            row.update(ms=smoke.device_ms(kernel),
                       phase_ms=smoke.phase_split_ms(torch, kernel, "fused2d_"))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
