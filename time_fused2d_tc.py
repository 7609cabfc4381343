#!/usr/bin/env python3
"""Times kernels B2 and B5 (csrc/fused2d.cu) under their three precision
modes on one NVIDIA GPU at the 2D benchmark rows (B=2, 8 -> 8 channels,
512 x 512, K in {16, 34}), with the device time of each of their kernels,
and holds each tensor-core result to its plain version.

    python3 time_fused2d_tc.py [--root DIR] [--variant NAME=VALUE[,...] ...]

``--root`` is the checkout whose ``fft_conv_tpu_torch`` is timed (default:
the directory of this script), so that two trees can be compared in one
run on one card, for example a ``git archive`` of the parent commit
unpacked under ``build/``: run parent, change, change, parent. The timing
helpers (``device_ms``, a CUDA graph of 20 calls replayed 30 times, and
``phase_split_ms``, torch.profiler's device time per kernel) are those of
this script's own ``chip_smoke.py``. Inputs come from a torch.Generator
seeded with 0. Each row prints its kernel ("B2" or "B5"), its mode, ``ms``,
``phase_ms``, ``graph`` (``graph_trace``: each kernel's time inside one
replay of that CUDA graph, and the idle time between consecutive kernels,
which ``ms`` holds and ``phase_ms`` does not) and, under "bf16x3" and
"bf16", its errors against the plain version of the mode
(``chip_smoke.close_scaled`` and ``close_bf16_2d``, "held": whether they
pass). Prints one JSON line per row.

Each ``--variant`` times the tensor-core rows once more with
``csrc/fused2d.cu`` built with other values of its ``constexpr int``
constants (for example ``kMacOJ=2,kMacKC=8`` or ``kMacPlaneBytes=65536``,
which also sets the host's ``_TC_PLANE_BYTES``), built with the package's
nvcc flags under ``build/`` and loaded in place of the package's library,
with its tensor-core kernels' registers and spills. Each ``--knockout
NAME`` (``KNOCKOUTS``) times B5's route under "bf16x3" with one part of
its kernels taken out, built the same way: its results are then wrong and
not checked, and what the stage loses is what that part costs. (With its
stores gone the compiler drops the products that fed them too.)
"""

import argparse
import concurrent.futures
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


# --knockout NAME: (kernel, its text, what replaces it) in csrc/fused2d.cu,
# each taking one part of B5's tensor-core route out
KNOCKOUTS = {
    "window": ("fused2d_v3_spectra_tc", "h < T1; h += kThreads / T2", "h < 0; h += kThreads / T2"),
    "h_forward": ("fused2d_v3_spectra_tc", "c0 < N2; c0 += G", "c0 < 0; c0 += G"),
    "w_forward": ("fused2d_v3_spectra_tc", "r0 < N1; r0 +=", "r0 < 0; r0 +="),
    "h_inverse": ("fused2d_v3_inverse_tc", "c0 < N2; c0 += G", "c0 < 0; c0 += G"),
    "h_inverse_loads": ("fused2d_v3_inverse_tc", "return folded_s_tc<T1, T2>(",
                        "return s_p[sw<T2>((j1 * B1 + m % B1) % (T1 / 2), c0 + m / B1)];"
                        " (void)folded_s_tc<T1, T2>("),
    "c2r": ("fused2d_v3_inverse_tc", "p0 < pe; p0 +=", "p0 < 0; p0 +="),
    "c2r_loads": ("fused2d_v3_inverse_tc", "return pair_c2r_in<T2>(",
                  "return s_p[sw<T2>(p, c)]; (void)pair_c2r_in<T2>("),
    "c2r_stores": ("fused2d_v3_inverse_tc", "if (z < v2 && ox < ow && oy < oh)", "if (z < 0)"),
}


def variant_library(constants):
    """fused2d.cu of the timed tree built with these (name, value)
    constants, and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused2d.cu").read_text()
    for name, value in constants:
        src, n = re.subn(rf"\b{name} = \d+( \* \d+)?;", f"{name} = {value};", src)
        if n != 1:
            sys.exit(f"time_fused2d_tc.py: no {name} in csrc/fused2d.cu of this tree")
    return built_library(src, "_".join(f"{n}{v}" for n, v in constants))


def knockout_library(name):
    """fused2d.cu of the timed tree built without the part KNOCKOUTS[name]
    names, and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused2d.cu").read_text()
    kernel, text, replacement = KNOCKOUTS[name]
    start = src.index(f"\n{kernel}(")
    end = src.index("\n}\n", start)
    if text not in src[start:end]:
        sys.exit(f"time_fused2d_tc.py: no {text!r} in {kernel} of this tree")
    body = src[start:end].replace(text, replacement, 1)
    return built_library(src[:start] + body + src[end:], f"knockout_{name}")


def built_library(src, tag):
    """fused2d.cu's text ``src`` built under build/ with the package's nvcc
    flags and loaded, and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"fused2d_{tag}.cu"
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
    parser.add_argument("--knockout", action="append", default=[], choices=sorted(KNOCKOUTS))
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
    time_rows(root, "default", smoke, torch, fused2d,
              [(kernel, mode) for kernel in ("B2", "B5") for mode in fused2d.PRECISION_MODES])
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
            time_rows(root, variant, smoke, torch, fused2d,
                      [(kernel, mode) for kernel in ("B2", "B5")
                       for mode in fused2d.PRECISION_MODES[1:]])
        finally:
            _build.load, fused2d._TC_PLANE_BYTES = load, plane
    with concurrent.futures.ThreadPoolExecutor() as pool:  # one nvcc a knockout, all at once
        libs = list(pool.map(knockout_library, args.knockout))
    for name, (lib, _) in zip(args.knockout, libs):
        _build.load = lambda name, lib=lib: lib if name == "fused2d" else load(name)
        try:
            time_rows(root, f"knockout {name}", smoke, torch, fused2d, [("B5", "bf16x3")],
                      held=False)
        finally:
            _build.load = load


def graph_trace(torch, fn, calls, prefix="fused2d_"):
    """torch.profiler's trace of one replay of a CUDA graph of ``calls``
    calls of fn() (device_ms's graph, after warm-up calls): per call, each
    kernel's time by name (what follows ``prefix``), the idle time between
    each pair of consecutive kernels by their names (the mean gap, and its
    count in the replay), and the replay's span from the first kernel's
    start to the last one's end. None when the trace holds no such kernel
    (the profiler may not see a graph's kernels)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"].split(prefix, 1)[1].split("<")[0].split("(")[0])
                     for e in events if e.get("cat") == "kernel" and prefix in e.get("name", ""))
    if not kernels:
        return None
    busy, gaps = {}, {}
    for start, end, name in kernels:
        busy[name] = busy.get(name, 0.0) + (end - start) / 1e3 / calls
    for (_, end, a), (start, _, b) in zip(kernels, kernels[1:]):
        gap = gaps.setdefault(f"{a} -> {b}", [0.0, 0])
        gap[0] += (start - end) / 1e3
        gap[1] += 1
    return {"kernels": len(kernels), "phase_ms": busy,
            "gap_ms": {k: {"mean": t / n, "count": n} for k, (t, n) in gaps.items()},
            "gap_ms_per_call": sum(t for t, _ in gaps.values()) / calls,
            "span_ms_per_call": (kernels[-1][1] - kernels[0][0]) / 1e3 / calls}


def time_rows(root, variant, smoke, torch, fused2d, rows, held=True):
    """One JSON line per row and (kernel, mode) of ``rows``, inputs from a
    generator seeded with 0; ``held``: each bf16 row held to its plain
    version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, cin, cout, h, w, k in ROWS:
        x = torch.randn(b, cin, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, k, k, device=dev, generator=gen) / (cin * k * k) ** 0.5
        plan = fused2d.tile_plan_2d(k, k, cin, cout)
        spectra = fused2d.kernel_spectra_2d(wt, plan[0], plan[2], plan[3])
        planes = fused2d._planes(spectra)
        for name, mode in rows:
            v3 = name == "B5"
            plain = (fused2d._fused2d_forward_reference_v3 if v3
                     else fused2d._fused2d_forward_reference)
            if v3 and mode == "highest":
                def kernel():
                    return fused2d._launch_fused2d_v3(x, planes, plan, 1, (k, k))
            else:
                def kernel(mode=mode, v3=v3):
                    return fused2d._launch_fused2d(x, spectra, plan, 1, (k, k), mode, v3=v3)
            row = {"root": root, "variant": variant, "kernel": name, "mode": mode, "K": k,
                   "plan": list(plan)}
            if held and mode in ("bf16x3", "bf16"):
                y, y_ref = kernel(), plain(x, wt, mode=mode)
                try:
                    if mode == "bf16x3":
                        mx, mean, sigma = smoke.close_scaled(y, y_ref, "vs plain")
                        ratio = None
                    else:
                        exact = plain(x.double(), wt.double())
                        mx, mean, sigma, ratio = smoke.close_bf16_2d(y, y_ref, exact, "vs plain")
                    row.update(held=True, max_abs_err=mx, mean_abs_err=mean, sigma=sigma,
                               err_ratio_vs_float64=ratio)
                except RuntimeError as e:
                    row.update(held=False, error=str(e))
            row.update(ms=smoke.device_ms(kernel),
                       phase_ms=smoke.phase_split_ms(torch, kernel, "fused2d_"),
                       graph=graph_trace(torch, kernel, smoke.GRAPH_REPS))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
