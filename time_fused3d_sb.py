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
                               [--mode MODE ...] [--b6-b7] [--knockout NAME ...]

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

Each ``--mode`` ("highest", "bf16x3" or "bf16") times B3's and B4's chains
under that precision mode (``set_fused3d_precision``; the tensor-core
chains under "bf16x3" and "bf16") at the 64^3 and 48^3 rows and the
stuffed 78^3 and 82^3 volumes (``--main-rows``: 64^3 only), in place of the
rows above: ``ms``, the eager ``phase_ms``, and ``graph`` (``graph_trace``
of time_fused2d_tc.py: each kernel's time inside one replay of the timed
CUDA graph, the idle time between consecutive kernels, which ``ms`` holds
and ``phase_ms`` does not, and the replay's span), each bf16 row held to
its plain version of the mode ("held"). ``--b6-b7`` also times kernel B6
(``fused3d_pack``) at the 64^3 and stuffed 78^3 signals and kernel B7
(``fused3d_spectra_v4``) at the working lengths 64, 48 and 78. Each
``--knockout NAME`` (``KNOCKOUTS``) times the tensor-core chains under the
first ``--mode`` (default "bf16x3") with one part of their kernels taken
out, built the same way: its results are then wrong and not checked, and
what a stage loses is what that part costs (with a stage's stores gone the
compiler may drop what fed them too). A knockout names the text it
replaces in each version of the kernels it knows, so that a ``--root`` of
the parent runs its own.
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
# the rows --mode times: those the tensor-core chains take (H <= 256)
MODE_ROWS = [r for r in ROWS if r[5] <= 256]

# --knockout NAME: (kernel, [(text, replacement), ...]) in csrc/fused3d.cu,
# each taking one part of the tensor-core chains out; the first pair whose
# text the kernel holds is used (one pair for each version of the kernels)
SKIP = "if (gridDim.x == 0) "
KNOCKOUTS = {
    # hw_forward_tc: the slab pair's copy into shared memory, each H and W
    # step, the split of bins k and Hw - k, the stores to T
    "fwd_copy": ("fused3d_hw_forward_tc", [
        ("copy_pairs<PK>(re, x,", SKIP + "copy_pairs<PK>(re, x,"),
        ("load_pair<PK, H_>(", SKIP + "load_pair<PK, H_>("),
    ]),
    "fwd_h1": ("fused3d_hw_forward_tc", [
        ("tc_step<X3>(\n      ha, tab.ra, hb * kTW, tab.a,",
         SKIP + "tc_step<X3>(\n      ha, tab.ra, hb * kTW, tab.a,"),
        ("tc_step<RA, X3>(HA, tab.ra, HB * kTW, tab.a,",
         SKIP + "tc_step<RA, X3>(HA, tab.ra, HB * kTW, tab.a,"),
    ]),
    "fwd_h2": ("fused3d_hw_forward_tc", [
        ("if (hb > 1) {\n    tc_step<X3>(", "if (hb > 1 && gridDim.x == 0) {\n    tc_step<X3>("),
        ("tc_step<RB, X3>(HB, tab.rb, HA * kTW, tab.b,",
         SKIP + "tc_step<RB, X3>(HB, tab.rb, HA * kTW, tab.b,"),
    ]),
    "fwd_split": ("fused3d_hw_forward_tc", [
        ("for (int i = threadIdx.x; i < NBH * kTW; i += kHwThreads) {",
         SKIP + "for (int i = threadIdx.x; i < NBH * kTW; i += kHwThreads) {"),
        ("return split_of((m >> 3) & 1, cell(ra, col), cell(rb, col));", "return cell(ra, col);"),
    ]),
    "fwd_w1": ("fused3d_hw_forward_tc", [
        ("bf16_mma::dft_step<8, X3, kHwThreads / 32>(\n      ns * NBH * kWB, tab.w,",
         SKIP + "bf16_mma::dft_step<8, X3, kHwThreads / 32>(\n      ns * NBH * kWB, tab.w,"),
        ("bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(NBH * 16, tab.w,",
         SKIP + "bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(NBH * 16, tab.w,"),
    ]),
    "fwd_w2": ("fused3d_hw_forward_tc", [
        ("tout[(int64_t)(m / kWA) * kTW + m % kWA + kWA * m2] = v;",
         "if (v.x == 1234.5f) tout[(int64_t)(m / kWA) * kTW + m % kWA + kWA * m2] = v;"),
        ("if (q.s < ns) tout[", "if (q.s < ns && v.x == 1234.5f) tout["),
    ]),
    # d_mac_tc: the T loads, the spectra's staging, the forward DFT-16's
    # products, the MAC, the inverse DFT-16's products, the stores to Z
    "d_t_loads": ("fused3d_d_mac_tc", [
        ("sl < d ? __ldg(tp + sl * npos + g + 8 * u) : make_float2(0.f, 0.f)",
         "make_float2(sl, u)"),
        ("const float2 v = tb[", "const float2 v = make_float2(s, e); (void)tb["),
    ]),
    "d_spectra": ("fused3d_d_mac_tc", [
        ("if (nchunk == 1) {\n    stage(0);",
         "if (nchunk == 1 && gridDim.x == 0) {\n    stage(0);"),
        ("const auto stage_kc = [&](int c) {\n    for (",
         "const auto stage_kc = [&](int c) {\n    if (gridDim.x == 0) for ("),
    ]),
    "d_forward": ("fused3d_d_mac_tc", [
        ("            const uint2 bh = bf16_mma::b_frag<kDB>(dfrag, s, nt, lane);\n"
         "            if (X3) {\n"
         "              bf16_mma::mma(acl, al[s], bh);\n"
         "              bf16_mma::mma(acl, ah[s], bf16_mma::b_frag<kDB>(fl, s, nt, lane));\n"
         "            }\n"
         "            bf16_mma::mma(acc, ah[s], bh);\n",
         "            acc[s] += __uint_as_float(ah[s][nt]) + __uint_as_float(al[s][nt]);\n"),
        ("d16_product<X3>(acc, ah, al, dfrag, nt, lane);",
         "acc[0] += __uint_as_float(ah[0][nt]) + __uint_as_float(al[1][nt]);"),
    ]),
    "d_mac": ("fused3d_d_mac_tc", [
        ("            cmac(y[o][nt][0], make_float2(acc[0], acc[1]), kr[0]);\n"
         "            cmac(y[o][nt][1], make_float2(acc[2], acc[3]), kr[8]);\n",
         "            y[o][nt][0].x += acc[0];\n            y[o][nt][1].x += acc[2];\n"),
        ("cmac(y[o][nt][0], make_float2(acc[0], acc[1]), kr[ca]);\n"
         "          cmac(y[o][nt][1], make_float2(acc[2], acc[3]), kr[cb]);",
         "y[o][nt][0].x += acc[0];\n          y[o][nt][1].x += acc[2];"),
    ]),
    "d_inverse": ("fused3d_d_mac_tc", [
        ("          const uint2 bh = bf16_mma::b_frag<kDB>(ih, s, nt, lane);\n"
         "          if (X3) {\n"
         "            bf16_mma::mma(acl, al[s], bh);\n"
         "            bf16_mma::mma(acl, ah[s], bf16_mma::b_frag<kDB>(il, s, nt, lane));\n"
         "          }\n"
         "          bf16_mma::mma(acc, ah[s], bh);\n",
         "          acc[s] += __uint_as_float(ah[s][nt]) + __uint_as_float(al[s][nt]);\n"),
        ("d16_product<X3>(acc, ah, al, ih, nt, lane);",
         "acc[0] += __uint_as_float(ah[0][nt]) + __uint_as_float(al[1][nt]);"),
    ]),
    "d_z_stores": ("fused3d_d_mac_tc", [
        ("if (dd < od) {\n          float2* zp",
         "if (dd < od && acc[0] == 1234.5f) {\n          float2* zp"),
    ]),
    # hw_inverse_tc: Z's copy into shared memory, each W and H step, the
    # Hermitian extension, the output stores
    "inv_copy": ("fused3d_hw_inverse_tc", [
        ("for (int i = tid; i < 2 * NPOS; i += kHwThreads) {",
         SKIP + "for (int i = tid; i < 2 * NPOS; i += kHwThreads) {"),
        ("for (int i = threadIdx.x; i < 2 * NBH * 32; i += kHwThreads) {",
         SKIP + "for (int i = threadIdx.x; i < 2 * NBH * 32; i += kHwThreads) {"),
    ]),
    "inv_w1": ("fused3d_hw_inverse_tc", [
        ("bf16_mma::dft_step<8, X3, kHwThreads / 32>(\n      ns * NBH * kWB, winv,",
         SKIP + "bf16_mma::dft_step<8, X3, kHwThreads / 32>(\n      ns * NBH * kWB, winv,"),
        ("bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(nrows * kWB, winv,",
         SKIP + "bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(nrows * kWB, winv,"),
    ]),
    "inv_w2": ("fused3d_hw_inverse_tc", [
        ("bf16_mma::dft_step<8, X3, kHwThreads / 32>(\n      ns * NBH * kWA, winv,",
         SKIP + "bf16_mma::dft_step<8, X3, kHwThreads / 32>(\n      ns * NBH * kWA, winv,"),
        ("bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(nrows * kWA, winv,",
         SKIP + "bf16_mma::dft_step<8, X3, kHwThreads / 32, true>(nrows * kWA, winv,"),
    ]),
    "inv_extension": ("fused3d_hw_inverse_tc", [
        ("for (int i = tid; i < NPOS; i += kHwThreads) {",
         SKIP + "for (int i = tid; i < NPOS; i += kHwThreads) {"),
        ("return hermitian_v(j, cell.at(j, j1 + j2, col), cell.at(partner(j), pd, col), H);",
         "return cell.at(j, j1 + j2, col);"),
    ]),
    "inv_h1": ("fused3d_hw_inverse_tc", [
        ("tc_step<X3>(\n      ha, tab.ra, hb * kTW, ainv,",
         SKIP + "tc_step<X3>(\n      ha, tab.ra, hb * kTW, ainv,"),
        ("tc_step<RA, X3>(HA, tab.ra, HB * kTW, ainv,",
         SKIP + "tc_step<RA, X3>(HA, tab.ra, HB * kTW, ainv,"),
    ]),
    "inv_out_stores": ("fused3d_hw_inverse_tc", [
        ("if (hh < oh && col >= g.lo && col < g.hi) {",
         "if (hh < oh && col >= g.lo && col < g.hi && v.x == 1234.5f) {"),
    ]),
}


def variant_constants(spec):
    """[(name, value)] of a --variant SPEC."""
    if "=" not in spec:
        return list(zip(("kSBF", "kHwThreads", "kHwBlocks"), (int(v) for v in spec.split(","))))
    return [(name.strip(), int(value)) for name, value in
            (part.split("=") for part in spec.split(","))]


def built_library(src, tag):
    """fused3d.cu's text ``src`` built under build/ with the package's nvcc
    flags (the tree's headers beside it) and loaded, and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"fused3d_{tag}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                          str(so), str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so)), log.stdout + log.stderr


def variant_library(constants):
    """fused3d.cu of the timed tree built with these (name, value)
    constants."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused3d.cu").read_text()
    for name, value in constants:
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            sys.exit(f"time_fused3d_sb.py: no {name} in csrc/fused3d.cu of this tree")
    return built_library(src, "_".join(f"{n}{v}" for n, v in constants))


def knockout_library(name):
    """fused3d.cu of the timed tree built without the part KNOCKOUTS[name]
    names, and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused3d.cu").read_text()
    kernel, pairs = KNOCKOUTS[name]
    start = src.index(f"\n{kernel}(")
    end = src.index("\n}\n", start)
    body = src[start:end]
    for text, replacement in pairs:
        if text in body:
            body = body.replace(text, replacement, 1)
            break
    else:
        sys.exit(f"time_fused3d_sb.py: knockout {name}: no text of it in {kernel} of this tree")
    return built_library(src[:start] + body + src[end:], f"knockout_{name}")


def module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variant", action="append", default=[], metavar="SPEC")
    parser.add_argument("--main-rows", action="store_true")
    parser.add_argument("--mode", action="append", default=[],
                        choices=("highest", "bf16x3", "bf16"))
    parser.add_argument("--b6-b7", action="store_true")
    parser.add_argument("--knockout", action="append", default=[], choices=sorted(KNOCKOUTS))
    args = parser.parse_args()
    main_rows = lambda rows: [r for r in rows if r[4:6] == (64, 64)] if args.main_rows else rows
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = module(os.path.join(HERE, "chip_smoke.py"), "smoke")
    tc2d = module(os.path.join(HERE, "time_fused2d_tc.py"), "time_fused2d_tc")

    import torch

    from fft_conv_tpu_torch.kernels import _build, fused3d

    if not torch.cuda.is_available():
        sys.exit("time_fused3d_sb.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    load = _build.load
    if args.mode:
        for mode in args.mode:
            time_mode_rows(root, "default", smoke, tc2d, torch, fused3d,
                           main_rows(MODE_ROWS), mode)
    elif not args.knockout and not args.b6_b7:
        time_rows(root, "default", smoke, torch, fused3d, main_rows(ROWS))
    if args.b6_b7:
        time_b6_b7(root, smoke, torch, fused3d)
    for variant in args.variant:
        lib, log = variant_library(variant_constants(variant))
        print(json.dumps({"variant": variant,
                          "registers": {k: v for k, v in smoke.ptxas_registers(log).items()
                                        if "_mac" in k or "_hw_" in k},
                          "spill_bytes": {k: v for k, v in smoke.ptxas_spills(log).items()
                                          if "_mac" in k or "_hw_" in k}}), flush=True)
        _build.load = lambda name, lib=lib: lib if name == "fused3d" else load(name)
        try:
            if args.mode:
                for mode in args.mode:
                    time_mode_rows(root, variant, smoke, tc2d, torch, fused3d,
                                   main_rows(MODE_ROWS), mode)
            else:
                time_rows(root, variant, smoke, torch, fused3d, main_rows(ROWS))
        finally:
            _build.load = load
    with concurrent.futures.ThreadPoolExecutor() as pool:  # one nvcc a knockout, all at once
        libs = list(pool.map(knockout_library, args.knockout))
    mode = next((m for m in args.mode if m != "highest"), "bf16x3")
    for name, (lib, _) in zip(args.knockout, libs):
        _build.load = lambda name, lib=lib: lib if name == "fused3d" else load(name)
        try:
            time_mode_rows(root, f"knockout {name}", smoke, tc2d, torch, fused3d,
                           [r for r in MODE_ROWS if r[4:6] == (64, 64)], mode, held=False)
        finally:
            _build.load = load


def inputs(torch, fused3d, gen, row):
    """(x, weights, Hw, spectra, launch, reference) of one row."""
    chain, b, cin, cout, d, h, w, k = row
    dev = torch.device("cuda")
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
    return x, wt, hw, spectra, launch, reference


def time_rows(root, variant, smoke, torch, fused3d, rows):
    """One JSON line per row of ``rows``, inputs from a generator seeded
    with 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row in rows:
        chain, b, cin, cout, d, h, w, k = row
        x, wt, hw, spectra, launch, reference = inputs(torch, fused3d, gen, row)
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


def time_mode_rows(root, variant, smoke, tc2d, torch, fused3d, rows, mode, held=True):
    """One JSON line per row of ``rows`` under ``mode``: ``ms``, the eager
    ``phase_ms`` and the kernels inside one graph replay; ``held``: each
    bf16 row held to its plain version of the mode."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for row in rows:
        chain, b, cin, cout, d, h, w, k = row
        x, wt, hw, spectra, launch, reference = inputs(torch, fused3d, gen, row)

        def kernel():
            return launch(x, spectra, 1, (k, k, k), mode=mode)

        out = {"root": root, "variant": variant, "chain": chain, "mode": mode,
               "shape": [b, cin, cout, d, h, w, k], "hw": hw,
               "split": list(fused3d._h_steps(h))}
        if held and mode != "highest":
            y, y_ref = kernel(), reference(x, wt, mode=mode)
            try:
                if mode == "bf16x3":
                    mx, mean, sigma = smoke.close_scaled(y, y_ref, "vs plain")
                    ratio = None
                else:
                    exact = reference(x.double(), wt.double())
                    mx, mean, sigma, ratio = smoke.close_bf16_2d(y, y_ref, exact, "vs plain")
                out.update(held=True, max_abs_err=mx, mean_abs_err=mean, sigma=sigma,
                           err_ratio_vs_float64=ratio)
            except RuntimeError as e:
                out.update(held=False, error=str(e))
        out.update(ms=smoke.device_ms(kernel),
                   phase_ms=smoke.phase_split_ms(torch, kernel, "fused3d_"),
                   graph=tc2d.graph_trace(torch, kernel, smoke.GRAPH_REPS, "fused3d_"))
        print(json.dumps(out), flush=True)


def time_b6_b7(root, smoke, torch, fused3d):
    """Kernel B6 at the 64^3 signal and the stuffed 78^3 one (two W blocks)
    at their plans' pair counts, and kernel B7 at the 8^3 taps and the
    working lengths 64, 48 and 78: one JSON line each."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (64, 78):
        x = torch.randn(2, 8, d, d, d, device="cuda", generator=gen)
        plan, nwb, hop = fused3d._plan_for(x.shape, (8, 8, 8, 8, 8), 1, "v4")
        print(json.dumps({"root": root, "kernel": "B6", "dhw": [d, d, d], "pp": plan[3],
                          "nwb": nwb, "ms": smoke.device_ms(
                              lambda: fused3d._launch_pack3d(x, plan[3], nwb, hop))}), flush=True)
    taps = torch.randn(8, 8, 8, 8, 8, device="cuda", generator=gen)
    for hw in (64, 48, 78):
        print(json.dumps({"root": root, "kernel": "B7", "hw": hw, "ms": smoke.device_ms(
            lambda: fused3d._launch_spectra_v4(taps, hw))}), flush=True)


if __name__ == "__main__":
    main()
