#!/usr/bin/env python3
"""Times kernel B1 (csrc/fused1d.cu) under its three precision modes on one
NVIDIA GPU at the 1D benchmark rows (B=2, 8 -> 8 channels, L = 32768, K in
{256, 1024, 3840}), with the device time of each of its kernels, and holds
each tensor-core result to its plain version.

    python3 time_fused1d_tc.py [--root DIR] [--mode MODE ...] [--upb N ...]
                               [--variant NAME=VALUE[,...] ...] [--knockout NAME ...]

``--root`` is the checkout whose ``fft_conv_tpu_torch`` is timed (default:
the directory of this script), so that two trees can be compared in one
run on one card, for example a ``git archive`` of the parent commit
unpacked under ``build/``: run parent, change, change, parent. ``--mode``
(repeatable; default all three) picks the modes timed. The timing helpers
(``device_ms``, a CUDA graph of 20 calls replayed 30 times, and
``phase_split_ms``, torch.profiler's device time per kernel) are those of
this script's own ``chip_smoke.py``, and ``graph`` (each kernel's time
inside one replay of that CUDA graph, and the idle time between
consecutive kernels) is ``time_fused2d_tc.graph_trace``. Inputs come from
a torch.Generator seeded with 0. Each row prints its mode, ``ms``,
``phase_ms``, ``graph`` and, under "bf16x3" and "bf16", its errors against
the plain version of the mode (``chip_smoke.close_scaled`` and
``close_bf16``; "held": whether they pass). Prints one JSON line per row.

Each ``--upb N`` times the tensor-core rows again with the MAC stage's
units a block set to N in place of ``fused1d._tc_geometry``'s choice (the
three-kernel route only). Each ``--variant NAME=VALUE,...`` times them
again with fused1d.cu rebuilt under ``build/`` with those ``constexpr int``
values (for example ``kMacKC=8``), each row held to its plain version.
Each ``--knockout NAME`` (``KNOCKOUTS``) times the tensor-core kernels
under the bf16 modes of ``--mode`` with one part of them taken out, built
with the package's nvcc flags under ``build/`` and loaded in place of the
package's library: its results are then wrong and not checked, and what a
kernel loses is what that part costs (with a part's stores gone the
compiler may drop what fed them too). A knockout names the text it
replaces in each version of the kernels it knows (the two-kernel pair and
the three-kernel route), so that a ``--root`` of either runs its own.
"""

import argparse
import concurrent.futures
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SKIP = "if (gridDim.x == 0) "
# --knockout NAME: [(kernel, text, replacement), ...] in csrc/fused1d.cu, each
# taking one part of the tensor-core kernels out; the first entry whose
# kernel the tree holds, with the text in its body, is used (one entry for
# each version of the kernels)
KNOCKOUTS = {
    # the window's loads from the signal
    "window": [
        ("fused1d_spectra_tc", "make_float2(p < l_pad ? __ldg(xs + p) : 0.f,\n"
         "                              p + kPairs < l_pad ? __ldg(xs + p + kPairs) : 0.f)",
         "make_float2((float)j, (float)c)"),
        ("fused1d_spectra_tc", "tc_mac::cp_async4(", SKIP + "tc_mac::cp_async4("),
    ],
    # the N1-point DFT of the column pairs
    "col_dft": [
        ("fused1d_spectra_tc", "col_dft_tc<N1, MODE, NT, false>(",
         SKIP + "col_dft_tc<N1, MODE, NT, false>("),
        ("fused1d_spectra_tc", "col_dft_tc<N1, X3, false>(", SKIP + "col_dft_tc<N1, X3, false>("),
    ],
    # the split of bins k and -k into the two columns' spectra, and the twiddle
    "split": [
        ("fused1d_spectra_tc", "i < H * kPairs; i += NT", "i < 0; i += NT"),
        ("fused1d_spectra_tc", "i < H * kPairs; i += kTcThreads", "i < 0; i += kTcThreads"),
    ],
    # the 128-point DFT of the one-sided rows, and D's stores
    "row_dft": [
        ("fused1d_spectra_tc", "row_dft_tc<N1, MODE, NT, false>(",
         SKIP + "row_dft_tc<N1, MODE, NT, false>("),
        ("fused1d_spectra_tc", "rows_tc<X3, false>(", SKIP + "rows_tc<X3, false>("),
    ],
    # D's stores from the row DFT's products, the products kept (the route only)
    "d_stores": [
        ("fused1d_spectra_tc", "dout[k1 * kN2 + bin] = v;",
         "if (v.x == 1234.5f) dout[k1 * kN2 + bin] = v;"),
    ],
    # the FP32 MAC over the group's input channels
    "mac": [
        ("fused1d_mac_inverse_tc", "ci < cpg; ++ci", "ci < 0; ++ci"),
        ("fused1d_mac_tc", "tc_mac::mac_rows<", SKIP + "tc_mac::mac_rows<"),
    ],
    # the conjugated 128-point DFT of the MAC's rows
    "inverse_row_dft": [
        ("fused1d_mac_inverse_tc", "row_dft_tc<N1, MODE, NT, true>(",
         SKIP + "row_dft_tc<N1, MODE, NT, true>("),
        ("fused1d_mac_tc", "rows_tc<X3, true>(", SKIP + "rows_tc<X3, true>("),
    ],
    # Y's stores from the inverse row DFT's products, the products kept (the
    # route only)
    "y_stores": [
        ("fused1d_mac_tc", "y[yrow[r] + bin] = v;", "if (v.x == 1234.5f) y[yrow[r] + bin] = v;"),
    ],
    # the conjugate twiddle and the Hermitian extension of the column pairs
    "hermitian": [
        ("fused1d_mac_inverse_tc", "i < N1 * kPairs; i += NT", "i < 0; i += NT"),
        ("fused1d_inverse_tc", "i < N1 * kPairs; i += kTcThreads", "i < 0; i += kTcThreads"),
    ],
    # the N1-point c2r of the column pairs and the output's stores
    "c2r": [
        ("fused1d_mac_inverse_tc", "col_dft_tc<N1, MODE, NT, true>(",
         SKIP + "col_dft_tc<N1, MODE, NT, true>("),
        ("fused1d_inverse_tc", "col_dft_tc<N1, X3, true>(", SKIP + "col_dft_tc<N1, X3, true>("),
    ],
}


def module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def knockout_library(tc2d, name):
    """fused1d.cu of the timed tree built without the part KNOCKOUTS[name]
    names (time_fused2d_tc.built_library's build), and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused1d.cu").read_text()
    for kernel, text, replacement in KNOCKOUTS[name]:
        if f"\n{kernel}(" not in src:
            continue
        start = src.index(f"\n{kernel}(")
        end = src.index("\n}\n", start)
        if text in src[start:end]:
            body = src[start:end].replace(text, replacement, 1)
            return tc2d.built_library(src[:start] + body + src[end:], f"knockout1d_{name}",
                                      "fused1d")
    sys.exit(f"time_fused1d_tc.py: knockout {name}: no text of it in csrc/fused1d.cu "
             f"of this tree")


def variant_library(tc2d, constants):
    """fused1d.cu of the timed tree built with these (name, value)
    constants (time_fused2d_tc.built_library's build), and nvcc's output."""
    from fft_conv_tpu_torch.kernels import _build

    src = (_build.CSRC / "fused1d.cu").read_text()
    for name, value in constants:
        src, n = re.subn(rf"\b{name} = \d+;", f"{name} = {value};", src)
        if n != 1:
            sys.exit(f"time_fused1d_tc.py: no {name} in csrc/fused1d.cu of this tree")
    return tc2d.built_library(src, "_".join(f"{n}{v}" for n, v in constants), "fused1d")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--mode", action="append", default=[],
                        choices=("highest", "bf16x3", "bf16"))
    parser.add_argument("--upb", action="append", default=[], type=int)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=VALUE[,...]")
    parser.add_argument("--knockout", action="append", default=[], choices=sorted(KNOCKOUTS))
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = module(os.path.join(HERE, "chip_smoke.py"), "smoke")
    tc2d = module(os.path.join(HERE, "time_fused2d_tc.py"), "time_fused2d_tc")

    import torch

    from fft_conv_tpu_torch.kernels import _build, fused1d

    if not torch.cuda.is_available():
        sys.exit("time_fused1d_tc.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    modes = args.mode or list(fused1d.PRECISION_MODES)
    inputs = make_inputs(torch, smoke, fused1d)
    time_rows(root, "default", smoke, tc2d, torch, fused1d, inputs, modes)
    tc_modes = [m for m in modes if m != "highest"]
    geometry = getattr(fused1d, "_tc_geometry", None)
    for upb in args.upb:
        if geometry is None:
            sys.exit("time_fused1d_tc.py: --upb needs the three-kernel route")
        fused1d._tc_geometry = lambda *a, upb=upb: (geometry(*a)[0], upb, geometry(*a)[2])
        try:
            time_rows(root, f"upb={upb}", smoke, tc2d, torch, fused1d, inputs, tc_modes)
        finally:
            fused1d._tc_geometry = geometry
    variants = [[(n.strip(), int(v)) for n, v in (p.split("=") for p in spec.split(","))]
                for spec in args.variant]
    with concurrent.futures.ThreadPoolExecutor() as pool:  # one nvcc a library, all at once
        built = list(pool.map(lambda c: variant_library(tc2d, c), variants))
        libs = list(pool.map(lambda name: knockout_library(tc2d, name), args.knockout))
    load = _build.load
    for spec, (lib, _) in zip(args.variant, built):
        _build.load = lambda lib_name, lib=lib: lib if lib_name == "fused1d" else load(lib_name)
        try:
            time_rows(root, spec, smoke, tc2d, torch, fused1d, inputs, tc_modes)
        finally:
            _build.load = load
    for name, (lib, _) in zip(args.knockout, libs):
        _build.load = lambda lib_name, lib=lib: lib if lib_name == "fused1d" else load(lib_name)
        try:
            time_rows(root, f"knockout {name}", smoke, tc2d, torch, fused1d, inputs, tc_modes,
                      held=False)
        finally:
            _build.load = load


def make_inputs(torch, smoke, fused1d):
    """(K, N, x, w, spectra) at each row of chip_smoke.BENCH_SHAPES, from a
    generator seeded with 0."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for b, cin, cout, l, k in smoke.BENCH_SHAPES:
        x = torch.randn(b, cin, l, device=dev, generator=gen)
        w = torch.randn(cout, cin, k, device=dev, generator=gen) / (cin * k) ** 0.5
        n = fused1d.choose_fft_size(k, l, cin, cout, batch=b)
        out.append((k, n, x, w, fused1d.kernel_spectra_one_sided(w, n)))
    return out


def time_rows(root, variant, smoke, tc2d, torch, fused1d, inputs, modes, held=True):
    """One JSON line per row and mode of ``modes``; ``held``: each bf16 row
    held to its plain version."""
    for k, n, x, w, spectra in inputs:
        for mode in modes:
            def kernel(mode=mode):
                return fused1d._launch_fused1d(x, spectra, n, 1, k, mode)

            row = {"root": root, "variant": variant, "mode": mode, "K": k, "N": n}
            if held and mode != "highest":
                y, y_ref = kernel(), fused1d._fused_forward_reference(x, w, n, mode=mode)
                close = smoke.close_scaled if mode == "bf16x3" else smoke.close_bf16
                try:
                    mx, mean, sigma = close(y, y_ref, "vs plain")
                    row.update(held=True, max_abs_err=mx, mean_abs_err=mean, sigma=sigma)
                except RuntimeError as e:
                    row.update(held=False, error=str(e))
            row.update(ms=smoke.device_ms(kernel),
                       phase_ms=smoke.phase_split_ms(torch, kernel, "fused1d_"),
                       graph=tc2d.graph_trace(torch, kernel, smoke.GRAPH_REPS, "fused1d_"))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
