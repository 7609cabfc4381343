#!/usr/bin/env python3
"""Smoke test of fft_conv_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card, drives the main path
(``fft_conv(..., impl="auto")`` and ``nn.FFTConv1d`` forward and backward)
at the library's three 1D benchmark shapes (B=2, 8 -> 8 channels,
L=32768, K in {256, 1024, 3840}, float32, inputs from a torch.Generator
seeded with 0), shows through the launch counters that the main path ran
the kernels, and times each kernel beside its plain version, the composed
path, one library call and the least time the card could take.

Every phase prints one line; any failed check raises and the script exits
non-zero without a result. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX: the port stands alone.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (B, Cin, Cout, L, K): the 1D rows of the repo's benchmark (bench.py)
BENCH_SHAPES = [(2, 8, 8, 32768, 256), (2, 8, 8, 32768, 1024), (2, 8, 8, 32768, 3840)]
# NVIDIA's data sheet for the H100 SXM: HBM rate and FP32 rate outside the
# tensor cores (the kernel uses FP32 FMAs only)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
WARMUP, ITERS, GRAPH_REPS = 5, 30, 20


def check(ok, message):
    """Raises when a check fails (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(message)


def close_scaled(y, y_ref, what):
    """The bar of tests/helpers.py:_assert_close_scaled: err_mean < 2e-5 *
    sigma and err_max < 1.2e-4 * sigma, sigma = max(1, std(ref)).
    Returns (max abs err, mean abs err, sigma)."""
    y, y_ref = y.detach(), y_ref.detach()
    check(y.shape == y_ref.shape, f"{what}: shape {tuple(y.shape)} vs {tuple(y_ref.shape)}")
    check(bool(y.isfinite().all()), f"{what}: non-finite values")
    err = (y.double() - y_ref.double()).abs()
    sigma = max(1.0, float(y_ref.double().std()))
    mean, mx = float(err.mean()), float(err.max())
    check(mean < 2e-5 * sigma, f"{what}: err_mean {mean:.3e} >= 2e-5 * {sigma:.3f}")
    check(mx < 1.2e-4 * sigma, f"{what}: err_max {mx:.3e} >= 1.2e-4 * {sigma:.3f}")
    return mx, mean, sigma


def _event_ms(run, per=1):
    """Median over ITERS of the CUDA-event time of run(), divided by per."""
    import torch

    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def call_ms(fn):
    """Latency of one call as a caller sees it, host work included: events
    around each call after WARMUP calls. At these sizes the host enqueues
    slower than the card computes, so this is mostly host time."""
    for _ in range(WARMUP):
        fn()
    return _event_ms(fn)


def device_ms(fn):
    """Device time of one call: GRAPH_REPS calls captured in a CUDA graph
    (after WARMUP eager calls, which build caches and plans), the graph
    replayed ITERS times, the median divided by GRAPH_REPS. The replay
    carries no host work, so this is the card's own time."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_REPS):
            fn()
    return _event_ms(graph.replay, GRAPH_REPS)


def fused1d_work(b, cin, cout, l, k, n, groups=1):
    """(bytes, flops) the fused 1D kernel must move and does for one call.

    Bytes: the signal and the one-sided spectra read once, the output
    written once. Flops, counted from csrc/fused1d.cu with an FMA as two
    and only the N1/2+1 rows that the one-sided pipeline needs: per block
    and input channel, stage 1 (real x complex, 4 per term), twiddle (6),
    stage 2 (complex, 8); per block and output channel, the MAC over the
    group's channels (8), inverse stage 1 (8), conjugate twiddle (6) and
    inverse stage 2 on the V1 valid rows (real part, 4)."""
    n1, n2 = n // 128, 128
    h = n1 // 2 + 1
    v1 = (n - k + 1) // n2
    l_out = l - k + 1
    nblk = -(-l_out // (v1 * n2))
    cpg = cin // groups
    fwd = h * n1 * n2 * 4 + h * n2 * 6 + h * n2 * n2 * 8
    inv = h * n2 * cpg * 8 + h * n2 * n2 * 8 + h * n2 * 6 + v1 * n2 * h * 4
    flops = nblk * b * (cin * fwd + cout * inv)
    nbytes = 4 * b * cin * l + 8 * cout * h * cpg * n2 + 4 * b * cout * l_out
    return nbytes, flops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "fft_conv_tpu_torch")):
        print("chip_smoke: fft_conv_tpu_torch/ is not beside this script; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import torch.nn.functional as TF

    from fft_conv_tpu_torch import FFTConv1d, fft_conv
    from fft_conv_tpu_torch.kernels import _build, fused1d

    check("jax" not in sys.modules and "fft_conv_tpu" not in sys.modules,
          "the port pulled in JAX or the JAX package")

    # phase 1: the card and the float32 settings
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # phase 2: build every kernel from the sources in this checkout
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _build.build_logs.items()
    }
    print(json.dumps({"phase": "build", "seconds": round(build_s, 2),
                      "libraries": {k: str(v.relative_to(HERE)) for k, v in paths.items()},
                      "ptxas": ptxas}))
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(0)
    inputs = []
    for b, cin, cout, l, k in BENCH_SHAPES:
        x = torch.randn(b, cin, l, generator=gen).to(dev)
        w = (torch.randn(cout, cin, k, generator=gen) / (cin * k) ** 0.5).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        n = fused1d.choose_fft_size(k, l, cin, cout, batch=b)
        check(n is not None, f"no fused plan at K={k}")
        inputs.append((x, w, bias, n))

    # phase 3a: the kernel against its plain version, at the main path's
    # shapes, then with groups and with the blocks split over several launches
    print("tolerance: err_mean < 2e-5*sigma and err_max < 1.2e-4*sigma, "
          "sigma = max(1, std(ref)) (tests/helpers.py:_assert_close_scaled)")
    errs = []
    for (b, cin, cout, l, k), (x, w, bias, n) in zip(BENCH_SHAPES, inputs):
        spectra = fused1d.kernel_spectra_one_sided(w, n)
        y = fused1d._launch_fused1d(x, spectra, n, 1, k)
        torch.cuda.synchronize()
        y_ref = fused1d._fused_forward_reference(x, w, n)
        mx, mean, sigma = close_scaled(y, y_ref, f"B1 vs plain K={k}")
        errs.append(mx)
        print(json.dumps({"phase": "kernel_vs_plain", "K": k, "N": n, "max_abs_err": mx,
                          "mean_abs_err": mean, "sigma": sigma}))
    x, w, _, n = inputs[1]
    wg = w[:, :4].contiguous()  # groups=2: (Cout, Cin/2, K)
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(wg, n), n, 2, wg.shape[-1])
    mx, _, _ = close_scaled(y, fused1d._fused_forward_reference(x, wg, n, 2), "B1 groups=2")
    print(json.dumps({"phase": "kernel_vs_plain", "case": "groups=2", "max_abs_err": mx}))
    budget = fused1d._SCRATCH_BUDGET
    try:
        fused1d._SCRATCH_BUDGET = 3 * fused1d._scratch_bytes_per_block(n, 2, 8)
        before = fused1d.launches
        y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, n), n, 1, w.shape[-1])
        split = fused1d.launches - before
    finally:
        fused1d._SCRATCH_BUDGET = budget
    check(split > 1, "the block ranges did not split")
    mx, _, _ = close_scaled(y, fused1d._fused_forward_reference(x, w, n), "B1 in block ranges")
    print(json.dumps({"phase": "kernel_vs_plain", "case": f"{split} block ranges",
                      "max_abs_err": mx}))
    torch.cuda.synchronize()

    # phases 3b and 4: the main path, counted from zero
    fused1d.launches = 0
    per_shape_launches = []
    for (b, cin, cout, l, k), (x, w, bias, n) in zip(BENCH_SHAPES, inputs):
        before = fused1d.launches
        y = fft_conv(x, w, bias, impl="auto")
        torch.cuda.synchronize()
        rose = fused1d.launches - before
        check(rose >= 1, f"fft_conv(impl='auto') at K={k} did not launch B1")
        per_shape_launches.append(rose)
        y_ref = fft_conv(x, w, bias, impl="xla")
        mx, mean, _ = close_scaled(y, y_ref, f"auto vs xla K={k}")
        print(json.dumps({"phase": "main_path", "K": k, "launches": rose,
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))
        torch.cuda.synchronize()

    layer = FFTConv1d(8, 8, 1024, device="cuda", generator=torch.Generator().manual_seed(0))
    x = inputs[1][0].clone().requires_grad_()
    before = fused1d.launches
    y = layer(x)
    y.sum().backward()
    torch.cuda.synchronize()
    layer_launches = fused1d.launches - before
    check(layer_launches >= 1, "FFTConv1d did not launch B1")
    w_ref = layer.weight.detach().clone().requires_grad_()
    x_ref = inputs[1][0].clone().requires_grad_()
    y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
    y_ref.sum().backward()
    close_scaled(y, y_ref, "FFTConv1d forward vs xla")
    gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConv1d weight grad vs xla")
    gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "FFTConv1d input grad vs xla")
    main_launches = fused1d.launches
    print(json.dumps({"phase": "module", "launches": layer_launches,
                      "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))
    torch.cuda.synchronize()

    # phase 5: timings. "*_ms" is device time (CUDA graph replay), "*_call_ms"
    # the latency a caller sees; inputs stay in L2 between calls, as for a
    # caller that has just made them. The card's busy share during a call of
    # fft_conv(impl="auto") is its device time over its call latency.
    shapes = []
    for (b, cin, cout, l, k), (x, w, bias, n), err, nl in zip(
        BENCH_SHAPES, inputs, errs, per_shape_launches
    ):
        spectra = fused1d.kernel_spectra_one_sided(w, n)

        def kernel():
            return fused1d._launch_fused1d(x, spectra, n, 1, k)

        def auto():
            return fft_conv(x, w, impl="auto")

        def composed():
            return fft_conv(x, w, impl="xla")

        nbytes, flops = fused1d_work(b, cin, cout, l, k, n)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS_PER_S * 1e3
        row = {
            "K": k, "N": n, "launches": nl, "max_abs_err": err,
            "ms": device_ms(kernel),
            "call_ms": call_ms(kernel),
            "spectra_ms": device_ms(lambda: fused1d.kernel_spectra_one_sided(w, n)),
            "auto_ms": device_ms(auto),
            "auto_call_ms": call_ms(auto),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            # the plain version copies its constants from the host on every
            # call, which a CUDA graph cannot capture: call latency only
            "plain_ms": call_ms(lambda: fused1d._fused_forward_reference(x, w, n)),
            "library_ms": device_ms(lambda: TF.conv1d(x, w)),
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        }
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        shapes.append(row)
        print(json.dumps({"phase": "timing", **row}))
        torch.cuda.synchronize()

    def total(key):
        return sum(r[key] for r in shapes)

    print(json.dumps({"kernels": [{
        "name": "B1_fused1d",
        "route": "cuda",
        "source": "fft_conv_tpu_torch/kernels/csrc/fused1d.cu",
        "replaces": "fft_conv_tpu/kernels/fused1d.py:291",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if total("bytes") / HBM_BYTES_PER_S
        > total("flops") / FP32_FLOPS_PER_S else "operations",
        "library_ms": total("library_ms"),
        "shapes": shapes,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
