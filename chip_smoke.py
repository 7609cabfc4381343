#!/usr/bin/env python3
"""Smoke test of fft_conv_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card, drives the main path
(``fft_conv(..., impl="auto")`` and the ``nn.FFTConv1d``/``nn.FFTConv2d``
layers forward and backward) at the library's benchmark shapes (B=2,
8 -> 8 channels, float32, bias, inputs from a torch.Generator seeded with 0:
1D at L=32768 with K in {256, 1024, 3840}, 2D at 512 x 512 with K in
{16, 34}), shows through the launch counters that the main path ran the
kernels, and times each kernel beside its plain version, the composed path,
one library call and the least time the card could take.

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
# (B, Cin, Cout, H, W, K): its 2D rows
BENCH_SHAPES_2D = [(2, 8, 8, 512, 512, 16), (2, 8, 8, 512, 512, 34)]
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


def fused2d_work(b, cin, cout, h, w, k, plan, groups=1):
    """(bytes, flops) the fused 2D function must move and do for one call.

    Bytes: the signal and the spectra (Cout, Cin/g, NB1, T2) read once, the
    output written once. Flops: the dense DFT products of the tiled
    algorithm with an FMA as two, restricted to what the call needs: no
    product over the zeros past the signal's edge and none for outputs that
    are not stored. Per tile, with rows_in x cols_in samples inside the
    signal and rows_out x cols_out outputs stored: per input channel, the
    one-sided H DFT (real x complex, 4 per term, NB1 x rows_in x cols_in)
    and the W DFT (complex, 8, NB1 x cols_in x T2); per output channel, the
    MAC over the group's channels (8, Cin/g x NB1 x T2), the inverse W DFT
    (8, NB1 x T2 x cols_out) and the H irfft (4, rows_out x NB1 x cols_out).
    csrc/fused2d.cu does more than this: it runs every product over the
    whole T1 x T2 tile."""
    t1, v1, nb1, t2, v2 = plan
    oh, ow = h - k + 1, w - k + 1
    cpg = cin // groups
    flops = 0
    for h0 in range(0, oh, v1):
        rows_in, rows_out = min(t1, h - h0), min(v1, oh - h0)
        for w0 in range(0, ow, v2):
            cols_in, cols_out = min(t2, w - w0), min(v2, ow - w0)
            flops += cin * (4 * nb1 * rows_in * cols_in + 8 * nb1 * cols_in * t2)
            flops += cout * (8 * cpg * nb1 * t2 + 8 * nb1 * t2 * cols_out
                             + 4 * rows_out * nb1 * cols_out)
    nbytes = 4 * b * cin * h * w + 8 * cout * cpg * nb1 * t2 + 4 * b * cout * oh * ow
    return nbytes, b * flops


def fused2d_kernel_flops(b, cin, cout, h, w, k, plan, groups=1):
    """The flops csrc/fused2d.cu does for one call: every product of
    fused2d_work over the whole T1 x T2 tile, the H irfft on V1 rows."""
    t1, v1, nb1, t2, v2 = plan
    tiles = -(-(h - k + 1) // v1) * -(-(w - k + 1) // v2)
    fwd = 4 * nb1 * t1 * t2 + 8 * nb1 * t2 * t2
    inv = 8 * (cin // groups) * nb1 * t2 + 8 * nb1 * t2 * t2 + 4 * v1 * nb1 * t2
    return b * tiles * (cin * fwd + cout * inv)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes and the operations
    bound on the card's data-sheet rates."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def check_fused2d(torch, dev, gen):
    """B2 against its plain version on the card at the 2D benchmark rows,
    with groups=2, through fft_conv2d_fused's argument surface, and with
    the tiles split over several launches. Returns the rows' inputs and
    their max abs errors."""
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import functional as F

    lib = fused2d._library()
    for t1 in (128, 256, 384):
        for t2 in (128, 256):
            smem = lib.fused2d_smem_bytes(t1, t2)
            check(smem == fused2d._smem_bytes(t1 // 2 + 1, t2),
                  f"tile plan's shared memory at T1={t1}, T2={t2} differs from the "
                  f"kernel's {smem}")

    inputs, errs = [], []
    for b, cin, cout, h, w, k in BENCH_SHAPES_2D:
        x = torch.randn(b, cin, h, w, generator=gen).to(dev)
        wt = (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        plan = fused2d.tile_plan_2d(k, k, cin, cout)
        check(plan is not None and fused2d.fused2d_fits(k, k, cin, cout, (h, w), batch=b),
              f"no fused 2D plan at K={k}")
        inputs.append((x, wt, bias, plan))
        spectra = fused2d.kernel_spectra_2d(wt, plan[0], plan[2], plan[3])
        y = fused2d._launch_fused2d(x, spectra, plan, 1, (k, k))
        torch.cuda.synchronize()
        mx, mean, sigma = close_scaled(y, fused2d._fused2d_forward_reference(x, wt),
                                       f"B2 vs plain K={k}")
        errs.append(mx)
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B2", "K": k,
                          "plan": dict(zip(("T1", "V1", "NB1", "T2", "V2"), plan)),
                          "max_abs_err": mx, "mean_abs_err": mean, "sigma": sigma,
                          "bar_max": 1.2e-4 * sigma, "bar_mean": 2e-5 * sigma}))

    x, wt, bias, plan = inputs[0]
    k = wt.shape[-1]
    wg = wt[:, :4].contiguous()  # groups=2: (Cout, Cin/2, K, K)
    y = fused2d._launch_fused2d(
        x, fused2d.kernel_spectra_2d(wg, plan[0], plan[2], plan[3]), plan, 2, (k, k))
    mx, _, _ = close_scaled(y, fused2d._fused2d_forward_reference(x, wg, 2), "B2 groups=2")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B2", "case": "groups=2",
                      "max_abs_err": mx}))

    kw = dict(padding=5, padding_mode="reflect", stride=(2, 3), dilation=2)
    y = fused2d.fft_conv2d_fused(x, wt, bias, **kw)
    xp = F._pad_signal(x, (5, 5), "reflect")
    y_ref = fused2d._fused2d_forward_reference(xp, F._dilate_kernel(wt, (2, 2)))
    y_ref = y_ref[:, :, ::2, ::3] + bias.reshape(1, -1, 1, 1)
    mx, _, _ = close_scaled(y, y_ref, "B2 stride/dilation/reflect")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B2",
                      "case": "stride=(2, 3), dilation=2, reflect padding 5",
                      "max_abs_err": mx}))

    budget = fused2d._SCRATCH_BUDGET
    try:
        fused2d._SCRATCH_BUDGET = 4 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 8)
        before = fused2d.launches
        y = fused2d._launch_fused2d(
            x, fused2d.kernel_spectra_2d(wt, plan[0], plan[2], plan[3]), plan, 1, (k, k))
        split = fused2d.launches - before
    finally:
        fused2d._SCRATCH_BUDGET = budget
    check(split > 1, "the tile ranges did not split")
    mx, _, _ = close_scaled(y, fused2d._fused2d_forward_reference(x, wt), "B2 in tile ranges")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B2",
                      "case": f"{split} tile ranges", "max_abs_err": mx}))
    torch.cuda.synchronize()
    return inputs, errs


def main_path_2d(torch, inputs):
    """fft_conv(impl="auto") at both 2D rows and FFTConv2d(8, 8, 16) forward
    and backward, counted from zero. Returns (launches per row, total)."""
    from fft_conv_tpu_torch import FFTConv2d, fft_conv
    from fft_conv_tpu_torch.kernels import fused2d

    fused2d.launches = 0
    per_row = []
    for (b, cin, cout, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_2D, inputs):
        before = fused2d.launches
        y = fft_conv(x, wt, bias, impl="auto")
        torch.cuda.synchronize()
        rose = fused2d.launches - before
        check(rose >= 1, f"fft_conv(impl='auto') at K={k} did not launch B2")
        per_row.append(rose)
        mx, mean, _ = close_scaled(y, fft_conv(x, wt, bias, impl="xla"),
                                   f"2D auto vs xla K={k}")
        print(json.dumps({"phase": "main_path", "kernel": "B2", "K": k, "launches": rose,
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

    layer = FFTConv2d(8, 8, 16, device="cuda", generator=torch.Generator().manual_seed(0))
    x = inputs[0][0].clone().requires_grad_()
    before = fused2d.launches
    y = layer(x)
    y.sum().backward()
    torch.cuda.synchronize()
    layer_launches = fused2d.launches - before
    check(layer_launches >= 1, "FFTConv2d did not launch B2")
    w_ref = layer.weight.detach().clone().requires_grad_()
    x_ref = inputs[0][0].clone().requires_grad_()
    y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
    y_ref.sum().backward()
    close_scaled(y, y_ref, "FFTConv2d forward vs xla")
    gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConv2d weight grad vs xla")
    gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "FFTConv2d input grad vs xla")
    total = fused2d.launches
    print(json.dumps({"phase": "module", "kernel": "B2", "launches": layer_launches,
                      "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))
    torch.cuda.synchronize()
    return per_row, total


def time_2d(torch, inputs, errs, per_row):
    """The timing rows of the 2D benchmark shapes (see phase 5 of main)."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels import fused2d

    rows = []
    for (b, cin, cout, h, w, k), (x, wt, _, plan), err, nl in zip(
        BENCH_SHAPES_2D, inputs, errs, per_row
    ):
        t1, _, nb1, t2, _ = plan
        spectra = fused2d.kernel_spectra_2d(wt, t1, nb1, t2)

        def kernel():
            return fused2d._launch_fused2d(x, spectra, plan, 1, (k, k))

        def auto():
            return fft_conv(x, wt, impl="auto")

        def composed():
            return fft_conv(x, wt, impl="xla")

        nbytes, flops = fused2d_work(b, cin, cout, h, w, k, plan)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {
            "K": k, "plan": list(plan), "launches": nl, "max_abs_err": err,
            "ms": device_ms(kernel),
            "call_ms": call_ms(kernel),
            "spectra_ms": device_ms(lambda: fused2d.kernel_spectra_2d(wt, t1, nb1, t2)),
            "auto_ms": device_ms(auto),
            "auto_call_ms": call_ms(auto),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            "plain_ms": call_ms(lambda: fused2d._fused2d_forward_reference(x, wt)),
            "library_ms": device_ms(lambda: TF.conv2d(x, wt)),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_flops": fused2d_kernel_flops(b, cin, cout, h, w, k, plan),
        }
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        rows.append(row)
        print(json.dumps({"phase": "timing", "kernel": "B2", **row}))
        torch.cuda.synchronize()
    return rows


def kernel_entry(name, source, replaces, launches, errs, rows):
    """One entry of the ``kernels`` line: the sums over the timed rows."""
    def total(key):
        return sum(r[key] for r in rows)

    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(errs),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": bound(total("bytes"), total("flops"))[1],
        "library_ms": total("library_ms"), "shapes": rows,
    }


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
    inputs2d, errs2d = check_fused2d(torch, dev, gen)

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
    per_row2d, main_launches2d = main_path_2d(torch, inputs2d)

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
        bound_ms, bound_by = bound(nbytes, flops)
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
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        shapes.append(row)
        print(json.dumps({"phase": "timing", **row}))
        torch.cuda.synchronize()

    rows2d = time_2d(torch, inputs2d, errs2d, per_row2d)

    print(json.dumps({"kernels": [
        kernel_entry("B1_fused1d", "fft_conv_tpu_torch/kernels/csrc/fused1d.cu",
                     "fft_conv_tpu/kernels/fused1d.py:291", main_launches, errs, shapes),
        kernel_entry("B2_fused2d", "fft_conv_tpu_torch/kernels/csrc/fused2d.cu",
                     "fft_conv_tpu/kernels/fused2d.py:308", main_launches2d, errs2d, rows2d),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
