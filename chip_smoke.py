#!/usr/bin/env python3
"""Smoke test of fft_conv_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card, drives the main path
(``fft_conv(..., impl="auto")``, ``fft_conv_transpose`` and the
``nn.FFTConv1d/2d/3d`` and ``nn.FFTConvTranspose1d/2d/3d`` layers forward
and backward) at the library's benchmark shapes (B=2, 8 -> 8 channels,
float32, bias, inputs from a torch.Generator seeded with 0: 1D at L=32768
with K in {256, 1024, 3840}, 2D at 512 x 512 with K in {16, 34}, 3D at 64^3
with K=8, forward and transposed) and at 64^3 with K=10 (the 3D tap kernel
B4, and its transposed call); the 2D rows run once more under
``set_fused2d_kernel("v3")`` (kernel B5), the 3D row's paths under
``set_fused3d_xpack("pk")`` (the x-pack kernel B6 ahead of B3), and every
row through a serving plan (``ops.plan_fft_conv``,
``ops.plan_fft_conv_transpose``) with its kernel spectra baked. It shows
through the launch counters that each path ran its kernels, and times each
kernel beside its plain version, the composed path, one library call and the
least time the card could take (the counts of ``fft_conv_tpu_torch.kernels.costs``).
Phase 5b turns on ``set_fused3d_inline`` (off by default): kernel B7, which
computes B3's kernel spectra from the raw taps, against its plain version
at the working lengths 64, 48, 78 and a dense 12; the 3D rows under
``impl="auto"`` and the K=8 transposed call under ``impl="fused"`` with B7
launched once ahead of B3, each held to the composed path; B7's time beside
the torch spectra it replaces, ``torch.fft.fftn`` and its bound, and each
call with inline on and off. Phase 5c runs B1 under
``set_fused_precision("bf16x3")`` and ``("bf16")``, the tensor-core pair of
``csrc/fused1d.cu``: against its plain version at check_fused1d's cases
("bf16" under its own bar, ``close_bf16``), through the 1D main paths
(``fft_conv``, a plan, the transposed call, ``FFTConv1d``) counted from zero,
with the three modes' errors against the float64 composed path ordered, and
timed beside "highest" at the 1D rows; phase 2 fails if any of B1's 36
entry points spills or a tensor-core one holds no HMMA instruction
(``cuobjdump -sass``). Phase 5d does the same for B2 under
``set_fused2d_precision("bf16x3")`` and ``("bf16")``, the tensor-core route
of ``csrc/fused2d.cu`` (phase 1, the MAC stage, the inverse stage): against
its plain version at check_fused2d's cases and at the MAC stage's own
(groups, one channel a group, B = 3, 24 and 15 channels, 100 output
channels), through the 2D main paths (``fft_conv``, a plan, the transposed
call, ``FFTConv2d``) counted from zero, the modes' errors ordered, and the
three modes timed at the 2D rows, each kernel apart; phase 2 fails if one of
its 24 entry points spills or holds no HMMA. Phase 5d runs B5 the same way
under ``set_fused2d_kernel("v3")``: its tensor-core route (B5's phase 1,
B2's MAC stage without its W DFT, B5's inverse stage) at the same cases and
main paths, with no other 2D kernel launched, timed beside B5 "highest" and
B2's route; phase 2 fails if one of its 20 entry points spills, one of its
16 DFT kernels holds no HMMA or its 4 MAC stages hold any. Phase 5e does the same for B3 and B4 under
``set_fused3d_precision("bf16x3")`` and ``("bf16")``, their tensor-core
chains in ``csrc/fused3d.cu``: against their plain versions at the 3D rows
and around them (dense and odd H, the stuffed transposed volumes, H = 256,
groups, staged chunks, "pk", item ranges), through the 3D main paths
(``fft_conv``, plans, the transposed calls, ``FFTConv3d``,
``FFTConvTranspose3d``, "pk", inline) counted from zero, the modes' errors
ordered at the 3D rows, and the three modes timed at the four 3D rows;
phase 2 fails if one of fused3d.cu's 63 entry points spills or one of its
30 tensor-core ones holds no HMMA or takes more than 128 registers. Then
three phases drive the modules around the kernels: ``streaming`` (each
1D row's signal fed to ``ops.streaming_conv1d_step`` in 8 frames of 4096
samples, a ragged split, dilation 2 and groups 2; one B1 launch per chunk,
held to the one-shot call; the step's and the stream's times), ``harness``
(``bench.harness`` and ``bench.profiling`` on the 1D K=1024 row:
``benchmark_fori`` within 10% of the host clock over back-to-back graph
replays, the allocator's peak, ``cost_analysis`` holding B1's own count and
the per-call spectra, ``roofline``, a trace that names B1's kernels) and
``checkpoint`` (``utils.checkpoint`` round trips on the card, bit for bit,
and a ``torch.nn.ConvTranspose1d`` state dict in ``FFTConvTranspose1d``).
Last, ``tiled`` drives ``impl="tiled"`` (the overlap-save DFT-matmul tiles
of ``ops/tiled.py``, cuBLAS products in FP32, no fused kernel) at the 2D
rows, the 1D K=1024 row, the 2D transposed K=16 row, the 3D row (whose tile
plan is the whole volume: the composed path) and an ``FFTConv2d`` layer,
each held to the composed path, and a tiled call with TF32 allowed
globally. Then ``parallel`` starts a one-rank NCCL group and runs
``fft_conv_tpu_torch.parallel`` on the mesh ``make_mesh()``: the sharded
forward at the 1D K=1024, 2D K=16 and 3D K=8 rows (B1, B2, B3 once each),
``tp_mode="in"`` and the transposed function at 1D K=256 and 2D K=16, each
bit-equal to the unsharded call, a weight gradient, a one-shard
overlap-save call (no kernel), a DP forward with no NCCL call, and the
sharded call's time beside the unsharded one's. Phase 11 runs the five
examples of ``fft_conv_tpu_torch.examples`` at the JAX scripts' sizes, each
counted from zero (B1 258 times in the audio example, B2 4 in the serving
plans, B2 3 in the filter bank, none in the volume example, whose padded
70^3 "auto" does not fuse, B1 10 in training), every output held to
impl="xla", and the volume call once more under impl="fused" (B3 over two
W blocks). Phase 12 runs the benchmark sweep
(``bench.generate_benchmark_plot.run_sweep``) at 1D K in {1, 256, 3840},
2D {1, 16, 34}, 3D {1, 8}: every row present but the fused rows no plan
fits, finite times, the allocator read, B1, B2 and B3 launched, and the
FFT methods held to the direct baselines at one K per rank.

Every phase prints one line; any failed check raises and the script exits
non-zero without a result. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX: the port stands alone.
"""

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# (B, Cin, Cout, L, K): the 1D rows of the repo's benchmark (bench.py)
BENCH_SHAPES = [(2, 8, 8, 32768, 256), (2, 8, 8, 32768, 1024), (2, 8, 8, 32768, 3840)]
# (B, Cin, Cout, H, W, K): its 2D rows
BENCH_SHAPES_2D = [(2, 8, 8, 512, 512, 16), (2, 8, 8, 512, 512, 34)]
# (B, Cin, Cout, D, H, W, K): its 3D row, then the same call at 48^3, whose
# H/W kernels run the mixed-radix working length Hw = 48 = 8 x 6
BENCH_SHAPES_3D = [(2, 8, 8, 64, 64, 64, 8), (2, 8, 8, 48, 48, 48, 8)]
# the B4 row: the 3D row's volume, batch and channels with the smallest
# kernel past the v4 plan's KD <= 9; then at 48^3
BENCH_SHAPES_3D_TAP = [(2, 8, 8, 64, 64, 64, 10), (2, 8, 8, 48, 48, 48, 10)]
# the transposed 3D calls: the benchmark row (B3, two W blocks) and K=10 (B4)
TRANSPOSED_3D_K = (8, 10)
# (x shape, kernel shape, groups, case): the factored H/W kernels of B3 and B4
# at the H they take besides the rows' 64, 48 and the stuffed 78 and 82, at
# odd D and odd OD, and at a clamped third W block (start 86 of W = 150): the
# four built for their constant splits (16, 32, 64, 128); then the one that
# takes its split as arguments at one H of each radix it runs (HA 3 to 16,
# HB 2 to 16; 18 = 3 x 6, 22 = 11 x 2, 30 = 5 x 6, 54 = 9 x 6, 60 = 10 x 6,
# 98 = 7 x 14, 110 = 11 x 10, 120 = 12 x 10, 156 = 13 x 12, 196 = 14 x 14,
# 240 = 15 x 16,
# 256 = 16 x 16), and at H padded to their working length (17 -> 18, 37 ->
# 40, 121 -> 126, 200 -> 208, 229 -> 240)
FACTORED_3D = [
    ((2, 8, 13, 16, 20), (8, 8, 3, 3, 3), 1, "H=16, D=13 (OD 11)"),
    ((2, 8, 18, 32, 40), (8, 4, 4, 5, 5), 2, "H=32, D=18 (OD 15), groups=2"),
    ((1, 4, 11, 128, 64), (4, 4, 5, 7, 3), 1, "H=128, D=11 (OD 7)"),
    ((2, 4, 9, 64, 150), (4, 4, 3, 3, 7), 1, "H=64, W=150 in 3 W blocks, D=9 (OD 7)"),
    ((2, 4, 13, 18, 20), (4, 4, 3, 3, 3), 1, "H=18 (3 x 6), D=13"),
    ((2, 4, 10, 22, 20), (4, 4, 3, 3, 3), 1, "H=22 (11 x 2)"),
    ((2, 4, 9, 30, 24), (4, 4, 4, 5, 3), 1, "H=30 (5 x 6), D=9 (OD 6)"),
    ((1, 4, 11, 54, 40), (4, 4, 3, 7, 5), 1, "H=54 (9 x 6)"),
    ((2, 4, 9, 60, 150), (4, 4, 3, 3, 7), 1, "H=60 (10 x 6), W=150 in 3 W blocks"),
    ((1, 4, 10, 98, 20), (4, 4, 3, 3, 3), 1, "H=98 (7 x 14)"),
    ((1, 4, 9, 110, 20), (4, 2, 3, 3, 3), 2, "H=110 (11 x 10), groups=2"),
    ((1, 4, 10, 120, 20), (4, 4, 3, 3, 3), 1, "H=120 (12 x 10)"),
    ((1, 2, 11, 156, 20), (2, 2, 3, 5, 3), 1, "H=156 (13 x 12)"),
    ((1, 2, 10, 196, 20), (2, 2, 3, 3, 3), 1, "H=196 (14 x 14)"),
    ((1, 2, 9, 240, 20), (2, 2, 3, 3, 3), 1, "H=240 (15 x 16)"),
    ((1, 2, 10, 256, 20), (2, 2, 3, 3, 3), 1, "H=256 (16 x 16)"),
    ((2, 4, 11, 17, 20), (4, 4, 3, 3, 3), 1, "H=17 padded to 18"),
    ((2, 4, 10, 37, 45), (4, 4, 3, 5, 7), 1, "H=37 padded to 40"),
    ((1, 4, 11, 121, 20), (4, 4, 3, 3, 3), 1, "H=121 padded to 126 (9 x 14)"),
    ((1, 2, 11, 200, 40), (2, 2, 3, 3, 3), 1, "H=200 padded to 208 (13 x 16)"),
    ((1, 2, 10, 229, 20), (2, 2, 3, 3, 3), 1, "H=229 padded to 240"),
]
FACTORED_3D_TAP = [
    ((2, 4, 21, 16, 12), (4, 4, 11, 3, 3), 1, "H=16, D=21 (OD 11)"),
    ((2, 4, 24, 32, 30), (4, 4, 10, 5, 3), 1, "H=32, D=24 (OD 15)"),
    ((1, 4, 13, 128, 20), (4, 4, 10, 5, 5), 1, "H=128, D=13 (OD 4)"),
    ((2, 4, 20, 64, 150), (4, 4, 12, 3, 7), 1, "H=64, W=150 in 3 W blocks, OD=9"),
    ((2, 4, 21, 26, 12), (4, 4, 10, 3, 3), 1, "H=26 (13 x 2)"),
    ((2, 4, 20, 70, 30), (4, 4, 11, 5, 3), 1, "H=70 (7 x 10), OD 10"),
    ((1, 4, 14, 150, 20), (4, 4, 10, 3, 3), 1, "H=150 (15 x 10)"),
    ((2, 4, 21, 33, 12), (4, 4, 11, 3, 3), 1, "H=33 padded to 36"),
    ((1, 4, 14, 82, 150), (4, 4, 10, 3, 7), 1, "H=82 padded to 84, W=150 in 3 W blocks"),
    ((1, 2, 15, 203, 20), (2, 2, 12, 3, 3), 1, "H=203 padded to 208"),
]
# (x shape, kernel shape, groups, case): the D kernels' edges, a group whose
# spectra a block stages in several chunks (B3: 8 channels a chunk at 8
# out-channels a block; B4: 128 (channel, tap) entries at 4) and KD close
# to D
D_EDGES_3D = [
    ((2, 24, 20, 8, 20), (24, 24, 3, 3, 3), 1, "Cin = Cout = 24: 3 staged chunks"),
    ((1, 48, 12, 8, 24), (24, 16, 5, 3, 3), 3, "groups=3, 16 -> 8 a group: 2 staged chunks"),
    ((2, 4, 10, 16, 12), (4, 4, 9, 3, 3), 1, "D=10, KD=9 (OD 2)"),
]
D_EDGES_3D_TAP = [
    ((2, 16, 14, 16, 12), (16, 16, 11, 3, 3), 1, "Cin = Cout = 16, KD=11: 2 staged chunks"),
    ((1, 4, 64, 64, 64), (4, 4, 60, 3, 3), 1, "D=64, KD=60 (OD 5): 2 staged chunks"),
    ((2, 4, 20, 16, 12), (4, 4, 20, 3, 3), 1, "KD = D = 20 (OD 1)"),
]
WARMUP, ITERS, GRAPH_REPS = 5, 30, 20
# profile_ms's traces of one call at most, while a trace holds none of its kernels
PROFILE_TRIES = 3
# the streaming phase: each 1D row's 32768 samples as 8 frames of 4096, as a
# server filters a long audio signal, and at K=1024 a ragged split of them
STREAM_CHUNK, STREAM_CHUNKS = 4096, 8
# the harness phase's witness: graph replays timed together on the host clock
WITNESS_REPLAYS = 200
RAGGED_CHUNKS = (1000, 5000, 26768)
# (taps, Hw, case): kernel B7 against its plain version at the working
# lengths of the 3D rows' H and of the transposed K=8 row's stuffed volume,
# and at a dense H
INLINE_HW = [((8, 8, 8, 8, 8), 64, "64^3 K=8 (Hw 64)"), ((8, 8, 8, 8, 8), 48, "48^3 K=8 (Hw 48)"),
             ((8, 8, 8, 8, 8), 78, "stuffed 78^3 K=8 (Hw 78)"),
             ((4, 4, 3, 3, 3), 12, "H=12 (dense, Hw 12)")]
# the launch counters' names, in _counts' order
KERNEL_NAMES = ("B1", "B2", "B5", "B3", "B4", "B6", "B7")
# the examples phase: the launches each example makes at the JAX scripts'
# sizes (the audio example: one-shot, plan, 256 stream steps; training: two
# layers' forwards in each of 5 steps, the backward composed; the volume's
# padded 70^3 needs two W blocks, which "auto" does not fuse)
EXAMPLE_LAUNCHES = {"long_audio_filter": {"B1": 258}, "serving_plans": {"B2": 4},
                    "image_filter_bank_2d": {"B2": 3}, "volume_stencil_3d": {},
                    "train_fft_cnn": {"B1": 10}}
# the sweep phase: the kernel sizes swept per config (1D, 2D, 3D), and the
# one per config at which the methods are held to the baselines
SWEEP_KS = ((1, 256, 3840), (1, 16, 34), (1, 8))
SWEEP_HELD_K = (256, 16, 8)


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


def call_ms(fn):
    """Latency of one call as a caller sees it, host work included: the
    median over ITERS of CUDA events around each call, after WARMUP calls.
    At these sizes the host enqueues slower than the card computes, so this
    is mostly host time."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn):
    """Device time of one call: GRAPH_REPS calls captured in a CUDA graph
    (after warm-up eager calls, which build caches and plans), the graph
    replayed, the median divided by GRAPH_REPS: the package's own graph
    timer, ``bench.harness.graph_seconds``, which ``benchmark_fori`` runs.
    The replay carries no host work, so this is the card's own time."""
    from fft_conv_tpu_torch.bench.harness import graph_seconds

    return graph_seconds(fn, GRAPH_REPS)[0] * 1e3


def close_bf16(y, y_ref, what):
    """The bar of B1's "bf16" tensor-core pair against its plain version
    (tests/test_torch_cuda.py:_assert_bf16_kernel_close): err_mean < 5e-4 *
    sigma and err_max < 2.5e-2 * sigma, sigma = max(1, std(ref)). Both round
    the same operands to bf16, but their FP32 sums can differ in the last
    bit, which now and then flips an operand's rounding by one bf16 step;
    the mean bar is a tenth of the JAX package's serving bar against the
    exact result. Returns (max abs err, mean abs err, sigma)."""
    y, y_ref = y.detach(), y_ref.detach()
    check(y.shape == y_ref.shape, f"{what}: shape {tuple(y.shape)} vs {tuple(y_ref.shape)}")
    check(bool(y.isfinite().all()), f"{what}: non-finite values")
    err = (y.double() - y_ref.double()).abs()
    sigma = max(1.0, float(y_ref.double().std()))
    mean, mx = float(err.mean()), float(err.max())
    check(mean < 5e-4 * sigma, f"{what}: err_mean {mean:.3e} >= 5e-4 * {sigma:.3f}")
    check(mx < 2.5e-2 * sigma, f"{what}: err_max {mx:.3e} >= 2.5e-2 * {sigma:.3f}")
    return mx, mean, sigma


def close_bf16_2d(y, y_ref, y_exact, what):
    """The bar of B2's "bf16" tensor-core route against its plain version, and
    of B3's and B4's tensor-core chains, whose ten rounding steps spread a
    flipped rounding alike (tests/test_torch_cuda.py:
    _assert_bf16_2d_kernel_close): err_mean <
    2e-3 * sigma, err_max < 2.5e-2 * sigma, and the kernel's err_mean against
    the float64 result ``y_exact`` within 1% of the plain version's. A bf16
    rounding that goes the other way in a tile's first steps spreads through
    its eight rounding steps (a call up to 1.2e-3 * sigma apart on an H100,
    survey_fused2d_bf16.py), so the pointwise bar is looser than
    close_bf16's, and the ratio, within 0.11% there, holds the kernel to the
    mode's arithmetic.
    Returns (max abs err, mean abs err, sigma, error ratio)."""
    y, y_ref, y_exact = y.detach().double(), y_ref.detach().double(), y_exact.detach().double()
    check(y.shape == y_ref.shape, f"{what}: shape {tuple(y.shape)} vs {tuple(y_ref.shape)}")
    check(bool(y.isfinite().all()), f"{what}: non-finite values")
    err = (y - y_ref).abs()
    sigma = max(1.0, float(y_ref.std()))
    mean, mx = float(err.mean()), float(err.max())
    check(mean < 2e-3 * sigma, f"{what}: err_mean {mean:.3e} >= 2e-3 * {sigma:.3f}")
    check(mx < 2.5e-2 * sigma, f"{what}: err_max {mx:.3e} >= 2.5e-2 * {sigma:.3f}")
    ratio = float((y - y_exact).abs().mean()) / float((y_ref - y_exact).abs().mean())
    check(abs(ratio - 1) < 1e-2, f"{what}: err_mean against float64 {ratio:.4f}x the plain "
                                 f"version's")
    return mx, mean, sigma, ratio


def check_fused1d(torch, dev, inputs, mode="highest"):
    """B1 against its plain version on the card at the 1D benchmark rows,
    with groups=2, with the blocks split over several launches, at V1 = 1
    (K = N - 127) for N1 = 16 and 64, on a single block, at Cin = 3 with
    groups=3 and on the stuffed signal of the K=256 transposed row (L =
    33278). Between them they run each phase at each N1 in both block
    sizes (512 threads where a phase's grid has no more blocks than the card
    has SMs: the K=3840 row, the single block, groups=3). The extra cases
    draw from their own generator. ``mode``: the precision mode, whose
    kernel pair and plain version are compared ("bf16x3" and "bf16": the
    tensor-core pair, at the same two block sizes; "bf16" under
    ``close_bf16``). Returns the rows' max abs errors."""
    from fft_conv_tpu_torch.kernels import fused1d

    name = "B1" if mode == "highest" else f"B1 {mode}"
    close, bars = (close_bf16, (2.5e-2, 5e-4)) if mode == "bf16" else (close_scaled,
                                                                        (1.2e-4, 2e-5))

    def count():
        return fused1d.launches if mode == "highest" else fused1d.launches_tc

    def vs_plain(x, w, n, groups, what):
        before = count()
        y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, n), n, groups,
                                    w.shape[-1], mode)
        torch.cuda.synchronize()
        launched = count() - before
        check(launched >= 1, f"{name} {what}: no launch")
        mx, mean, sigma = close(
            y, fused1d._fused_forward_reference(x, w, n, groups, mode=mode),
            f"{name} vs plain, {what}")
        v1, v_total, nblk = fused1d._blocking(n, w.shape[-1], x.shape[-1])
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": name, "case": what, "N": n,
                          "V1": v1, "blocks": nblk, "launches": launched, "max_abs_err": mx,
                          "mean_abs_err": mean, "sigma": sigma, "bar_max": bars[0] * sigma,
                          "bar_mean": bars[1] * sigma}))
        return mx

    errs = [vs_plain(x, w, n, 1, f"K={w.shape[-1]}") for x, w, _, n in inputs]
    x, w, _, n = inputs[1]
    vs_plain(x, w[:, :4].contiguous(), n, 2, "groups=2")
    budget = fused1d._SCRATCH_BUDGET
    try:
        fused1d._SCRATCH_BUDGET = 3 * fused1d._scratch_bytes_per_block(n, 2, 8)
        before = count()
        vs_plain(x, w, n, 1, "block ranges")
        split = count() - before
    finally:
        fused1d._SCRATCH_BUDGET = budget
    check(split > 1, "the block ranges did not split")

    gen = torch.Generator().manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    for n in (2048, 8192):
        k = n - 127
        vs_plain(randn(2, 8, 20000), randn(8, 8, k, scale=(8 * k) ** -0.5), n, 1,
                 f"V1=1, K={k}")
    vs_plain(randn(2, 8, 1900), randn(8, 8, 256, scale=(8 * 256) ** -0.5), 2048, 1,
             "single block, L=1900, K=256")
    vs_plain(randn(2, 3, 20000), randn(6, 1, 700, scale=700 ** -0.5), 4096, 3,
             "Cin=3, groups=3, K=700")
    b, cin, cout, l, k = BENCH_SHAPES[0]
    ls = l + 2 * (k - 1)
    vs_plain(randn(b, cin, ls), randn(cout, cin, k, scale=(cin * k) ** -0.5),
             fused1d.choose_fft_size(k, ls, cin, cout, batch=b), 1,
             f"stuffed transposed length L={ls}, K={k}")
    torch.cuda.synchronize()
    return errs


def ptxas_spills(log):
    """{function: (spill stores, spill loads)} in bytes, from nvcc's
    -Xptxas -v output."""
    spills, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return spills


def ptxas_registers(log):
    """{kernel: registers a thread} from nvcc's -Xptxas -v output, each
    kernel named by its mangled name from its identifier to its template
    arguments (e.g. fused3d_hw_forward_fILi64ELi2ELb0EE: <64, 2, false>)."""
    regs, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = re.sub(r"^.*?\d+(fused\dd_)", r"\1", m.group(1)).split("Ev", 1)[0]
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            regs[fn] = int(m.group(1))
            fn = None
    return regs


def sass_hmma(path):
    """{kernel: HMMA instructions} of each kernel in the library at path,
    from ``cuobjdump -sass``: the tensor-core products it issues."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bHMMA\b", ln):
            counts[fn] += 1
    return counts


def main_path_precision(torch, inputs, mode):
    """B1's main paths under ``set_fused_precision(mode)`` ("bf16x3" or
    "bf16"), counted from zero: fft_conv(x, w, bias) (impl="auto") at the
    three 1D rows, a tier-1 plan of each (ops.plan_fft_conv), the
    transposed call fft_conv_transpose(x, w, bias) on each row's signal,
    and FFTConv1d(8, 8, 1024) forward. Each launches the tensor-core pair
    once and the FP32 pair never, and is held to the composed path in
    float64: "bf16x3" under the FP32 bar, "bf16" under the JAX package's
    serving bar (err_mean < 5e-3 * sigma, err_max < 5e-2 * sigma). Returns
    the tensor-core launches and {case: err_mean / sigma}."""
    from fft_conv_tpu_torch import FFTConv1d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused1d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    def held(y, ref, what):
        y_ref = ref()
        if mode == "bf16x3":
            mx, mean, sigma = close_scaled(y, y_ref, what)
        else:
            err = (y.detach().double() - y_ref).abs()
            sigma = max(1.0, float(y_ref.std()))
            mean, mx = float(err.mean()), float(err.max())
            check(mean < 5e-3 * sigma and mx < 5e-2 * sigma,
                  f"{what}: err_mean {mean:.3e}, err_max {mx:.3e} past the serving bar at "
                  f"sigma {sigma:.3f}")
        return mean / sigma, mx / sigma

    def drive(fn, ref, what):
        before = fused1d.launches, fused1d.launches_tc
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        rose = fused1d.launches - before[0], fused1d.launches_tc - before[1]
        check(rose == (0, 1), f"{what} under {mode!r} launched (FP32, tensor-core) {rose}")
        mean, mx = held(y, ref, what)
        print(json.dumps({"phase": "main_path_precision", "mode": mode, "case": what,
                          "launches_tc": rose[1], "err_mean_vs_float64": mean,
                          "err_max_vs_float64": mx}))
        return mean

    errs = {}
    fused1d.set_fused_precision(mode)
    fused1d.launches = fused1d.launches_tc = 0
    layer = FFTConv1d(8, 8, 1024, device="cuda", generator=torch.Generator().manual_seed(0))
    for x, w, bias, _ in inputs:
        k, l = w.shape[-1], x.shape[-1]
        x64, w64, b64 = x.double(), w.double(), bias.double()
        planned = plan_fft_conv(w, bias, signal_spatial=(l,), max_batch=x.shape[0])
        errs[f"auto K={k}"] = drive(lambda: fft_conv(x, w, bias),
                                    lambda: fft_conv(x64, w64, b64, impl="xla"),
                                    f"fft_conv auto K={k}")
        drive(lambda: planned(x), lambda: fft_conv(x64, w64, b64, impl="xla"), f"plan K={k}")
        drive(lambda: fft_conv_transpose(x, w, bias),
              lambda: fft_conv_transpose(x64, w64, b64, impl="xla"),
              f"fft_conv_transpose K={k}")
    x = inputs[1][0]
    drive(lambda: layer(x), lambda: fft_conv(x.double(), layer.weight.double(),
                                             layer.bias.double(), impl="xla"),
          "FFTConv1d(8, 8, 1024)")
    torch.cuda.synchronize()
    launched = fused1d.launches_tc
    check(fused1d.launches == 0, f"the FP32 pair ran under {mode!r}")
    return launched, errs


def phase_precision(torch, dev, inputs, shapes):
    """Phase 5c: B1's precision modes. Under "bf16x3" and "bf16" the
    tensor-core pair against its plain version at check_fused1d's cases and
    the main paths of main_path_precision (counted from zero); at the 1D
    rows the errors of fft_conv under the three modes against the composed
    path in float64, ordered "highest" < "bf16x3" < "bf16" with err_mean
    at least 4x and then 50x the one before (the CPU tests measure about
    35x and 650x; a mode running another's arithmetic gives 1x); then the
    three modes timed side by side at each row: the kernel pair's device time
    and call latency, its two kernels (profiler), fft_conv and the plan, the
    plain version, and the bound (``costs.fused1d_work`` for "highest";
    otherwise ``costs.mode_bound``, the lesser of that and
    ``costs.fused1d_tc_work`` with the products at the bf16 rate).
    "highest" is restored at the end, so later phases run as before.
    Returns {mode: (launches, kernel-vs-plain errors, timing rows)} for the
    bf16 modes."""
    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels import fused1d
    from fft_conv_tpu_torch.kernels.costs import bound, fused1d_tc_work, fused1d_work, mode_bound
    from fft_conv_tpu_torch.ops import plan_fft_conv

    out = {}
    try:
        for mode in fused1d.PRECISION_MODES[1:]:
            fused1d.set_fused_precision("highest")
            errs = check_fused1d(torch, dev, inputs, mode)
            launched, _ = main_path_precision(torch, inputs, mode)
            print(json.dumps({"phase": "main_path_counts", "mode": mode,
                              "launches_tc": launched}))
            out[mode] = (launched, errs, [])
        for (b, cin, cout, l, k), (x, w, bias, n) in zip(BENCH_SHAPES, inputs):
            ref = fft_conv(x.double(), w.double(), bias.double(), impl="xla")
            sigma = max(1.0, float(ref.std()))
            order = []
            for mode in fused1d.PRECISION_MODES:
                fused1d.set_fused_precision(mode)
                order.append(float((fft_conv(x, w, bias).double() - ref).abs().mean()) / sigma)
            print(json.dumps({"phase": "precision_order", "K": k, "err_mean_vs_float64":
                              dict(zip(fused1d.PRECISION_MODES, order))}))
            check(4 * order[0] < order[1] and 50 * order[1] < order[2],
                  f"K={k}: the modes' errors against float64 are not ordered: {order}")
        for (b, cin, cout, l, k), (x, w, bias, n), base in zip(BENCH_SHAPES, inputs, shapes):
            spectra = fused1d.kernel_spectra_one_sided(w, n)
            planned = plan_fft_conv(w, signal_spatial=(l,), max_batch=b)
            for mode in fused1d.PRECISION_MODES:
                fused1d.set_fused_precision(mode)

                def kernel():
                    return fused1d._launch_fused1d(x, spectra, n, 1, k, mode)

                def auto():
                    return fft_conv(x, w, impl="auto")

                (nbytes, flops), bf16_flops = fused1d_work(b, cin, cout, l, k, n), 0
                bound_ms, bound_by = bound(nbytes, flops)
                if mode != "highest":
                    bound_ms, bound_by, (nbytes, flops, bf16_flops) = mode_bound(
                        (nbytes, flops), fused1d_tc_work(b, cin, cout, l, k, n, mode))
                row = {
                    "mode": mode, "K": k, "N": n,
                    "ms": device_ms(kernel), "call_ms": call_ms(kernel),
                    "phase_ms": phase_split_ms(torch, kernel, "fused1d_"),
                    "auto_ms": device_ms(auto), "plan_ms": device_ms(lambda: planned(x)),
                    "plain_ms": call_ms(
                        lambda: fused1d._fused_forward_reference(x, w, n, mode=mode)),
                    "library_ms": base["library_ms"], "composed_ms": base["composed_ms"],
                    "bytes": nbytes, "flops": flops, "bf16_flops": bf16_flops,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                if mode != "highest":
                    out[mode][2].append({**row, "max_abs_err": out[mode][1][len(out[mode][2])]})
                print(json.dumps({"phase": "timing_precision", **row}))
                torch.cuda.synchronize()
    finally:
        fused1d.set_fused_precision("highest")
    return out


# fused2d's launch counters: B2's FP32 pair, B2's tensor-core route, B5's
# FP32 pair, B5's tensor-core route
COUNTERS_2D = ("launches", "launches_tc", "launches_v3", "launches_v3_tc")


def counts_2d():
    from fft_conv_tpu_torch.kernels import fused2d

    return tuple(getattr(fused2d, c) for c in COUNTERS_2D)


def check_fused2d_tc(torch, inputs, mode, v3=False):
    """B2's tensor-core route (``v3``: B5's) under ``mode`` ("bf16x3" or
    "bf16") against its plain version of that mode
    (``_fused2d_forward_reference(..., mode=)``, or ``_v3``'s) at
    check_fused2d's cases: the 2D rows (B2's inputs), groups=2,
    T1 = 256 (K1 = 70), T1 = 384 (K1 = 200), T2 = 256 (K2 = 100) alone and
    with groups=2, fft_conv2d_fused's stride, dilation and reflect padding,
    and the tiles split over several launches (D and Y counted); and at the
    cases of the route's MAC stage (``fused2d._tc_geometry``): Cout = 6 in 3
    groups (2 output channels a group), one channel a group (groups = Cin =
    Cout = 4), B = 3 at the 512 x 512 row (75 units: the last MAC block
    holds 3 of its 8, and blocks span tiles), Cin = Cout = 24 in 3 groups
    (at groups = 1 the spectra exceed the plan's budget, so no shape of 24
    -> 24 channels and one group fuses), Cin = Cout = 15 (4 channel chunks,
    2 output-channel passes) and Cin = 1, Cout = 100 (2 output-channel
    blocks). The extra cases draw from a generator of their own, so that
    the phases after this one see the inputs they saw before it. The
    kernels are random, so not symmetric: a D in another bin order than the
    spectra's would show. "bf16x3" under the FP32 bar, "bf16" under
    ``close_bf16_2d``. No other 2D kernel may launch. Returns the rows' max
    abs errors."""
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import functional as F

    name = f"{'B5' if v3 else 'B2'} {mode}"
    route = 3 if v3 else 1  # the route's counter in COUNTERS_2D
    plain = fused2d._fused2d_forward_reference_v3 if v3 else fused2d._fused2d_forward_reference
    launcher = fused2d._launch_fused2d_v3 if v3 else fused2d._launch_fused2d
    bars = (2.5e-2, 2e-3) if mode == "bf16" else (1.2e-4, 2e-5)

    def rose(before):
        launched = [now - was for now, was in zip(counts_2d(), before)]
        check(all(n == 0 for i, n in enumerate(launched) if i != route),
              f"{name}: launched {dict(zip(COUNTERS_2D, launched))}")
        return launched[route]

    def close(y, x, wt, groups, what):
        """(max abs err, mean abs err, sigma, error ratio or None) of y
        against the plain version of ``mode`` on x and wt."""
        y_ref = plain(x, wt, groups, mode=mode)
        if mode == "bf16x3":
            return (*close_scaled(y, y_ref, what), None)
        exact = plain(x.double(), wt.double(), groups)
        return close_bf16_2d(y, y_ref, exact, what)

    def launch(x, wt, groups):
        cout, cpg, k1, k2 = wt.shape
        plan = fused2d.tile_plan_2d(k1, k2, cpg, cout)
        spectra = fused2d.kernel_spectra_2d(wt, plan[0], plan[2], plan[3])
        return launcher(x, spectra, plan, groups, (k1, k2), mode), plan

    def vs_plain(x, wt, groups, what):
        before = counts_2d()
        y, plan = launch(x, wt, groups)
        torch.cuda.synchronize()
        launched = rose(before)
        check(launched >= 1, f"{name} {what}: the route did not launch")
        mx, mean, sigma, ratio = close(y, x, wt, groups, f"{name} vs plain, {what}")
        b, cin, h, w = x.shape
        cout, _, k1, k2 = wt.shape
        ntiles = math.prod(fused2d._tiling(plan, h, w, k1, k2)[2:])
        geometry = fused2d._tc_geometry(b, cin, cout, groups, plan, ntiles)
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": name, "case": what,
                          "plan": dict(zip(("T1", "V1", "NB1", "T2", "V2"), plan)),
                          "geometry": dict(zip(("tiles_a_launch", "units_a_mac_block",
                                                "out_channels_a_mac_block"), geometry)),
                          "launches": launched, "max_abs_err": mx, "mean_abs_err": mean,
                          "sigma": sigma, "bar_max": bars[0] * sigma,
                          "bar_mean": bars[1] * sigma, "err_ratio_vs_float64": ratio}))
        return mx

    gen = torch.Generator().manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to("cuda")

    def kernel(*shape):
        return randn(*shape) / math.prod(shape[1:]) ** 0.5

    errs = [vs_plain(x, wt, 1, f"K={wt.shape[-1]}") for x, wt, _, _ in inputs]
    x, wt, bias, plan = inputs[0]
    vs_plain(x, wt[:, :4].contiguous(), 2, "groups=2")
    vs_plain(randn(2, 8, 300, 280), randn(8, 8, 70, 5) / 60.0, 1, "T1=256, K=(70, 5)")
    vs_plain(randn(1, 4, 420, 150), randn(4, 4, 200, 9) / 85.0, 1, "T1=384, K=(200, 9)")
    vs_plain(randn(2, 8, 200, 400), randn(8, 8, 12, 100) / 100.0, 1, "T2=256, K=(12, 100)")
    vs_plain(randn(2, 4, 200, 300), randn(6, 2, 12, 100) / 50.0, 2,
             "T2=256, K=(12, 100), groups=2")
    vs_plain(randn(2, 6, 300, 290), kernel(6, 2, 16, 16), 3, "Cout=6 in 3 groups (2 a group)")
    vs_plain(randn(2, 4, 300, 290), kernel(4, 1, 16, 16), 4, "groups=Cin=Cout=4 (1 a group)")
    vs_plain(randn(3, 8, 512, 512), kernel(8, 8, 16, 16), 1, "B=3, 512 x 512, K=16: 75 units")
    vs_plain(randn(2, 24, 200, 210), kernel(24, 8, 9, 9), 3, "Cin=Cout=24, groups=3")
    vs_plain(randn(1, 15, 200, 210), kernel(15, 15, 9, 9), 1,
             "Cin=Cout=15: 4 channel chunks, 2 output-channel passes")
    vs_plain(randn(1, 1, 300, 290), kernel(100, 1, 16, 16), 1,
             "Cin=1, Cout=100: 2 output-channel blocks")

    kw = dict(padding=5, padding_mode="reflect", stride=(2, 3), dilation=2)
    was = fused2d._PRECISION_2D, fused2d._KERNEL2D_VERSION
    try:
        fused2d.set_fused2d_precision(mode)
        fused2d.set_fused2d_kernel("v3" if v3 else "v2")
        before = counts_2d()
        y = fused2d.fft_conv2d_fused(x, wt, bias, **kw)
        torch.cuda.synchronize()
        check(rose(before) == 1, f"{name}: fft_conv2d_fused did not launch it")
    finally:
        fused2d.set_fused2d_precision(was[0])
        fused2d.set_fused2d_kernel(was[1])
    xp = F._pad_signal(x, (5, 5), "reflect")
    wd = F._dilate_kernel(wt, (2, 2))
    y_ref = plain(xp, wd, mode=mode)[:, :, ::2, ::3]
    y_out = y - bias.reshape(1, -1, 1, 1)
    if mode == "bf16x3":
        mx = close_scaled(y_out, y_ref, f"{name} stride/dilation/reflect")[0]
    else:
        exact = plain(xp.double(), wd.double())[:, :, ::2, ::3]
        mx = close_bf16_2d(y_out, y_ref, exact, f"{name} stride/dilation/reflect")[0]
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": name,
                      "case": "stride=(2, 3), dilation=2, reflect padding 5",
                      "max_abs_err": mx}))

    budget = fused2d._SCRATCH_BUDGET
    try:
        # four tiles of D, two of D and Y
        fused2d._SCRATCH_BUDGET = 4 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 8)
        before = counts_2d()
        y, _ = launch(x, wt, 1)
        split = rose(before)
    finally:
        fused2d._SCRATCH_BUDGET = budget
    check(split == 13, f"{name}: 25 tiles ran in {split} tile ranges, not 13 of 2")
    mx = close(y, x, wt, 1, f"{name} in tile ranges")[0]
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": name,
                      "case": f"{split} tile ranges", "max_abs_err": mx}))
    torch.cuda.synchronize()
    return errs


def main_path_precision_2d(torch, inputs, mode, v3=False):
    """B2's main paths (``v3``: B5's, under set_fused2d_kernel("v3")) under
    ``set_fused2d_precision(mode)`` ("bf16x3" or "bf16"), counted from zero:
    fft_conv(x, w, bias) (impl="auto") at the two 2D rows, a tier-1 plan of
    each (ops.plan_fft_conv), the transposed call fft_conv_transpose(x, w,
    bias) on each row's signal, and FFTConv2d(8, 8, 16) forward. Each
    launches the schedule's tensor-core route once and no other 2D kernel,
    and is held to the composed path in float64: "bf16x3" under the FP32
    bar, "bf16" under the JAX package's serving bar (err_mean < 5e-3 *
    sigma, err_max < 5e-2 * sigma). Returns the tensor-core launches."""
    from fft_conv_tpu_torch import FFTConv2d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    def held(y, y_ref, what):
        if mode == "bf16x3":
            mx, mean, sigma = close_scaled(y, y_ref, what)
        else:
            err = (y.detach().double() - y_ref).abs()
            sigma = max(1.0, float(y_ref.std()))
            mean, mx = float(err.mean()), float(err.max())
            check(mean < 5e-3 * sigma and mx < 5e-2 * sigma,
                  f"{what}: err_mean {mean:.3e}, err_max {mx:.3e} past the serving bar at "
                  f"sigma {sigma:.3f}")
        return mean / sigma, mx / sigma

    route = 3 if v3 else 1  # the route's counter in COUNTERS_2D
    want = tuple(int(i == route) for i in range(len(COUNTERS_2D)))
    kernel = "B5" if v3 else "B2"

    def drive(fn, ref, what):
        before = counts_2d()
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        rose = tuple(now - was for now, was in zip(counts_2d(), before))
        check(rose == want, f"{what} under {mode!r} launched {dict(zip(COUNTERS_2D, rose))}")
        mean, mx = held(y, ref(), what)
        print(json.dumps({"phase": "main_path_precision", "kernel": kernel, "mode": mode,
                          "case": what, COUNTERS_2D[route]: rose[route],
                          "err_mean_vs_float64": mean, "err_max_vs_float64": mx}))

    fused2d.set_fused2d_precision(mode)
    fused2d.set_fused2d_kernel("v3" if v3 else "v2")
    for counter in COUNTERS_2D:
        setattr(fused2d, counter, 0)
    layer = FFTConv2d(8, 8, 16, device="cuda", generator=torch.Generator().manual_seed(0))
    for (b, cin, cout, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_2D, inputs):
        x64, w64, b64 = x.double(), wt.double(), bias.double()
        planned = plan_fft_conv(wt, bias, signal_spatial=(h, w))
        drive(lambda: fft_conv(x, wt, bias), lambda: fft_conv(x64, w64, b64, impl="xla"),
              f"fft_conv auto 2D K={k}")
        drive(lambda: planned(x), lambda: fft_conv(x64, w64, b64, impl="xla"), f"plan 2D K={k}")
        drive(lambda: fft_conv_transpose(x, wt, bias),
              lambda: fft_conv_transpose(x64, w64, b64, impl="xla"),
              f"fft_conv_transpose 2D K={k}")
    x = inputs[0][0]
    drive(lambda: layer(x), lambda: fft_conv(x.double(), layer.weight.double(),
                                             layer.bias.double(), impl="xla"),
          "FFTConv2d(8, 8, 16)")
    torch.cuda.synchronize()
    launched = counts_2d()
    fused2d.set_fused2d_kernel("v2")
    check(all(n == 0 for i, n in enumerate(launched) if i != route),
          f"another 2D kernel than {kernel}'s route ran under {mode!r}: {launched}")
    return launched[route]


def phase_precision_2d(torch, inputs, rows):
    """Phase 5d: B2's and B5's precision modes, phase 5c's 2D counterpart.
    Under "bf16x3" and "bf16" each schedule's tensor-core route (B2's, and
    B5's under set_fused2d_kernel("v3")) against its plain version at
    check_fused2d's cases (check_fused2d_tc) and the main paths of
    main_path_precision_2d (counted from zero); at the 2D rows, for each
    schedule, the errors of fft_conv under the three modes against the
    composed path in float64, ordered "highest" < "bf16x3" < "bf16" with
    err_mean at least 4x and then 50x the one before (the CPU tests measure
    about 37x and 670x), "bf16" inside the serving bar; then each schedule's
    three modes timed side by side at each row: the kernels' device time and
    call latency, each kernel apart (profiler: the FP32 pair's two, or the
    tensor-core route's three: phase 1, the MAC stage, the inverse stage),
    fft_conv and the plan, the plain version, and the bound
    (``costs.fused2d_work`` for "highest"; otherwise ``costs.mode_bound``,
    the lesser of that and ``costs.fused2d_tc_work`` of the route with the
    products at the bf16 rate). "highest" and "v2" are restored at the end.
    Returns {"B2_<mode>" or "B5_<mode>": (launches, kernel-vs-plain errors,
    timing rows)} for the bf16 modes."""
    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.kernels.costs import bound, fused2d_tc_work, fused2d_work, mode_bound
    from fft_conv_tpu_torch.ops import plan_fft_conv

    t0 = time.perf_counter()
    out = {}
    schedules = (("B2", False), ("B5", True))
    try:
        for mode in fused2d.PRECISION_MODES[1:]:
            for name, v3 in schedules:
                fused2d.set_fused2d_precision("highest")
                errs = check_fused2d_tc(torch, inputs, mode, v3)
                launched = main_path_precision_2d(torch, inputs, mode, v3)
                print(json.dumps({"phase": "main_path_counts",
                                  "kernels": f"{name} tensor-core route", "mode": mode,
                                  COUNTERS_2D[3 if v3 else 1]: launched}))
                out[f"{name}_{mode}"] = (launched, errs, [])
        for name, v3 in schedules:
            fused2d.set_fused2d_kernel("v3" if v3 else "v2")
            for (b, cin, cout, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_2D, inputs):
                ref = fft_conv(x.double(), wt.double(), bias.double(), impl="xla")
                sigma = max(1.0, float(ref.std()))
                order, worst = [], []
                for mode in fused2d.PRECISION_MODES:
                    fused2d.set_fused2d_precision(mode)
                    err = (fft_conv(x, wt, bias).double() - ref).abs()
                    order.append(float(err.mean()) / sigma)
                    worst.append(float(err.max()) / sigma)
                print(json.dumps({"phase": "precision_order", "kernel": name, "K": k,
                                  "err_mean_vs_float64": dict(zip(fused2d.PRECISION_MODES, order)),
                                  "err_max_vs_float64": dict(zip(fused2d.PRECISION_MODES, worst))}))
                check(4 * order[0] < order[1] and 50 * order[1] < order[2],
                      f"{name} 2D K={k}: the modes' errors against float64 are not ordered: "
                      f"{order}")
                check(order[2] < 5e-3 and worst[2] < 5e-2,
                      f"{name} 2D K={k}: 'bf16' past the serving bar: {order[2]}, {worst[2]}")
        for (b, cin, cout, h, w, k), (x, wt, _, plan), base in zip(BENCH_SHAPES_2D, inputs, rows):
            t1, _, nb1, t2, _ = plan
            spectra = fused2d.kernel_spectra_2d(wt, t1, nb1, t2)
            planes = fused2d._planes(spectra)
            planned = plan_fft_conv(wt, signal_spatial=(h, w))
            for name, v3 in schedules:
                fused2d.set_fused2d_kernel("v3" if v3 else "v2")
                plain = (fused2d._fused2d_forward_reference_v3 if v3
                         else fused2d._fused2d_forward_reference)
                for mode in fused2d.PRECISION_MODES:
                    fused2d.set_fused2d_precision(mode)

                    def kernel():
                        if v3 and mode == "highest":
                            return fused2d._launch_fused2d_v3(x, planes, plan, 1, (k, k))
                        launch = fused2d._launch_fused2d_v3 if v3 else fused2d._launch_fused2d
                        return launch(x, spectra, plan, 1, (k, k), mode)

                    def auto():
                        return fft_conv(x, wt, impl="auto")

                    (nbytes, flops), bf16_flops = fused2d_work(b, cin, cout, h, w, k, plan), 0
                    bound_ms, bound_by = bound(nbytes, flops)
                    if mode != "highest":
                        bound_ms, bound_by, (nbytes, flops, bf16_flops) = mode_bound(
                            (nbytes, flops),
                            fused2d_tc_work(b, cin, cout, h, w, k, plan, mode, v3=v3))
                    row = {
                        "mode": mode, "K": k, "plan": list(plan),
                        "ms": device_ms(kernel), "call_ms": call_ms(kernel),
                        "phase_ms": phase_split_ms(torch, kernel, "fused2d_"),
                        "auto_ms": device_ms(auto), "plan_ms": device_ms(lambda: planned(x)),
                        "plain_ms": call_ms(lambda: plain(x, wt, mode=mode)),
                        "library_ms": base["library_ms"], "composed_ms": base["composed_ms"],
                        "bytes": nbytes, "flops": flops, "bf16_flops": bf16_flops,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                    }
                    if mode != "highest":
                        entry = out[f"{name}_{mode}"]
                        entry[2].append({**row, "max_abs_err": entry[1][len(entry[2])]})
                    print(json.dumps({"phase": "timing_precision", "kernel": name, **row}))
                    torch.cuda.synchronize()
    finally:
        fused2d.set_fused2d_precision("highest")
        fused2d.set_fused2d_kernel("v2")
    print(json.dumps({"phase": "precision_2d", "seconds": time.perf_counter() - t0}))
    return out


def check_fused3d_tc(torch, inputs3d, inputs3t, mode):
    """B3's and B4's tensor-core chains under ``mode`` ("bf16x3" or "bf16")
    against their plain versions of that mode (``_fused3d_forward_reference``
    / ``_fused3d_tap_reference``, ``mode=``) at the 3D rows (B3: 64^3 and
    48^3 K=8; B4: K=10) and around them: the dense H step at H = 12 and 13
    (odd), the stuffed 78^3 (Hw 78 = 13 x 6, two W blocks) and 82^3 (Hw 84 =
    7 x 12) volumes of the transposed rows, H = 256, groups = 2 and 3 (4, 2
    and 1 output channels a block of d_mac_tc), a group of 24 channels
    staged in 3 chunks, odd D and OD, "pk" (B6's layout), the items split
    over several launches, and the new blocking's edges: H = 48 (8 x 6) at a
    small volume, 6 output channels (2 a block), one (item, D-block) pair
    (fewer than d_mac_tc's warps). The extra cases draw from a generator of
    their own. "bf16x3" under the FP32 bar, "bf16" under ``close_bf16_2d``.
    Returns the rows' max abs errors, (B3's, B4's)."""
    from fft_conv_tpu_torch.kernels import fused3d

    gen = torch.Generator().manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to("cuda")

    def vs_plain(x, wt, groups, what, packed=False):
        k = tuple(wt.shape[2:])
        hw = fused3d._h_work(x.shape[3])[0]
        tap = fused3d._plan_for(x.shape, wt.shape, groups)[0][0] == "tap"
        name = f"{'B4' if tap else 'B3'} {mode}"
        counters = ("launches", "launches_tap", "launches_tc", "launches_tap_tc")
        before = [getattr(fused3d, c) for c in counters]
        if tap:
            y = fused3d._launch_fused3d_tap(x, fused3d.kernel_spectra_tap(wt, hw), groups, k,
                                            mode)
            ref = fused3d._fused3d_tap_reference
        else:
            y = fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(wt, hw), groups, k, packed,
                                        mode)
            ref = fused3d._fused3d_forward_reference
        torch.cuda.synchronize()
        rose = [getattr(fused3d, c) - b for c, b in zip(counters, before)]
        check(rose[:2] == [0, 0] and rose[3 if tap else 2] >= 1,
              f"{name} {what}: launched (B3, B4, B3 tc, B4 tc) {rose}")
        y_ref = ref(x, wt, groups, mode=mode)
        if mode == "bf16x3":
            mx, mean, sigma = close_scaled(y, y_ref, f"{name} vs plain, {what}")
            ratio = None
        else:
            exact = ref(x.double(), wt.double(), groups)
            mx, mean, sigma, ratio = close_bf16_2d(y, y_ref, exact, f"{name} vs plain, {what}")
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": name, "case": what,
                          "hw": hw, "split": list(fused3d._h_steps(x.shape[3])),
                          "launches": max(rose[2:]), "max_abs_err": mx, "mean_abs_err": mean,
                          "sigma": sigma, "err_ratio_vs_float64": ratio}))
        return mx

    errs3 = [vs_plain(x, wt, 1, f"{x.shape[3]}^3 K={wt.shape[-1]}") for x, wt, _, _ in inputs3d]
    errs4 = [vs_plain(x, wt, 1, f"{x.shape[3]}^3 K={wt.shape[-1]}") for x, wt, _, _ in inputs3t]
    x, wt = inputs3d[0][:2]
    vs_plain(x, wt, 1, "64^3 K=8 under 'pk'", packed=True)
    vs_plain(x, wt[:, :4].contiguous(), 2, "64^3 K=8, groups=2")
    # the twin of tests/test_torch_cuda.py:TC_3D: a case added to one
    # belongs in the other
    for shape, k, groups, what in [
        ((2, 4, 14, 12, 20), (4, 4, 3, 3, 3), 1, "H=12 (one dense step)"),
        ((1, 6, 13, 13, 30), (6, 2, 4, 3, 5), 3, "H=13 (odd, dense), groups=3, D=13"),
        ((2, 8, 78, 78, 78), (8, 8, 8, 8, 8), 1, "stuffed 78^3, K=8, 2 W blocks"),
        ((1, 2, 10, 256, 20), (2, 2, 3, 3, 3), 1, "H=256 (16 x 16)"),
        ((2, 24, 20, 8, 20), (24, 24, 3, 3, 3), 1, "Cin = Cout = 24: 3 staged chunks"),
        ((1, 2, 11, 37, 45), (3, 2, 3, 5, 7), 1, "H=37 padded to 40, OD 9"),
        ((2, 8, 82, 82, 82), (8, 8, 10, 10, 10), 1, "stuffed 82^3, K=10 (Hw 84), 2 W blocks"),
        ((2, 4, 24, 12, 20), (4, 4, 12, 3, 7), 1, "tap H=12 (one dense step)"),
        ((1, 6, 21, 26, 12), (6, 2, 10, 3, 3), 3, "tap H=26 (13 x 2), groups=3"),
        ((2, 4, 18, 48, 48), (4, 4, 8, 8, 8), 1, "H=48 (8 x 6)"),
        ((1, 4, 16, 20, 20), (6, 4, 3, 3, 3), 1, "Cout 6: 2 output channels a block"),
        ((1, 2, 10, 64, 20), (2, 2, 3, 3, 3), 1, "one (item, D-block) pair at H=64"),
    ]:
        vs_plain(randn(*shape), randn(*k) / math.sqrt(math.prod(k[1:])), groups, what)

    budget = fused3d._SCRATCH_BUDGET
    try:
        fused3d._SCRATCH_BUDGET = fused3d._scratch_bytes_per_item(8, 8, 64, 33, 8, 57)
        vs_plain(x, wt, 1, "64^3 K=8 in 2 item ranges")
    finally:
        fused3d._SCRATCH_BUDGET = budget
    return errs3, errs4


def main_path_precision_3d(torch, inputs3d, inputs3t, t_inputs, mode):
    """B3's and B4's main paths under ``set_fused3d_precision(mode)``
    ("bf16x3" or "bf16"), counted from zero: fft_conv(x, w, bias)
    (impl="auto") and a tier-1 plan (ops.plan_fft_conv) at the four 3D rows,
    the transposed calls fft_conv_transpose(impl="fused") at 64^3 K=8 (B3)
    and K=10 (B4), FFTConv3d(8, 8, 8) and FFTConvTranspose3d(8, 8, 8,
    impl="fused") forward, and fft_conv at 64^3 K=8 under "pk" (B6, then B3)
    and under inline (B7, then B3). Each launches one tensor-core chain once
    and no FP32 chain, and is held to the composed path in float64:
    "bf16x3" under the FP32 bar, "bf16" under the JAX package's serving bar.
    Returns the tensor-core launches (B3's, B4's)."""
    from fft_conv_tpu_torch import FFTConv3d, FFTConvTranspose3d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    counters = ("launches", "launches_tap", "launches_tc", "launches_tap_tc")

    def drive(fn, ref, what, tap):
        before = [getattr(fused3d, c) for c in counters]
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        rose = [getattr(fused3d, c) - b for c, b in zip(counters, before)]
        want = [0, 0, 0, 1] if tap else [0, 0, 1, 0]
        check(rose == want, f"{what} under {mode!r} launched (B3, B4, B3 tc, B4 tc) {rose}")
        y_ref = ref()
        if mode == "bf16x3":
            mx, mean, sigma = close_scaled(y, y_ref, what)
        else:
            err = (y.detach().double() - y_ref).abs()
            sigma = max(1.0, float(y_ref.std()))
            mean, mx = float(err.mean()), float(err.max())
            check(mean < 5e-3 * sigma and mx < 5e-2 * sigma,
                  f"{what}: err_mean {mean:.3e}, err_max {mx:.3e} past the serving bar at "
                  f"sigma {sigma:.3f}")
        print(json.dumps({"phase": "main_path_precision", "mode": mode, "case": what,
                          "launches": dict(zip(counters, rose)),
                          "err_mean_vs_float64": mean / sigma, "err_max_vs_float64": mx / sigma}))

    fused3d.set_fused3d_precision(mode)
    for c in counters:
        setattr(fused3d, c, 0)
    rows = [(s, i, False) for s, i in zip(BENCH_SHAPES_3D, inputs3d)]
    rows += [(s, i, True) for s, i in zip(BENCH_SHAPES_3D_TAP, inputs3t)]
    for (b, cin, cout, d, h, w, k), (x, wt, bias, _), tap in rows:
        x64, w64, b64 = x.double(), wt.double(), bias.double()
        planned = plan_fft_conv(wt, bias, signal_spatial=(d, h, w))
        drive(lambda: fft_conv(x, wt, bias), lambda: fft_conv(x64, w64, b64, impl="xla"),
              f"fft_conv auto {h}^3 K={k}", tap)
        drive(lambda: planned(x), lambda: fft_conv(x64, w64, b64, impl="xla"),
              f"plan {h}^3 K={k}", tap)
    x, wt, bias = inputs3d[0][:3]
    x64 = x.double()
    for k, wt_t, bias_t, plan, _ in t_inputs:
        drive(lambda: fft_conv_transpose(x, wt_t, bias_t, impl="fused"),
              lambda: fft_conv_transpose(x64, wt_t.double(), bias_t.double(), impl="xla"),
              f"fft_conv_transpose(impl='fused') 64^3 K={k}", plan[0] == "tap")
    layer = FFTConv3d(8, 8, 8, device="cuda", generator=torch.Generator().manual_seed(0))
    drive(lambda: layer(x), lambda: fft_conv(x64, layer.weight.double(), layer.bias.double(),
                                             impl="xla"), "FFTConv3d(8, 8, 8)", False)
    tlayer = FFTConvTranspose3d(8, 8, 8, impl="fused", device="cuda",
                                generator=torch.Generator().manual_seed(0))
    drive(lambda: tlayer(x), lambda: fft_conv_transpose(
        x64, tlayer.weight.double(), tlayer.bias.double(), impl="xla"),
        "FFTConvTranspose3d(8, 8, 8, impl='fused')", False)
    for name, on, off in (("'pk'", lambda: fused3d.set_fused3d_xpack("pk"),
                           lambda: fused3d.set_fused3d_xpack("h2")),
                          ("inline", lambda: fused3d.set_fused3d_inline(True),
                           lambda: fused3d.set_fused3d_inline(False))):
        on()
        try:
            drive(lambda: fft_conv(x, wt, bias),
                  lambda: fft_conv(x64, wt.double(), bias.double(), impl="xla"),
                  f"fft_conv auto 64^3 K=8 under {name}", False)
        finally:
            off()
    torch.cuda.synchronize()
    check(fused3d.launches == 0 and fused3d.launches_tap == 0,
          f"an FP32 chain of B3 or B4 ran under {mode!r}")
    return fused3d.launches_tc, fused3d.launches_tap_tc


def phase_precision_3d(torch, inputs3d, inputs3t, t_inputs, rows3d, rows3t):
    """Phase 5e: B3's and B4's precision modes, phase 5d's 3D counterpart.
    Under "bf16x3" and "bf16" the tensor-core chains against their plain
    versions (check_fused3d_tc) and the main paths of main_path_precision_3d
    (counted from zero); the errors of the three modes against the composed
    path in float64 at the 3D rows (64^3 K=8 and K=10, 48^3 K=8 and K=10),
    the transposed calls at 64^3 (the stuffed 78^3 and 82^3, Hw 84) and
    the 64^3 K=8 call under "pk", ordered "highest" < "bf16x3" < "bf16"
    with err_mean at least 4x and then 50x the one before (the CPU tests
    measure about 40x and 600x), "bf16" inside the serving bar; then the
    three modes timed side by side at the four rows: the chain's device
    time and call latency, its three kernels (profiler), fft_conv and the
    plan, the plain version, and the bound (``costs.fused3d_work`` /
    ``fused3d_tap_work`` for "highest"; otherwise ``costs.mode_bound``, the
    lesser of that and the tensor-core route's least work,
    ``costs.fused3d_tc_work`` / ``fused3d_tap_tc_work`` with ``least=True``
    and the products at the bf16 rate).
    "highest" is restored at the end. Returns {mode: ((B3's launches,
    errors, timing rows), (B4's ...))} for the bf16 modes."""
    from fft_conv_tpu_torch import fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.kernels.costs import (bound, fused3d_tap_tc_work, fused3d_tap_work,
                                                  fused3d_tc_work, fused3d_work, mode_bound)
    from fft_conv_tpu_torch.ops import plan_fft_conv

    t0 = time.perf_counter()
    out = {}
    try:
        for mode in fused3d.PRECISION_MODES[1:]:
            fused3d.set_fused3d_precision("highest")
            errs3, errs4 = check_fused3d_tc(torch, inputs3d, inputs3t, mode)
            n3, n4 = main_path_precision_3d(torch, inputs3d, inputs3t, t_inputs, mode)
            print(json.dumps({"phase": "main_path_counts", "kernels": "B3, B4 tensor-core chains",
                              "mode": mode, "launches_tc": n3, "launches_tap_tc": n4}))
            out[mode] = ((n3, errs3, []), (n4, errs4, []))
        x0 = inputs3d[0][0]
        calls = [(f"{x.shape[3]}^3 K={wt.shape[-1]}",
                  lambda x=x, wt=wt, bias=bias: fft_conv(x, wt, bias),
                  lambda x=x, wt=wt, bias=bias: fft_conv(
                      x.double(), wt.double(), bias.double(), impl="xla"))
                 for x, wt, bias, _ in inputs3d + inputs3t]
        calls += [(f"transposed 64^3 K={k}",
                   lambda wt=wt, bias=bias: fft_conv_transpose(x0, wt, bias, impl="fused"),
                   lambda wt=wt, bias=bias: fft_conv_transpose(
                       x0.double(), wt.double(), bias.double(), impl="xla"))
                  for k, wt, bias, _, _ in t_inputs]
        x, wt, bias = inputs3d[0][:3]
        calls.append(("64^3 K=8 under 'pk'", lambda: fft_conv(x, wt, bias),
                      lambda: fft_conv(x.double(), wt.double(), bias.double(), impl="xla")))
        for what, fn, exact in calls:
            ref = exact()
            sigma = max(1.0, float(ref.std()))
            order, worst = [], []
            for mode in fused3d.PRECISION_MODES:
                fused3d.set_fused3d_precision(mode)
                if "'pk'" in what:
                    fused3d.set_fused3d_xpack("pk")
                try:
                    err = (fn().double() - ref).abs()
                finally:
                    fused3d.set_fused3d_xpack("h2")
                order.append(float(err.mean()) / sigma)
                worst.append(float(err.max()) / sigma)
            print(json.dumps({"phase": "precision_order", "kernel": "B3/B4", "case": what,
                              "err_mean_vs_float64": dict(zip(fused3d.PRECISION_MODES, order)),
                              "err_max_vs_float64": dict(zip(fused3d.PRECISION_MODES, worst))}))
            check(4 * order[0] < order[1] and 50 * order[1] < order[2],
                  f"3D {what}: the modes' errors against float64 are not ordered: {order}")
            check(order[2] < 5e-3 and worst[2] < 5e-2,
                  f"3D {what}: 'bf16' past the serving bar: {order[2]}, {worst[2]}")
        rows = [(s, i, base, False) for s, i, base in zip(BENCH_SHAPES_3D, inputs3d, rows3d)]
        rows += [(s, i, base, True) for s, i, base in zip(BENCH_SHAPES_3D_TAP, inputs3t, rows3t)]
        for (b, cin, cout, d, h, w, k), (x, wt, _, plan), base, tap in rows:
            hw = fused3d._h_work(h)[0]
            spectra = (fused3d.kernel_spectra_tap if tap else fused3d.kernel_spectra_3d)(wt, hw)
            planned = plan_fft_conv(wt, signal_spatial=(d, h, w))
            name = "B4" if tap else "B3"
            for mode in fused3d.PRECISION_MODES:
                fused3d.set_fused3d_precision(mode)

                def kernel():
                    if tap:
                        return fused3d._launch_fused3d_tap(x, spectra, 1, (k, k, k), mode)
                    return fused3d._launch_fused3d(x, spectra, 1, (k, k, k), mode=mode)

                def plain():
                    ref = fused3d._fused3d_tap_reference if tap else \
                        fused3d._fused3d_forward_reference
                    return ref(x, wt, mode=mode)

                shape = (b, cin, cout, d, h, w, k)
                nbytes, flops = (fused3d_tap_work if tap else fused3d_work)(*shape)
                bf16_flops = 0
                bound_ms, bound_by = bound(nbytes, flops)
                if mode != "highest":
                    bound_ms, bound_by, (nbytes, flops, bf16_flops) = mode_bound(
                        (nbytes, flops), (fused3d_tap_tc_work if tap else fused3d_tc_work)(
                            *shape, mode, least=True))
                row = {
                    "mode": mode, "K": k, "dhw": [d, h, w], "hw": hw,
                    "split": list(fused3d._h_steps(h)),
                    "ms": device_ms(kernel), "call_ms": call_ms(kernel),
                    "phase_ms": phase_split_ms(torch, kernel, "fused3d_"),
                    "auto_ms": device_ms(lambda: fft_conv(x, wt, impl="auto")),
                    "plan_ms": device_ms(lambda: planned(x)),
                    "plain_ms": call_ms(plain),
                    "library_ms": base["library_ms"], "composed_ms": base["composed_ms"],
                    "bytes": nbytes, "flops": flops, "bf16_flops": bf16_flops,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                if mode != "highest":
                    entry = out[mode][1 if tap else 0]
                    entry[2].append({**row, "max_abs_err": entry[1][len(entry[2])]})
                print(json.dumps({"phase": "timing_precision", "kernel": name, **row}))
                torch.cuda.synchronize()
    finally:
        fused3d.set_fused3d_precision("highest")
        fused3d.set_fused3d_xpack("h2")
    print(json.dumps({"phase": "precision_3d", "seconds": time.perf_counter() - t0}))
    return out


def check_fused2d(torch, dev, gen):
    """B2 against its plain version on the card at the 2D benchmark rows,
    with groups=2, at every other plan tile_plan_2d admits (T1 = 256 with
    K1 = 70, T1 = 384 with K1 = 200, T2 = 256 with K2 = 100, alone and with
    groups=2), through fft_conv2d_fused's argument surface, and with the
    tiles split over several launches. Returns the rows' inputs and their
    max abs errors."""
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import functional as F

    lib = fused2d._library()
    for t1 in (128, 256, 384):
        for t2 in (128, 256):
            smem = lib.fused2d_smem_bytes(t1, t2)
            check(smem == fused2d._smem_bytes(t1 // 2 + 1, t2),
                  f"tile plan's shared memory at T1={t1}, T2={t2} differs from the "
                  f"kernel's {smem}")

    def vs_plain(x, wt, groups, what, **extra):
        cout, cpg, k1, k2 = wt.shape
        plan = fused2d.tile_plan_2d(k1, k2, cpg, cout)
        spectra = fused2d.kernel_spectra_2d(wt, plan[0], plan[2], plan[3])
        before = fused2d.launches, fused2d.launches_v3
        y = fused2d._launch_fused2d(x, spectra, plan, groups, (k1, k2))
        torch.cuda.synchronize()
        launched = fused2d.launches - before[0], fused2d.launches_v3 - before[1]
        check(launched[0] >= 1 and launched[1] == 0, f"B2 {what}: launched (B2, B5) {launched}")
        mx, mean, sigma = close_scaled(
            y, fused2d._fused2d_forward_reference(x, wt, groups), f"B2 vs plain, {what}")
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B2", "case": what,
                          "plan": dict(zip(("T1", "V1", "NB1", "T2", "V2"), plan)),
                          "launches": launched[0], "max_abs_err": mx, "mean_abs_err": mean,
                          "sigma": sigma, "bar_max": 1.2e-4 * sigma, "bar_mean": 2e-5 * sigma,
                          **extra}))
        return mx

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    inputs, errs = [], []
    for b, cin, cout, h, w, k in BENCH_SHAPES_2D:
        x = randn(b, cin, h, w)
        wt = randn(cout, cin, k, k) / (cin * k * k) ** 0.5
        bias = randn(cout)
        plan = fused2d.tile_plan_2d(k, k, cin, cout)
        check(plan is not None and fused2d.fused2d_fits(k, k, cin, cout, (h, w), batch=b),
              f"no fused 2D plan at K={k}")
        inputs.append((x, wt, bias, plan))
        errs.append(vs_plain(x, wt, 1, f"K={k}"))

    x, wt, bias, plan = inputs[0]
    k = wt.shape[-1]
    vs_plain(x, wt[:, :4].contiguous(), 2, "groups=2")
    vs_plain(randn(2, 8, 300, 280), randn(8, 8, 70, 5) / 60.0, 1, "T1=256, K=(70, 5)")
    vs_plain(randn(1, 4, 420, 150), randn(4, 4, 200, 9) / 85.0, 1, "T1=384, K=(200, 9)")
    vs_plain(randn(2, 8, 200, 400), randn(8, 8, 12, 100) / 100.0, 1, "T2=256, K=(12, 100)")
    vs_plain(randn(2, 4, 200, 300), randn(6, 2, 12, 100) / 50.0, 2,
             "T2=256, K=(12, 100), groups=2")

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
    from fft_conv_tpu_torch.kernels.costs import (
        bound, fused2d_dense_work, fused2d_kernel_flops, fused2d_work)
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    rows = []
    for (b, cin, cout, h, w, k), (x, wt, _, plan), err, nl in zip(
        BENCH_SHAPES_2D, inputs, errs, per_row
    ):
        t1, _, nb1, t2, _ = plan
        spectra = fused2d.kernel_spectra_2d(wt, t1, nb1, t2)
        planned = plan_fft_conv(wt, signal_spatial=(h, w))

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
            # B2's two kernels, one by one (device time per call)
            "phase_ms": phase_split_ms(torch, kernel, "fused2d_"),
            "spectra_ms": device_ms(lambda: fused2d.kernel_spectra_2d(wt, t1, nb1, t2)),
            "auto_ms": device_ms(auto),
            "auto_call_ms": call_ms(auto),
            "plan_ms": device_ms(lambda: planned(x)),
            "plan_call_ms": call_ms(lambda: planned(x)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            "plain_ms": call_ms(lambda: fused2d._fused2d_forward_reference(x, wt)),
            "library_ms": device_ms(lambda: TF.conv2d(x, wt)),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_flops": fused2d_kernel_flops(b, cin, cout, h, w, k, plan),
            # the bound of PR 7's count, every DFT a dense product
            "dense_bound_ms": bound(*fused2d_dense_work(b, cin, cout, h, w, k, plan))[0],
        }
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        rows.append(row)
        print(json.dumps({"phase": "timing", "kernel": "B2", **row}))
        torch.cuda.synchronize()
    return rows


def check_fused2d_v3(torch, dev, gen, inputs):
    """B5 against its plain version on the card at the 2D benchmark rows
    (B2's inputs), with groups=2, at a T1 = 256 (K1 = 70), a T1 = 384 (K1 =
    200) and a T2 = 256 (K2 = 100) plan, and with the tiles split over
    several launches. Returns the rows' max abs errors."""
    from fft_conv_tpu_torch.kernels import fused2d

    lib = fused2d._library()
    for t1 in (128, 256, 384):
        for t2 in (128, 256):
            smem = lib.fused2d_v3_smem_bytes(t1, t2)
            check(smem == fused2d._smem_bytes_v3(t1 // 2 + 1, t2),
                  f"B5's shared memory at T1={t1}, T2={t2} differs from the kernel's {smem}")

    def vs_plain(x, wt, groups, what, **extra):
        cout, cpg, k1, k2 = wt.shape
        plan = fused2d.tile_plan_2d(k1, k2, cpg, cout)
        spectra = fused2d.kernel_spectra_2d_planes(wt, plan[0], plan[2], plan[3])
        before = fused2d.launches, fused2d.launches_v3
        y = fused2d._launch_fused2d_v3(x, spectra, plan, groups, (k1, k2))
        torch.cuda.synchronize()
        launched = fused2d.launches - before[0], fused2d.launches_v3 - before[1]
        check(launched[0] == 0 and launched[1] >= 1, f"B5 {what}: launched (B2, B5) {launched}")
        mx, mean, sigma = close_scaled(
            y, fused2d._fused2d_forward_reference_v3(x, wt, groups), f"B5 vs plain, {what}")
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B5", "case": what,
                          "plan": dict(zip(("T1", "V1", "NB1", "T2", "V2"), plan)),
                          "launches": launched[1], "max_abs_err": mx, "mean_abs_err": mean,
                          "sigma": sigma, "bar_max": 1.2e-4 * sigma, "bar_mean": 2e-5 * sigma,
                          **extra}))
        return mx

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    errs = [vs_plain(x, wt, 1, f"K={wt.shape[-1]}") for x, wt, _, _ in inputs]
    x, wt, _, plan = inputs[0]
    vs_plain(x, wt[:, :4].contiguous(), 2, "groups=2")
    vs_plain(randn(2, 8, 300, 280), randn(8, 8, 70, 5) / 60.0, 1, "T1=256, K=(70, 5)")
    vs_plain(randn(1, 4, 420, 150), randn(4, 4, 200, 9) / 85.0, 1, "T1=384, K=(200, 9)")
    vs_plain(randn(2, 8, 200, 400), randn(8, 8, 12, 100) / 100.0, 1, "T2=256, K=(12, 100)")
    budget = fused2d._SCRATCH_BUDGET
    try:
        fused2d._SCRATCH_BUDGET = 4 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 8)
        vs_plain(x, wt, 1, "tile ranges of 4 tiles")
    finally:
        fused2d._SCRATCH_BUDGET = budget
    torch.cuda.synchronize()
    return errs


def main_path_2d_v3(torch, inputs):
    """Under set_fused2d_kernel("v3"), counted from zero: fft_conv(impl=
    "auto") at both 2D rows and FFTConv2d(8, 8, 16) forward and backward
    launch B5 and not B2. Returns (B5 launches per row, total)."""
    from fft_conv_tpu_torch import FFTConv2d, fft_conv
    from fft_conv_tpu_torch.kernels import fused2d

    def counts():
        torch.cuda.synchronize()
        return fused2d.launches, fused2d.launches_v3

    fused2d.set_fused2d_kernel("v3")
    try:
        fused2d.launches = fused2d.launches_v3 = 0
        per_row = []
        for (b, cin, cout, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_2D, inputs):
            before = counts()
            y = fft_conv(x, wt, bias, impl="auto")
            rose = tuple(a - c for a, c in zip(counts(), before))
            check(rose[0] == 0 and rose[1] >= 1,
                  f"fft_conv(impl='auto') under v3 at K={k} launched (B2, B5) {rose}")
            per_row.append(rose[1])
            mx, mean, _ = close_scaled(y, fft_conv(x, wt, bias, impl="xla"),
                                       f"2D auto under v3 vs xla K={k}")
            print(json.dumps({"phase": "main_path", "kernel": "B5", "K": k, "launches": rose[1],
                              "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

        layer = FFTConv2d(8, 8, 16, device="cuda", generator=torch.Generator().manual_seed(0))
        x = inputs[0][0].clone().requires_grad_()
        before = counts()
        y = layer(x)
        y.sum().backward()
        rose = tuple(a - c for a, c in zip(counts(), before))
        check(rose[0] == 0 and rose[1] >= 1, f"FFTConv2d under v3 launched (B2, B5) {rose}")
        w_ref = layer.weight.detach().clone().requires_grad_()
        x_ref = inputs[0][0].clone().requires_grad_()
        y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
        y_ref.sum().backward()
        close_scaled(y, y_ref, "FFTConv2d under v3 forward vs xla")
        gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConv2d v3 weight grad")
        gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "FFTConv2d v3 input grad")
        launched = counts()
        print(json.dumps({"phase": "module", "kernel": "B5", "launches": rose[1],
                          "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))
        print(json.dumps({"phase": "main_path_counts", "kernels": "B2, B5 under v3",
                          "launches": launched[0], "launches_v3": launched[1]}))
    finally:
        fused2d.set_fused2d_kernel("v2")
    return per_row, launched[1]


def main_path_transposed(torch, inputs1d, inputs2d):
    """The repaired transposed routes, counted from zero: the default call
    fft_conv_transpose(x, w, bias) on the 1D rows' signals (B1) and on the 2D
    rows' (B2, and B5 under "v3"), and FFTConvTranspose1d(8, 8, 1024) and
    FFTConvTranspose2d(8, 8, 16) with their default impl forward and
    backward (B2, then B5 under "v3"), each held to impl="xla". The weights
    are the forward rows' (8 -> 8, so (Cin, Cout, K) has their shape)."""
    from fft_conv_tpu_torch import FFTConvTranspose1d, FFTConvTranspose2d, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused1d, fused2d

    def counts():
        torch.cuda.synchronize()
        return fused1d.launches, fused2d.launches, fused2d.launches_v3

    def drive(x, wt, bias, want, what):
        before = counts()
        y = fft_conv_transpose(x, wt, bias)
        rose = tuple(a - c for a, c in zip(counts(), before))
        check([r > 0 for r in rose] == want, f"{what} launched (B1, B2, B5) {rose}")
        mx, mean, _ = close_scaled(y, fft_conv_transpose(x, wt, bias, impl="xla"), what)
        print(json.dumps({"phase": "main_path", "case": what, "launches": rose,
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

    def layer_pass(layer, x, want, what):
        xg = x.clone().requires_grad_()
        before = counts()
        y = layer(xg)
        y.sum().backward()
        rose = tuple(a - c for a, c in zip(counts(), before))
        check(layer.impl == "auto" and [r > 0 for r in rose] == want,
              f"{what} (impl={layer.impl!r}) launched (B1, B2, B5) {rose}")
        w_ref = layer.weight.detach().clone().requires_grad_()
        x_ref = x.clone().requires_grad_()
        y_ref = fft_conv_transpose(x_ref, w_ref, layer.bias.detach(), impl="xla")
        y_ref.sum().backward()
        close_scaled(y, y_ref, f"{what} forward vs xla")
        gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, f"{what} weight grad")
        gx_err, _, _ = close_scaled(xg.grad, x_ref.grad, f"{what} input grad")
        print(json.dumps({"phase": "module", "case": what, "launches": rose,
                          "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))

    fused1d.launches = fused2d.launches = fused2d.launches_v3 = 0
    for x, wt, bias, _ in inputs1d:
        drive(x, wt, bias, [True, False, False],
              f"fft_conv_transpose 1D L={x.shape[-1]} K={wt.shape[-1]}")
    for x, wt, bias, _ in inputs2d:
        drive(x, wt, bias, [False, True, False], f"fft_conv_transpose 2D K={wt.shape[-1]}")
    gen = torch.Generator().manual_seed(0)
    layer_pass(FFTConvTranspose1d(8, 8, 1024, device="cuda", generator=gen), inputs1d[1][0],
               [True, False, False], "FFTConvTranspose1d(8, 8, 1024)")
    layer2 = FFTConvTranspose2d(8, 8, 16, device="cuda", generator=gen)
    layer_pass(layer2, inputs2d[0][0], [False, True, False], "FFTConvTranspose2d(8, 8, 16)")
    fused2d.set_fused2d_kernel("v3")
    try:
        for x, wt, bias, _ in inputs2d:
            drive(x, wt, bias, [False, False, True],
                  f"fft_conv_transpose 2D K={wt.shape[-1]} under v3")
        layer2.weight.grad = layer2.bias.grad = None
        layer_pass(layer2, inputs2d[0][0], [False, False, True],
                   "FFTConvTranspose2d(8, 8, 16) under v3")
    finally:
        fused2d.set_fused2d_kernel("v2")
    launched = counts()
    print(json.dumps({"phase": "main_path_counts", "kernels": "B1, B2, B5 (transposed)",
                      "launches": dict(zip(("B1", "B2", "B5"), launched))}))


def time_2d_v3(torch, inputs, errs, per_row):
    """The timing rows of B5 at the 2D benchmark shapes, taken beside B2's
    (time_2d) in the same run: `auto_*` under set_fused2d_kernel("v3")."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels.costs import (
        bound, fused2d_dense_work, fused2d_v3_kernel_flops, fused2d_work)
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    rows = []
    for (b, cin, cout, h, w, k), (x, wt, _, plan), err, nl in zip(
        BENCH_SHAPES_2D, inputs, errs, per_row
    ):
        t1, _, nb1, t2, _ = plan
        spectra = fused2d.kernel_spectra_2d_planes(wt, t1, nb1, t2)
        planned = plan_fft_conv(wt, signal_spatial=(h, w))

        def kernel():
            return fused2d._launch_fused2d_v3(x, spectra, plan, 1, (k, k))

        def auto():
            return fft_conv(x, wt, impl="auto")

        def composed():
            return fft_conv(x, wt, impl="xla")

        # the least work of the function B5 computes, as B2's bound
        nbytes, flops = fused2d_work(b, cin, cout, h, w, k, plan)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {
            "K": k, "plan": list(plan), "launches": nl, "max_abs_err": err,
            "ms": device_ms(kernel),
            "call_ms": call_ms(kernel),
            "spectra_ms": device_ms(lambda: fused2d.kernel_spectra_2d_planes(wt, t1, nb1, t2)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            "plain_ms": call_ms(lambda: fused2d._fused2d_forward_reference_v3(x, wt)),
            "library_ms": device_ms(lambda: TF.conv2d(x, wt)),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_flops": fused2d_v3_kernel_flops(b, cin, cout, h, w, k, plan),
            # the bound of the dense count, every DFT a dense product
            "dense_bound_ms": bound(*fused2d_dense_work(b, cin, cout, h, w, k, plan))[0],
            # B5's two kernels, one by one (device time per call)
            "phase_ms": phase_split_ms(torch, kernel, "fused2d_v3_"),
        }
        fused2d.set_fused2d_kernel("v3")
        try:
            row["auto_ms"] = device_ms(auto)
            row["auto_call_ms"] = call_ms(auto)
            row["plan_ms"] = device_ms(lambda: planned(x))
            row["plan_call_ms"] = call_ms(lambda: planned(x))
        finally:
            fused2d.set_fused2d_kernel("v2")
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        rows.append(row)
        print(json.dumps({"phase": "timing", "kernel": "B5", **row}))
        torch.cuda.synchronize()
    return rows


def time_transposed_1d_2d(torch, inputs1d, inputs2d):
    """The repaired transposed routes at the 1D and 2D benchmark rows
    (stride 1): the fused route's device time and call latency
    (`fused_ms`, `fused_call_ms`; in 2D also under "v3", `fused_v3_ms`)
    against the composed path's."""
    from fft_conv_tpu_torch import fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused2d
    from fft_conv_tpu_torch.ops import plan_fft_conv_transpose

    for x, wt, bias, _ in list(inputs1d) + list(inputs2d):
        def fused():
            return fft_conv_transpose(x, wt, bias, impl="fused")

        def composed():
            return fft_conv_transpose(x, wt, bias, impl="xla")

        planned = plan_fft_conv_transpose(wt, bias, signal_spatial=x.shape[2:],
                                          max_batch=x.shape[0])
        row = {
            "shape": list(x.shape), "K": wt.shape[-1],
            "fused_ms": device_ms(fused),
            "fused_call_ms": call_ms(fused),
            "plan_ms": device_ms(lambda: planned(x)),
            "plan_call_ms": call_ms(lambda: planned(x)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
        }
        if x.ndim == 4:
            fused2d.set_fused2d_kernel("v3")
            try:
                row["fused_v3_ms"] = device_ms(fused)
            finally:
                fused2d.set_fused2d_kernel("v2")
        print(json.dumps({"phase": "timing", "kernel": "B1" if x.ndim == 3 else "B2",
                          "case": f"fft_conv_transpose {x.ndim - 2}D", **row}))
        torch.cuda.synchronize()


def check_fused3d(torch, dev, gen):
    """B3 against its plain version on the card at the 3D benchmark rows (64^3
    and 48^3), with groups=2, at odd sizes with KD=9 (the hop edge), through
    fft_conv3d_fused's argument surface (stride, dilation, reflect padding),
    with W cut into 4 overlap-save blocks, at H = 12, 300 and 454 (4, 2 and 1
    slabs a block of the dense H/W kernels, outside 16 to 256), at the
    stuffed 78^3 volume of the transposed K=8 call, at the factored H/W
    kernels' other H (FACTORED_3D: the constant splits, a case per radix of
    the kernel that takes its split as arguments, padded H) with odd D and
    odd OD, at a clamped third W block, with the items split over several
    launches, and at the D kernel's edges (D_EDGES_3D). Each case prints
    which H/W kernels it ran and at which working length. Returns the rows'
    inputs and their max abs errors."""
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.ops import functional as F

    lib = fused3d._library()
    for nbh in (10, 33, 113, 114, 227, 228, 454, 455):
        smem = lib.fused3d_smem_bytes(nbh)
        check(smem == fused3d._smem_bytes(nbh),
              f"plan's shared memory at NBH={nbh} differs from the kernel's {smem}")

    def vs_plain(x, wt, groups, what, **extra):
        k = tuple(wt.shape[2:])
        hw = fused3d._h_work(x.shape[3])[0]
        y = fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(wt, hw), groups, k)
        torch.cuda.synchronize()
        mx, mean, sigma = close_scaled(y, fused3d._fused3d_forward_reference(x, wt, groups),
                                       f"B3 vs plain, {what}")
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B3", "case": what,
                          "h_path": fused3d._h_path(x.shape[3]), "hw": hw,
                          "max_abs_err": mx, "mean_abs_err": mean, "sigma": sigma,
                          "bar_max": 1.2e-4 * sigma, "bar_mean": 2e-5 * sigma, **extra}))
        return mx

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    inputs, errs = [], []
    for b, cin, cout, d, h, w, k in BENCH_SHAPES_3D:
        x = randn(b, cin, d, h, w)
        wt = randn(cout, cin, k, k, k) / (cin * k ** 3) ** 0.5
        bias = randn(cout)
        blocked = fused3d.plan_3d_blocked(cin, cout, d, h, w, k, k, k)
        check(blocked is not None and blocked[0][0] == "v4" and blocked[1] == 1,
              f"no single-block v4 plan at 64^3 K={k}: {blocked}")
        inputs.append((x, wt, bias, blocked[0]))
        errs.append(vs_plain(x, wt, 1, f"K={k}", plan=list(blocked[0])))

    x, wt, bias, _ = inputs[0]
    vs_plain(x, wt[:, :4].contiguous(), 2, "groups=2")
    vs_plain(randn(2, 8, 41, 37, 45), randn(8, 8, 9, 5, 7) / 50.0, 1,
             "D, H, W = 41, 37, 45, K = (9, 5, 7)")
    vs_plain(randn(2, 8, 24, 32, 200), randn(8, 8, 3, 5, 7) / 20.0, 1,
             "W=200 in 4 W blocks")
    # the dense H/W kernels, at H outside 16 to 256: each slab count (SB = 4
    # at H = 12, 2 and 1 here); then the stuffed volume of the transposed K=8
    # call (Hw = 78 = 13 x 6, NBH 40, 2 W blocks)
    vs_plain(randn(2, 4, 14, 12, 20), randn(4, 4, 3, 3, 3) / 10.0, 1, "H=12 (dense, SB=4)")
    vs_plain(randn(1, 2, 12, 300, 64), randn(2, 2, 3, 3, 3) / 5.0, 1,
             "H=300 (dense, NBH 151, SB=2)")
    vs_plain(randn(1, 2, 12, 454, 64), randn(2, 2, 3, 3, 3) / 5.0, 1,
             "H=454 (dense, NBH 228, SB=1)")
    vs_plain(randn(2, 8, 78, 78, 78), wt, 1, "stuffed 78^3, K=8, 2 W blocks")
    # the factored H/W kernels at their other H, a last slab paired with
    # zeros in the forward (odd D), the inverse (odd OD) or both; then the D
    # kernel's edges: a group staged in 3 chunks, KD close to D
    for shape, k, groups, what in FACTORED_3D + D_EDGES_3D:
        vs_plain(randn(*shape), randn(*k) / math.sqrt(math.prod(k[1:])), groups, what)

    xs, ws = randn(2, 8, 40, 36, 44), randn(8, 8, 3, 3, 3) / 15.0
    kw = dict(padding=3, padding_mode="reflect", stride=(2, 1, 3), dilation=2)
    y = fused3d.fft_conv3d_fused(xs, ws, bias, **kw)
    xp = F._pad_signal(xs, (3, 3, 3), "reflect")
    y_ref = fused3d._fused3d_forward_reference(xp, F._dilate_kernel(ws, (2, 2, 2)))
    y_ref = y_ref[:, :, ::2, ::1, ::3] + bias.reshape(1, -1, 1, 1, 1)
    mx, _, _ = close_scaled(y, y_ref, "B3 stride/dilation/reflect")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B3",
                      "case": "stride=(2, 1, 3), dilation=2, reflect padding 3",
                      "max_abs_err": mx}))

    budget = fused3d._SCRATCH_BUDGET
    plan = inputs[0][3]
    try:
        fused3d._SCRATCH_BUDGET = fused3d._scratch_bytes_per_item(8, 8, 64, plan[1], plan[4], 57)
        before = fused3d.launches
        y = fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(wt, 64), 1, (8, 8, 8))
        split = fused3d.launches - before
    finally:
        fused3d._SCRATCH_BUDGET = budget
    check(split > 1, "the item ranges did not split")
    mx, _, _ = close_scaled(y, fused3d._fused3d_forward_reference(x, wt), "B3 in item ranges")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B3",
                      "case": f"{split} item ranges", "max_abs_err": mx}))
    torch.cuda.synchronize()
    return inputs, errs


def main_path_3d(torch, inputs):
    """fft_conv(impl="auto") at the 3D row and FFTConv3d(8, 8, 8) forward and
    backward, counted from zero; then a KD=11 call must launch B4, not B3.
    Returns (launches per row, total)."""
    from fft_conv_tpu_torch import FFTConv3d, fft_conv
    from fft_conv_tpu_torch.kernels import fused3d

    fused3d.launches = 0
    per_row = []
    for (b, cin, cout, d, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_3D, inputs):
        before = fused3d.launches
        y = fft_conv(x, wt, bias, impl="auto")
        torch.cuda.synchronize()
        rose = fused3d.launches - before
        check(rose == 1, f"fft_conv(impl='auto') at 64^3 K={k} launched B3 {rose} times")
        per_row.append(rose)
        mx, mean, _ = close_scaled(y, fft_conv(x, wt, bias, impl="xla"), f"3D auto vs xla K={k}")
        print(json.dumps({"phase": "main_path", "kernel": "B3", "K": k, "launches": rose,
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

    layer = FFTConv3d(8, 8, 8, device="cuda", generator=torch.Generator().manual_seed(0))
    x = inputs[0][0].clone().requires_grad_()
    before = fused3d.launches
    y = layer(x)
    y.sum().backward()
    torch.cuda.synchronize()
    layer_launches = fused3d.launches - before
    check(layer_launches >= 1, "FFTConv3d did not launch B3")
    w_ref = layer.weight.detach().clone().requires_grad_()
    x_ref = inputs[0][0].clone().requires_grad_()
    y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
    y_ref.sum().backward()
    close_scaled(y, y_ref, "FFTConv3d forward vs xla")
    gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConv3d weight grad vs xla")
    gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "FFTConv3d input grad vs xla")
    total = fused3d.launches
    print(json.dumps({"phase": "module", "kernel": "B3", "launches": layer_launches,
                      "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))

    xt = torch.ones(1, 2, 30, 16, 12, device="cuda")
    before = fused3d.launches_tap
    y = fft_conv(xt, torch.ones(2, 2, 11, 3, 3, device="cuda"), impl="fused")
    torch.cuda.synchronize()
    check(fused3d.launches_tap == before + 1, "a KD=11 fused call did not launch B4")
    check(fused3d.launches == total, "the KD=11 call launched B3")
    err = float((y - 2 * 11 * 3 * 3).abs().max())
    check(err < 1e-3, f"the KD=11 call of ones is off by {err}")
    print(json.dumps({"phase": "tap_route", "case": "KD=11 impl='fused'",
                      "launches_tap": 1, "max_abs_err": err}))
    torch.cuda.synchronize()
    return per_row, total


def profile_ms(torch, fn, group, reps=GRAPH_REPS, count=False):
    """Device time per call of fn() summed by group(kernel name), from
    torch.profiler's CUDA activity over ``reps`` calls of fn() (after one
    warm-up call); kernels whose group is None are left out, and the result
    is {} when the profiler records no device time. ``count``: launches
    per call in place of the time. Every caller's fn() launches kernels of
    the group, so a trace in which the group is empty is taken again, up to
    PROFILE_TRIES times in all: on the H100 one such trace was followed by
    full ones of the same calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    split = {}
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total", 0) or getattr(evt, "cuda_time_total", 0)
            cuda = evt.device_type == torch.autograd.DeviceType.CUDA
            name = group(evt.key) if us and cuda else None
            if name is not None:
                split[name] = split.get(name, 0.0) + (evt.count if count else us / 1e3) / reps
        if split:
            break
    return split


def phase_split_ms(torch, fn, prefix, reps=GRAPH_REPS, count=False):
    """Device time (``count``: launches) per call of each kernel whose name
    holds ``prefix``, named by what follows the prefix (``profile_ms``)."""
    return profile_ms(
        torch, fn,
        lambda key: key.split(prefix, 1)[1].split("<")[0].split("(")[0] if prefix in key else None,
        reps, count)


def d_stage(torch, phase_ms, name, work, kernel, chain):
    """The D kernel's time beside its stage's bound (T and the spectra in,
    Z out; flops from kernels/costs.py), and the launches of one call of
    ``kernel`` by kernel name: one each of hw_forward, ``name`` and
    hw_inverse (factored or dense), three in all. The profiler may drop an
    event of the GRAPH_REPS calls, so each count is rounded."""
    from fft_conv_tpu_torch.kernels.costs import bound

    per_call = phase_split_ms(torch, kernel, "fused3d_", count=True)
    check(len(per_call) == 3 and all(round(n) == 1 for n in per_call.values())
          and name in per_call and any(k.startswith("hw_forward") for k in per_call)
          and any(k.startswith("hw_inverse") for k in per_call),
          f"{chain}: not three launches a call of hw_forward, {name}, hw_inverse: {per_call}")
    ms, by = bound(*work)
    return {"kernel": name, "ms": phase_ms.get(name), "bytes": work[0], "flops": work[1],
            "bound_ms": ms, "bound_by": by, "launches_per_call": per_call}


def hw_pair(phase_ms, work):
    """The H/W kernels' share of a chain's phase_ms (hw_forward and
    hw_inverse, factored or dense) beside their stage's bound (the signal
    and T, Z and the output, once each; kernels/costs.py:
    fused3d_hw_work)."""
    from fft_conv_tpu_torch.kernels.costs import bound

    ms, by = bound(*work)
    pair = sum(v for k, v in phase_ms.items() if k.startswith("hw_"))
    return {"ms": pair, "bytes": work[0], "flops": work[1], "bound_ms": ms, "bound_by": by}


def time_3d(torch, inputs, errs, per_row):
    """The timing row of the 3D benchmark shape (see phase 5 of main)."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels.costs import (
        bound, fused3d_hw_work, fused3d_d_work, fused3d_kernel_flops, fused3d_work)
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    rows = []
    for (b, cin, cout, d, h, w, k), (x, wt, _, plan), err, nl in zip(
        BENCH_SHAPES_3D, inputs, errs, per_row
    ):
        hw = fused3d._h_work(h)[0]
        spectra = fused3d.kernel_spectra_3d(wt, hw)
        planned = plan_fft_conv(wt, signal_spatial=(d, h, w))

        def kernel():
            return fused3d._launch_fused3d(x, spectra, 1, (k, k, k))

        def auto():
            return fft_conv(x, wt, impl="auto")

        def composed():
            return fft_conv(x, wt, impl="xla")

        nbytes, flops = fused3d_work(b, cin, cout, d, h, w, k)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {
            "K": k, "dhw": [d, h, w], "hw": hw, "h_path": fused3d._h_path(h),
            "plan": list(plan), "launches": nl, "max_abs_err": err,
            "ms": device_ms(kernel),
            "call_ms": call_ms(kernel),
            "spectra_ms": device_ms(lambda: fused3d.kernel_spectra_3d(wt, hw)),
            "auto_ms": device_ms(auto),
            "auto_call_ms": call_ms(auto),
            "plan_ms": device_ms(lambda: planned(x)),
            "plan_call_ms": call_ms(lambda: planned(x)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            "plain_ms": call_ms(lambda: fused3d._fused3d_forward_reference(x, wt)),
            "library_ms": device_ms(lambda: TF.conv3d(x, wt)),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_flops": fused3d_kernel_flops(b, cin, cout, d, h, w, k),
            # the bound with every transform a dense product
            "dense_bound_ms": bound(*fused3d_work(b, cin, cout, d, h, w, k, dense=True))[0],
            # B3's three kernels, one by one (device time per call)
            "phase_ms": phase_split_ms(torch, kernel, "fused3d_"),
        }
        row["d_stage"] = d_stage(torch, row["phase_ms"], "d_mac",
                                 fused3d_d_work(b, cin, cout, d, h, w, k), kernel, "B3")
        # the same calls with B6 packing the signal ahead of B3
        fused3d.set_fused3d_xpack("pk")
        try:
            row["auto_pk_ms"] = device_ms(auto)
            row["auto_pk_call_ms"] = call_ms(auto)
            row["plan_pk_ms"] = device_ms(lambda: planned(x))
            row["phase_pk_ms"] = phase_split_ms(torch, auto, "fused3d_")
        finally:
            fused3d.set_fused3d_xpack("h2")
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        row["hw_pair"] = hw_pair(row["phase_ms"], fused3d_hw_work(b, cin, cout, d, h, w, k))
        rows.append(row)
        print(json.dumps({"phase": "timing", "kernel": "B3", **row}))
        torch.cuda.synchronize()
    return rows


def check_fused3d_tap(torch, dev, gen):
    """B4 against its plain version on the card at the B4 rows (64^3, 48^3),
    with groups=2, at odd sizes with KD=11 and an odd H, with W cut into 4
    overlap-save blocks at KD=12, through fft_conv3d_fused's argument surface
    (stride, dilation 2 taking K=6 to 11, reflect padding), at 64^3 K=11 (a plan the
    JAX package refuses), at H = 10, 300 and 454 (4, 2 and 1 slabs a block
    of the dense H/W kernels), at the stuffed 82^3 volume of the transposed
    K=10 call (padded to Hw = 84), at the factored H/W kernels' other H
    (FACTORED_3D_TAP) with odd D or odd OD and at a clamped third W block,
    at the D kernel's edges (D_EDGES_3D_TAP) and with the items split over
    several launches. Returns the rows' inputs and their max abs errors."""
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.ops import functional as F

    def vs_plain(x, wt, groups, what, **extra):
        k = tuple(wt.shape[2:])
        hw = fused3d._h_work(x.shape[3])[0]
        before = fused3d.launches_tap
        y = fused3d._launch_fused3d_tap(x, fused3d.kernel_spectra_tap(wt, hw), groups, k)
        torch.cuda.synchronize()
        check(fused3d.launches_tap == before + 1, f"B4 {what}: not one launch")
        mx, mean, sigma = close_scaled(y, fused3d._fused3d_tap_reference(x, wt, groups),
                                       f"B4 vs plain, {what}")
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B4", "case": what,
                          "h_path": fused3d._h_path(x.shape[3]), "hw": hw, "max_abs_err": mx,
                          "mean_abs_err": mean, "sigma": sigma,
                          "bar_max": 1.2e-4 * sigma, "bar_mean": 2e-5 * sigma, **extra}))
        return mx

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    inputs, errs = [], []
    for b, cin, cout, d, h, w, k in BENCH_SHAPES_3D_TAP:
        x = randn(b, cin, d, h, w)
        wt = randn(cout, cin, k, k, k) / (cin * k ** 3) ** 0.5
        bias = randn(cout)
        blocked = fused3d.plan_3d_blocked(cin, cout, d, h, w, k, k, k)
        check(blocked is not None and blocked[0][0] == "tap" and blocked[1] == 1,
              f"no single-block tap plan at 64^3 K={k}: {blocked}")
        inputs.append((x, wt, bias, blocked[0]))
        errs.append(vs_plain(x, wt, 1, f"K={k}", plan=list(blocked[0])))

    x, wt, bias, _ = inputs[0]
    vs_plain(x, wt[:, :4].contiguous(), 2, "groups=2")
    vs_plain(randn(2, 8, 41, 37, 45), randn(8, 8, 11, 5, 7) / 60.0, 1,
             "D, H, W = 41, 37, 45, K = (11, 5, 7)")
    vs_plain(randn(2, 8, 24, 32, 200), randn(8, 8, 12, 5, 7) / 60.0, 1,
             "W=200 in 4 W blocks, KD=12")
    w11 = randn(8, 8, 11, 11, 11) / (8 * 11 ** 3) ** 0.5
    vs_plain(x, w11, 1, "64^3 K=11", plan=list(fused3d.plan_3d(8, 8, 64, 64, 64, 11, 11, 11)))
    vs_plain(randn(2, 4, 20, 10, 12), randn(4, 4, 10, 3, 3) / 10.0, 1, "H=10 (dense, SB=4)")
    vs_plain(randn(1, 2, 16, 300, 64), randn(2, 2, 10, 3, 5) / 8.0, 1,
             "H=300 (dense, NBH 151, SB=2)")
    vs_plain(randn(1, 2, 14, 454, 64), randn(2, 2, 10, 3, 3) / 8.0, 1,
             "H=454 (dense, NBH 228, SB=1)")
    vs_plain(randn(2, 8, 82, 82, 82), wt, 1, "stuffed 82^3, K=10, Hw=84, 2 W blocks")
    for shape, k, groups, what in FACTORED_3D_TAP + D_EDGES_3D_TAP:
        vs_plain(randn(*shape), randn(*k) / math.sqrt(math.prod(k[1:])), groups, what)

    xs, ws = randn(2, 8, 40, 36, 44), randn(8, 8, 6, 3, 3) / 20.0
    kw = dict(padding=3, padding_mode="reflect", stride=(2, 1, 3), dilation=2)
    before = fused3d.launches_tap
    y = fused3d.fft_conv3d_fused(xs, ws, bias, **kw)
    check(fused3d.launches_tap == before + 1, "the dilated KD=11 call did not launch B4")
    xp = F._pad_signal(xs, (3, 3, 3), "reflect")
    y_ref = fused3d._fused3d_tap_reference(xp, F._dilate_kernel(ws, (2, 2, 2)))
    y_ref = y_ref[:, :, ::2, ::1, ::3] + bias.reshape(1, -1, 1, 1, 1)
    mx, _, _ = close_scaled(y, y_ref, "B4 stride/dilation/reflect")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B4",
                      "case": "stride=(2, 1, 3), dilation=2 (K=6 -> 11), reflect padding 3",
                      "max_abs_err": mx}))

    budget = fused3d._SCRATCH_BUDGET
    try:
        fused3d._SCRATCH_BUDGET = fused3d._tap_scratch_bytes_per_item(8, 8, 64, 33, 55)
        before = fused3d.launches_tap
        y = fused3d._launch_fused3d_tap(x, fused3d.kernel_spectra_tap(wt, 64), 1, (10, 10, 10))
        split = fused3d.launches_tap - before
    finally:
        fused3d._SCRATCH_BUDGET = budget
    check(split > 1, "the item ranges did not split")
    mx, _, _ = close_scaled(y, fused3d._fused3d_tap_reference(x, wt), "B4 in item ranges")
    print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B4",
                      "case": f"{split} item ranges", "max_abs_err": mx}))
    torch.cuda.synchronize()
    return inputs, errs


def main_path_3d_tap(torch, inputs):
    """The paths of B4, counted from zero: fft_conv(impl="auto") at the B4
    row, FFTConv3d(8, 8, 10) forward and backward, fft_conv_transpose(...,
    impl="fused") at 64^3 with K=8 (B3, two W blocks) and K=10 (B4, two W
    blocks), and FFTConvTranspose3d(8, 8, 8, impl="fused") forward and
    backward. Returns (B4 launches per row, B4 total, the transposed inputs)."""
    from fft_conv_tpu_torch import FFTConv3d, FFTConvTranspose3d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused3d

    def counts():
        return fused3d.launches, fused3d.launches_tap

    def rose_by(before):
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(counts(), before))

    fused3d.launches = fused3d.launches_tap = 0
    per_row = []
    for (b, cin, cout, d, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_3D_TAP, inputs):
        before = counts()
        y = fft_conv(x, wt, bias, impl="auto")
        rose = rose_by(before)
        check(rose == (0, 1), f"fft_conv(impl='auto') at 64^3 K={k} launched (B3, B4) {rose}")
        per_row.append(rose[1])
        mx, mean, _ = close_scaled(y, fft_conv(x, wt, bias, impl="xla"), f"3D auto vs xla K={k}")
        print(json.dumps({"phase": "main_path", "kernel": "B4", "K": k, "launches": rose[1],
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

    x0 = inputs[0][0]
    layer = FFTConv3d(8, 8, 10, device="cuda", generator=torch.Generator().manual_seed(0))
    x = x0.clone().requires_grad_()
    before = counts()
    y = layer(x)
    y.sum().backward()
    rose = rose_by(before)
    check(rose == (0, 1), f"FFTConv3d(8, 8, 10) launched (B3, B4) {rose}")
    w_ref = layer.weight.detach().clone().requires_grad_()
    x_ref = x0.clone().requires_grad_()
    y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
    y_ref.sum().backward()
    close_scaled(y, y_ref, "FFTConv3d(K=10) forward vs xla")
    gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConv3d(K=10) weight grad")
    gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "FFTConv3d(K=10) input grad")
    print(json.dumps({"phase": "module", "kernel": "B4", "launches": rose[1],
                      "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))

    gen = torch.Generator().manual_seed(1)
    t_inputs = []
    for k in TRANSPOSED_3D_K:
        wt = (torch.randn(8, 8, k, k, k, generator=gen) / (8 * k ** 3) ** 0.5).to(x0.device)
        bias = torch.randn(8, generator=gen).to(x0.device)
        full = 63 + 2 * k - 1  # the stuffed volume
        plan, nwb, _ = fused3d.plan_3d_blocked(8, 8, full, full, full, k, k, k)
        want = (1, 0) if plan[0] == "v4" else (0, 1)
        before = counts()
        y = fft_conv_transpose(x0, wt, bias, impl="fused")
        rose = rose_by(before)
        check(nwb == 2 and rose == want,
              f"transposed K={k}: plan {plan}, {nwb} W blocks, launched (B3, B4) {rose}")
        mx, mean, _ = close_scaled(y, fft_conv_transpose(x0, wt, bias, impl="xla"),
                                   f"3D transposed fused vs xla K={k}")
        t_inputs.append((k, wt, bias, plan, nwb))
        print(json.dumps({"phase": "main_path", "kernel": "B3" if want[0] else "B4",
                          "case": f"fft_conv_transpose(impl='fused') 64^3 K={k}",
                          "plan": list(plan), "w_blocks": nwb, "launches": max(rose),
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

    layer = FFTConvTranspose3d(8, 8, 8, impl="fused", device="cuda",
                               generator=torch.Generator().manual_seed(0))
    x = x0.clone().requires_grad_()
    before = counts()
    y = layer(x)
    y.sum().backward()
    rose = rose_by(before)
    check(rose == (1, 0), f"FFTConvTranspose3d(8, 8, 8) launched (B3, B4) {rose}")
    w_ref = layer.weight.detach().clone().requires_grad_()
    x_ref = x0.clone().requires_grad_()
    y_ref = fft_conv_transpose(x_ref, w_ref, layer.bias.detach(), impl="xla")
    y_ref.sum().backward()
    close_scaled(y, y_ref, "FFTConvTranspose3d forward vs xla")
    gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConvTranspose3d weight grad")
    gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "FFTConvTranspose3d input grad")
    print(json.dumps({"phase": "module", "kernel": "B3",
                      "case": "FFTConvTranspose3d(8, 8, 8, impl='fused')", "launches": rose[0],
                      "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))
    launched = counts()
    print(json.dumps({"phase": "main_path_counts", "kernels": "B3, B4",
                      "launches": launched[0], "launches_tap": launched[1]}))
    torch.cuda.synchronize()
    return per_row, launched[1], t_inputs


def time_3d_tap(torch, inputs, errs, per_row):
    """The timing row of the B4 shape (see phase 5 of main)."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels.costs import (
        bound, fused3d_hw_work, fused3d_tap_kernel_flops, fused3d_tap_mac_work, fused3d_tap_work)
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    rows = []
    for (b, cin, cout, d, h, w, k), (x, wt, _, plan), err, nl in zip(
        BENCH_SHAPES_3D_TAP, inputs, errs, per_row
    ):
        hw = fused3d._h_work(h)[0]
        spectra = fused3d.kernel_spectra_tap(wt, hw)
        planned = plan_fft_conv(wt, signal_spatial=(d, h, w))

        def kernel():
            return fused3d._launch_fused3d_tap(x, spectra, 1, (k, k, k))

        def auto():
            return fft_conv(x, wt, impl="auto")

        def composed():
            return fft_conv(x, wt, impl="xla")

        nbytes, flops = fused3d_tap_work(b, cin, cout, d, h, w, k)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {
            "K": k, "dhw": [d, h, w], "hw": hw, "h_path": fused3d._h_path(h),
            "plan": list(plan), "launches": nl, "max_abs_err": err,
            "ms": device_ms(kernel),
            "call_ms": call_ms(kernel),
            "spectra_ms": device_ms(lambda: fused3d.kernel_spectra_tap(wt, hw)),
            "auto_ms": device_ms(auto),
            "auto_call_ms": call_ms(auto),
            "plan_ms": device_ms(lambda: planned(x)),
            "plan_call_ms": call_ms(lambda: planned(x)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            "plain_ms": call_ms(lambda: fused3d._fused3d_tap_reference(x, wt)),
            "library_ms": device_ms(lambda: TF.conv3d(x, wt)),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_flops": fused3d_tap_kernel_flops(b, cin, cout, d, h, w, k),
            # the bound with every transform a dense product
            "dense_bound_ms": bound(*fused3d_tap_work(b, cin, cout, d, h, w, k, dense=True))[0],
            # B4's three kernels, one by one (device time per call)
            "phase_ms": phase_split_ms(torch, kernel, "fused3d_"),
        }
        row["d_stage"] = d_stage(torch, row["phase_ms"], "tap_mac",
                                 fused3d_tap_mac_work(b, cin, cout, d, h, w, k), kernel, "B4")
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        row["hw_pair"] = hw_pair(row["phase_ms"], fused3d_hw_work(b, cin, cout, d, h, w, k))
        rows.append(row)
        print(json.dumps({"phase": "timing", "kernel": "B4", **row}))
        torch.cuda.synchronize()
    return rows


def time_transposed_3d(torch, x, t_inputs):
    """The transposed 3D calls at 64^3: the fused route's device time and
    call latency, the composed path's, and conv_transpose3d (TF32 off); the
    bound of the fused chain on the stuffed volume and its H/W kernels'
    share beside their stage's bound, and the working length they ran."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.kernels.costs import (
        bound, fused3d_hw_work, fused3d_tap_work, fused3d_work)
    from fft_conv_tpu_torch.ops import plan_fft_conv_transpose

    for k, wt, bias, plan, nwb in t_inputs:
        def fused():
            return fft_conv_transpose(x, wt, bias, impl="fused")

        def composed():
            return fft_conv_transpose(x, wt, bias, impl="xla")

        # the 3D transposed plan is the torch.fft tier, as auto is composed here
        planned = plan_fft_conv_transpose(wt, bias, signal_spatial=x.shape[2:])
        row = {
            "K": k, "plan": list(plan), "w_blocks": nwb,
            "fused_ms": device_ms(fused),
            "fused_call_ms": call_ms(fused),
            "plan_ms": device_ms(lambda: planned(x)),
            "plan_call_ms": call_ms(lambda: planned(x)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            "library_ms": device_ms(lambda: TF.conv_transpose3d(x, wt, bias)),
            # the kernel's own share of fused_ms; the rest is the wrapper's
            # stuffed signal, kernel spectra, crop and bias
            "phase_ms": phase_split_ms(torch, fused, "fused3d_"),
        }
        b, cin, full = x.shape[0], x.shape[1], x.shape[2] + 2 * (k - 1)
        cout = wt.shape[1]
        work = (fused3d_work if plan[0] == "v4" else fused3d_tap_work)(
            b, cin, cout, full, full, full, k)
        row.update({"stuffed": full, "hw": fused3d._h_work(full)[0],
                    "h_path": fused3d._h_path(full), "bytes": work[0], "flops": work[1]})
        row["bound_ms"], row["bound_by"] = bound(*work)
        row["hw_pair"] = hw_pair(row["phase_ms"],
                                 fused3d_hw_work(b, cin, cout, full, full, full, k))
        print(json.dumps({"phase": "timing", "kernel": "B3" if plan[0] == "v4" else "B4",
                          "case": "fft_conv_transpose 64^3", **row}))
        torch.cuda.synchronize()


def phase_inline(torch, gen, inputs3d, x_t, t_inputs):
    """Phase 5b, the inline spectra (``set_fused3d_inline(True)``): kernel
    B7 against its plain version at INLINE_HW (within 1e-5·max|ref|, and
    against the complex128 spectra); then, counted from zero, the main path
    under inline: fft_conv(impl="auto") at the 3D rows and
    fft_conv_transpose(impl="fused") at the K=8 transposed row, each held to
    the composed path, B7 once and B3 once a call; then B7's time beside the
    spectra it replaces (``kernel_spectra_3d``), one torch.fft.fftn call, its
    plain version and its bound, and each call's time with inline on and
    off. The switch is restored. Returns (B7 launches, errors, rows)."""
    from fft_conv_tpu_torch import fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.kernels.costs import bound, fused3d_spectra_work
    from fft_conv_tpu_torch.ops import functional as F

    errs = []
    for shape, hw, what in INLINE_HW:
        k = (torch.randn(*shape, generator=gen) / math.sqrt(math.prod(shape[1:]))).cuda()
        got = fused3d._launch_spectra_v4(k, hw)
        torch.cuda.synchronize()
        ref = fused3d._spectra_v4_reference(k, hw)
        oracle = fused3d.kernel_spectra_3d(k.double(), hw)
        mx = float((got - ref).abs().max())
        bar = 1e-5 * float(ref.abs().max())
        check(got.shape == ref.shape and bool(got.isfinite().all()) and mx <= bar,
              f"B7 vs plain, {what}: err_max {mx:.3e} > {bar:.3e}")
        mx_oracle = float((got.to(torch.complex128) - oracle).abs().max())
        check(mx_oracle <= 1e-5 * float(oracle.abs().max()),
              f"B7 vs complex128, {what}: err_max {mx_oracle:.3e}")
        errs.append(mx)
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B7", "case": what, "hw": hw,
                          "taps": list(shape), "max_abs_err": mx, "bar_max": bar,
                          "max_abs_err_vs_complex128": mx_oracle}))

    calls = []
    for (b, cin, cout, d, h, w, k), (x, wt, bias, _) in zip(BENCH_SHAPES_3D, inputs3d):
        calls.append((f"fft_conv(impl='auto') {d}^3 K={k}", wt, fused3d._h_work(h)[0],
                      functools.partial(fft_conv, x, wt, bias, impl="auto"),
                      functools.partial(fft_conv, x, wt, bias, impl="xla")))
    k, wt, bias, _, _ = t_inputs[0]
    full = x_t.shape[2] + 2 * (k - 1)
    # the transposed call's spectra: its kernel as the stuffed correlation takes it
    wt_corr = F._transpose_kernel_layout(wt, 1, (1, 1, 1))
    calls.append((f"fft_conv_transpose(impl='fused') {x_t.shape[2]}^3 K={k}", wt_corr,
                  fused3d._h_work(full)[0],
                  functools.partial(fft_conv_transpose, x_t, wt, bias, impl="fused"),
                  functools.partial(fft_conv_transpose, x_t, wt, bias, impl="xla")))

    fused3d.set_fused3d_inline(True)
    try:
        _reset_counts()
        for what, _, _, call, composed in calls:
            before = _counts(torch)
            y = call()
            rose = {n: v - before[n] for n, v in _counts(torch).items()}
            check(rose == {n: int(n in ("B3", "B7")) for n in KERNEL_NAMES},
                  f"inline {what} launched {rose}, not B7 and B3 once each")
            mx, mean, _ = close_scaled(y, composed(), f"inline {what} vs xla")
            print(json.dumps({"phase": "main_path", "kernel": "B7", "case": what,
                              "launches": rose["B7"], "launches_b3": rose["B3"],
                              "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))
        launched = _counts(torch)["B7"]
        print(json.dumps({"phase": "main_path_counts", "kernels": "B7 (inline)",
                          "launches": launched}))

        rows = []
        for what, wt, hw, call, _ in calls:
            nbytes, flops = fused3d_spectra_work(wt.shape[1], wt.shape[0], hw, wt.shape[2:])
            bound_ms, bound_by = bound(nbytes, flops)
            row = {
                "case": what, "hw": hw, "taps": list(wt.shape),
                "ms": device_ms(lambda: fused3d._launch_spectra_v4(wt, hw)),
                "spectra_ms": device_ms(lambda: fused3d.kernel_spectra_3d(wt, hw)),
                "library_ms": device_ms(lambda: torch.fft.fftn(wt, s=(16, hw, 64),
                                                               dim=(2, 3, 4))),
                "plain_ms": call_ms(lambda: fused3d._spectra_v4_reference(wt, hw)),
                "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
                "auto_inline_ms": device_ms(call),
                "auto_inline_call_ms": call_ms(call),
                "phase_inline_ms": phase_split_ms(torch, call, "fused3d_"),
            }
            row["inline_spectra_ms"] = row["ms"]
            row["spectra_library_ms"] = row["library_ms"]
            fused3d.set_fused3d_inline(False)
            try:
                row["auto_ms"] = device_ms(call)
                row["auto_call_ms"] = call_ms(call)
            finally:
                fused3d.set_fused3d_inline(True)
            rows.append(row)
            print(json.dumps({"phase": "timing", "kernel": "B7", **row}))
    finally:
        fused3d.set_fused3d_inline(False)
    check(not fused3d._INLINE3D, "the inline switch was not restored")
    torch.cuda.synchronize()
    return launched, errs, rows


def check_pack3d(torch, dev, gen, inputs3d):
    """B6 against its plain version, required equal, into an output filled
    with NaN first so that an unwritten element shows: at the 3D row (PP =
    40 pads D from 64 to 80), at the stuffed 78^3 volume of the transposed
    call at K=8 (two W blocks, the clamped last one off 16 B alignment), with
    groups=2, at W < 64 with H = 37 (the factored H/W kernels pad it to Hw
    = 40 and read the packed layout's 37 rows) and at H = 32 with an odd D
    and a clamped second W block (the factored H/W kernels read the packed
    layout there as at the 3D row). At each, B3 reading the packed layout
    is held to
    B3's direct read (the same values in the same order, so expected bit for
    bit) and to the plain version. Returns the timing cases and B6's max abs
    errors."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch.kernels import fused3d

    x0, wt, _, _ = inputs3d[0]
    # (case, x, kernel, groups, timed)
    cases = [
        ("64^3 K=8", x0, wt, 1, True),
        ("stuffed 78^3, K=8, 2 W blocks", TF.pad(x0, (7,) * 6), wt, 1, True),
        ("64^3 K=8 groups=2", x0, wt[:, :4].contiguous(), 2, False),
        ("D, H, W = 41, 37, 45, K = (9, 5, 7)",
         torch.randn(2, 8, 41, 37, 45, generator=gen).to(dev),
         (torch.randn(8, 8, 9, 5, 7, generator=gen) / 50.0).to(dev), 1, False),
        ("D, H, W = 15, 32, 70, K = (3, 3, 7)",
         torch.randn(2, 8, 15, 32, 70, generator=gen).to(dev),
         (torch.randn(8, 8, 3, 3, 7, generator=gen) / 15.0).to(dev), 1, False),
    ]
    timed, errs = [], []
    for what, x, k, groups, timed_case in cases:
        b, cin, d, h, w = x.shape
        kk = tuple(k.shape[2:])
        plan, nwb, hop = fused3d.plan_3d_blocked(cin, k.shape[0], d, h, w, *kk, groups)
        check(plan[0] == "v4", f"B6 {what}: plan {plan}")
        pp = plan[3]
        out = torch.full((b * nwb, h, cin * pp, 128), float("nan"), device=dev)
        before = fused3d.launches_pack
        xp = fused3d._launch_pack3d(x, pp, nwb, hop, out=out)
        torch.cuda.synchronize()
        check(fused3d.launches_pack == before + 1, f"B6 {what}: not one launch")
        check(bool(xp.isfinite().all()), f"B6 {what}: an element of xp was not written")
        ref = fused3d._pack3d_reference(x, pp, nwb, hop)
        err = float((xp - ref).abs().max())
        check(torch.equal(xp, ref), f"B6 {what}: differs from its plain version by {err}")
        errs.append(err)

        spectra = fused3d.kernel_spectra_3d(k, fused3d._h_work(h)[0])
        direct = fused3d._launch_fused3d(x, spectra, groups, kk)
        packed = fused3d._launch_fused3d(x, spectra, groups, kk, packed=True)
        torch.cuda.synchronize()
        diff = float((packed - direct).abs().max())
        close_scaled(packed, direct, f"B3 'pk' vs direct, {what}")
        mx, mean, sigma = close_scaled(
            packed, fused3d._fused3d_forward_reference(x, k, groups, packed=True),
            f"B3 'pk' vs plain, {what}")
        print(json.dumps({"phase": "kernel_vs_plain", "kernel": "B6", "case": what,
                          "plan": list(plan), "w_blocks": nwb, "xp_shape": list(xp.shape),
                          "h_path": fused3d._h_path(h), "hw": fused3d._h_work(h)[0],
                          "exact": True, "max_abs_err": err,
                          "B3_pk_bit_equal_to_direct": torch.equal(packed, direct),
                          "B3_pk_max_abs_diff_to_direct": diff,
                          "B3_pk_max_abs_err_vs_plain": mx, "mean_abs_err": mean,
                          "sigma": sigma}))
        if timed_case:
            timed.append((what, x, pp, nwb, hop))
    torch.cuda.synchronize()
    return timed, errs


def main_path_pk(torch, inputs3d):
    """Under set_fused3d_xpack("pk"), counted from zero: fft_conv(impl=
    "auto") at the 3D row, FFTConv3d(8, 8, 8) forward and backward,
    fft_conv_transpose(impl="fused") at 64^3 K=8 (a 'v4' plan of the stuffed
    78^3 volume in two W blocks) and the 3D row's serving plan each launch B6
    once and B3 once, B4 never; each is held to impl="xla". Returns B6's
    launches."""
    from fft_conv_tpu_torch import FFTConv3d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused3d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    x, wt, bias, _ = inputs3d[0]
    plan = plan_fft_conv(wt, bias, signal_spatial=x.shape[2:])
    gen = torch.Generator().manual_seed(2)
    wt_t = (torch.randn(8, 8, 8, 8, 8, generator=gen) / (8 * 8 ** 3) ** 0.5).to(x.device)
    layer = FFTConv3d(8, 8, 8, device="cuda", generator=torch.Generator().manual_seed(0))

    def counts():
        torch.cuda.synchronize()
        return fused3d.launches, fused3d.launches_tap, fused3d.launches_pack

    def drive(what, fn, ref):
        before = counts()
        y = fn()
        rose = tuple(a - c for a, c in zip(counts(), before))
        check(rose == (1, 0, 1), f"{what} under 'pk' launched (B3, B4, B6) {rose}")
        mx, mean, _ = close_scaled(y, ref(), f"{what} under 'pk' vs xla")
        print(json.dumps({"phase": "main_path", "kernel": "B6", "case": f"{what} under 'pk'",
                          "launches": dict(zip(("B3", "B4", "B6"), rose)),
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean}))

    fused3d.set_fused3d_xpack("pk")
    try:
        fused3d.launches = fused3d.launches_tap = fused3d.launches_pack = 0
        drive("fft_conv(impl='auto') 64^3 K=8", lambda: fft_conv(x, wt, bias),
              lambda: fft_conv(x, wt, bias, impl="xla"))
        xg = x.clone().requires_grad_()
        before = counts()
        y = layer(xg)
        y.sum().backward()
        rose = tuple(a - c for a, c in zip(counts(), before))
        check(rose == (1, 0, 1), f"FFTConv3d(8, 8, 8) under 'pk' launched (B3, B4, B6) {rose}")
        w_ref = layer.weight.detach().clone().requires_grad_()
        x_ref = x.clone().requires_grad_()
        y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
        y_ref.sum().backward()
        close_scaled(y, y_ref, "FFTConv3d under 'pk' forward vs xla")
        gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "FFTConv3d 'pk' weight grad")
        gx_err, _, _ = close_scaled(xg.grad, x_ref.grad, "FFTConv3d 'pk' input grad")
        print(json.dumps({"phase": "module", "kernel": "B6",
                          "case": "FFTConv3d(8, 8, 8) under 'pk'",
                          "launches": dict(zip(("B3", "B4", "B6"), rose)),
                          "weight_grad_max_abs_err": gw_err, "input_grad_max_abs_err": gx_err}))
        drive("fft_conv_transpose(impl='fused') 64^3 K=8",
              lambda: fft_conv_transpose(x, wt_t, bias, impl="fused"),
              lambda: fft_conv_transpose(x, wt_t, bias, impl="xla"))
        drive("plan_fft_conv 64^3 K=8", lambda: plan(x),
              lambda: fft_conv(x, wt, bias, impl="xla"))
        launched = counts()
    finally:
        fused3d.set_fused3d_xpack("h2")
    print(json.dumps({"phase": "main_path_counts", "kernels": "B3, B4, B6 under 'pk'",
                      "launches": dict(zip(("B3", "B4", "B6"), launched))}))
    torch.cuda.synchronize()
    return launched[2]


SPECTRA_FUNCTIONS = ("fused1d.kernel_spectra_one_sided", "fused1d.kernel_spectrum",
                     "fused2d.kernel_spectra_2d", "fused2d.kernel_spectra_2d_planes",
                     "fused3d.kernel_spectra_3d", "fused3d.kernel_spectra_tap",
                     "fused3d._hw_spectra")


def main_path_plans(torch, inputs1d, inputs2d, inputs3d, inputs3t):
    """The serving plans, counted from zero: one plan_fft_conv per benchmark
    row (B1 at the 1D rows, B2 at the 2D rows and B5 on the same plans under
    "v3", B3 at 3D K=8, B4 at 3D K=10), plan_fft_conv_transpose at the 1D
    and 2D rows (B1, B2) and at 64^3 K=8 (the torch.fft tier, as the 3D
    transposed auto path is composed), and the 2D row at stride 2 (the
    torch.fft tier). Each planned call launches its kernel once and no
    other, computes no kernel spectra (every function that computes them is
    wrapped with a counter while the calls run) and matches the unplanned
    default call within the bar."""
    from fft_conv_tpu_torch import fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d
    from fft_conv_tpu_torch.ops import plan_fft_conv, plan_fft_conv_transpose

    modules = {"fused1d": fused1d, "fused2d": fused2d, "fused3d": fused3d}
    names = ("B1", "B2", "B5", "B3", "B4", "B6")

    def counts():
        torch.cuda.synchronize()
        return (fused1d.launches, fused2d.launches, fused2d.launches_v3, fused3d.launches,
                fused3d.launches_tap, fused3d.launches_pack)

    # (what, plan, signal, the default call it stands for, kernel or None, "v3")
    cases = []
    for x, w, b, _ in inputs1d:
        cases.append((f"plan_fft_conv 1D K={w.shape[-1]}",
                      plan_fft_conv(w, b, signal_spatial=x.shape[2:], max_batch=x.shape[0]),
                      x, functools.partial(fft_conv, x, w, b), "B1", False))
    for v3 in (False, True):
        for x, w, b, _ in inputs2d:
            cases.append((f"plan_fft_conv 2D K={w.shape[-1]}" + (" under v3" if v3 else ""),
                          plan_fft_conv(w, b, signal_spatial=x.shape[2:]), x,
                          functools.partial(fft_conv, x, w, b), "B5" if v3 else "B2", v3))
    for (x, w, b, _), kernel in ((inputs3d[0], "B3"), (inputs3t[0], "B4")):
        cases.append((f"plan_fft_conv 3D K={w.shape[-1]}",
                      plan_fft_conv(w, b, signal_spatial=x.shape[2:]), x,
                      functools.partial(fft_conv, x, w, b), kernel, False))
    for (x, w, b, _), kernel in [(i, "B1") for i in inputs1d] + [(i, "B2") for i in inputs2d]:
        cases.append((f"plan_fft_conv_transpose {x.ndim - 2}D K={w.shape[-1]}",
                      plan_fft_conv_transpose(w, b, signal_spatial=x.shape[2:],
                                              max_batch=x.shape[0]),
                      x, functools.partial(fft_conv_transpose, x, w, b), kernel, False))
    x, w, b, _ = inputs3d[0]
    cases.append(("plan_fft_conv_transpose 3D K=8 (torch.fft tier)",
                  plan_fft_conv_transpose(w, b, signal_spatial=x.shape[2:]), x,
                  functools.partial(fft_conv_transpose, x, w, b), None, False))
    x, w, b, _ = inputs2d[0]
    cases.append(("plan_fft_conv 2D K=16 stride 2 (torch.fft tier)",
                  plan_fft_conv(w, b, stride=2, signal_spatial=x.shape[2:]), x,
                  functools.partial(fft_conv, x, w, b, stride=2), None, False))

    # the unplanned calls first: their launches and spectra are not the path's
    refs = []
    for _, _, _, ref, _, v3 in cases:
        fused2d.set_fused2d_kernel("v3" if v3 else "v2")
        refs.append(ref())
    fused2d.set_fused2d_kernel("v2")
    torch.cuda.synchronize()

    spectra_calls = []
    real = {}
    for name in SPECTRA_FUNCTIONS:
        mod, attr = name.split(".")
        real[name] = getattr(modules[mod], attr)
        setattr(modules[mod], attr,
                lambda *a, _f=real[name], _n=name, **k: spectra_calls.append(_n) or _f(*a, **k))
    outs = []
    try:
        fused1d.launches = fused2d.launches = fused2d.launches_v3 = 0
        fused3d.launches = fused3d.launches_tap = fused3d.launches_pack = 0
        for what, plan, x, _, kernel, v3 in cases:
            fused2d.set_fused2d_kernel("v3" if v3 else "v2")
            before = counts()
            y = plan(x)
            rose = dict(zip(names, (a - c for a, c in zip(counts(), before))))
            want = {n: int(n == kernel) for n in names}
            check(rose == want, f"{what} launched {rose}, not {want}")
            outs.append((y, rose))
        launched = counts()
    finally:
        fused2d.set_fused2d_kernel("v2")
        for name, f in real.items():
            mod, attr = name.split(".")
            setattr(modules[mod], attr, f)
    check(spectra_calls == [], f"planned calls computed kernel spectra: {spectra_calls}")
    for (what, _, _, _, kernel, _), (y, rose), y_ref in zip(cases, outs, refs):
        mx, mean, _ = close_scaled(y, y_ref, f"{what} vs the unplanned call")
        print(json.dumps({"phase": "main_path", "case": what, "kernel": kernel,
                          "launches": rose, "spectra_calls": 0,
                          "max_abs_err_vs_unplanned": mx, "mean_abs_err": mean}))
    print(json.dumps({"phase": "main_path_counts", "kernels": "serving plans",
                      "launches": dict(zip(names, launched)), "spectra_calls": 0}))
    torch.cuda.synchronize()


def time_tier3(torch, inputs2d):
    """The torch.fft tier of plan_fft_conv at the 2D row at stride 2, beside
    the unplanned default call (B2 on the card) and the composed path."""
    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.ops import plan_fft_conv

    x, wt, _, _ = inputs2d[0]
    planned = plan_fft_conv(wt, stride=2, signal_spatial=x.shape[2:])
    row = {
        "K": wt.shape[-1], "stride": 2,
        "plan_ms": device_ms(lambda: planned(x)),
        "plan_call_ms": call_ms(lambda: planned(x)),
        "auto_ms": device_ms(lambda: fft_conv(x, wt, stride=2)),
        "composed_ms": device_ms(lambda: fft_conv(x, wt, stride=2, impl="xla")),
    }
    print(json.dumps({"phase": "timing", "case": "plan_fft_conv 2D, torch.fft tier", **row}))
    torch.cuda.synchronize()


def time_pack3d(torch, timed):
    """B6's timing rows: its device time and latency, its plain version's
    latency and its bytes bound, at the 3D row and the stuffed 78^3 volume.
    No PyTorch call computes this permutation, so library_ms is null."""
    from fft_conv_tpu_torch.kernels.costs import bound, pack3d_bytes
    from fft_conv_tpu_torch.kernels import fused3d

    rows = []
    for what, x, pp, nwb, hop in timed:
        def kernel():
            return fused3d._launch_pack3d(x, pp, nwb, hop)

        nbytes = pack3d_bytes(*x.shape, pp, nwb)
        bound_ms, bound_by = bound(nbytes, 0)
        row = {
            "case": what, "PP": pp, "w_blocks": nwb,
            "ms": device_ms(kernel), "call_ms": call_ms(kernel),
            "plain_ms": call_ms(lambda: fused3d._pack3d_reference(x, pp, nwb, hop)),
            "library_ms": None, "bytes": nbytes, "flops": 0,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        row["pack_ms"], row["pack_call_ms"], row["pack_bound_ms"] = (
            row["ms"], row["call_ms"], bound_ms)
        rows.append(row)
        print(json.dumps({"phase": "timing", "kernel": "B6", **row}))
        torch.cuda.synchronize()
    return rows


def run_stream(torch, x, w, bias, sizes, dilation=1, groups=1):
    """x fed to the streaming step in chunks of ``sizes`` from a zero
    state, as a server filtering a long signal frame by frame: (the chunks'
    outputs, the final state)."""
    from fft_conv_tpu_torch.ops import streaming_conv1d_init, streaming_conv1d_step

    state = streaming_conv1d_init(x.shape[0], x.shape[1], w.shape[-1], dilation)
    outs, start = [], 0
    for size in sizes:
        y, state = streaming_conv1d_step(state, x[..., start:start + size], w, bias,
                                         dilation=dilation, groups=groups)
        outs.append(y)
        start += size
    return outs, state


def phase_streaming(torch, inputs, rows):
    """Phase 6, the streaming path, counted from zero: each 1D row's signal
    (B=2, 8 -> 8, bias) as 8 chunks of STREAM_CHUNK samples, and at K=1024
    a ragged stream (RAGGED_CHUNKS), dilation 2 at K=256 and groups 2 at
    K=256. Each chunk launches B1 once; the joined outputs match the
    one-shot call over the left-padded stream (auto, on the card) and the
    composed path; the final state is the stream's last K_dil - 1 samples
    exactly. At K=1024 one step's weight gradient matches the composed
    path. Then per row the device time and call latency of one step and of
    the whole stream (in one CUDA graph), beside the one-shot call."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels import fused1d
    from fft_conv_tpu_torch.ops import streaming_conv1d_init, streaming_conv1d_step

    frames = [STREAM_CHUNK] * STREAM_CHUNKS
    cases = [(f"K={w.shape[-1]}, {STREAM_CHUNKS} x {STREAM_CHUNK}", x, w, bias, frames, 1, 1)
             for x, w, bias, _ in inputs]
    x, w, bias, _ = inputs[1]
    cases.append((f"K=1024, ragged {RAGGED_CHUNKS}", x, w, bias, RAGGED_CHUNKS, 1, 1))
    x, w, bias, _ = inputs[0]
    cases.append(("K=256, dilation 2", x, w, bias, frames, 2, 1))
    cases.append(("K=256, groups 2", x, w[:, :4].contiguous(), bias, frames, 1, 2))

    torch.cuda.synchronize()
    fused1d.launches = 0
    streamed = []
    for what, x, w, bias, sizes, dilation, groups in cases:
        check(sum(sizes) == x.shape[-1], f"stream {what}: chunks do not cover the signal")
        before = fused1d.launches
        outs, state = run_stream(torch, x, w, bias, sizes, dilation, groups)
        torch.cuda.synchronize()
        rose = fused1d.launches - before
        check(rose == len(sizes),
              f"stream {what}: B1 launched {rose} times for {len(sizes)} chunks")
        streamed.append((torch.cat(outs, dim=-1), state, rose))
    launched = fused1d.launches
    print(json.dumps({"phase": "main_path_counts", "kernels": "B1 (streaming)",
                      "launches": launched, "chunks": sum(len(c[4]) for c in cases)}))

    for (what, x, w, bias, sizes, dilation, groups), (y, state, rose) in zip(cases, streamed):
        k_dil = (w.shape[-1] - 1) * dilation + 1
        xp = TF.pad(x, (k_dil - 1, 0))
        kw = dict(dilation=dilation, groups=groups)
        mx, mean, sigma = close_scaled(y, fft_conv(xp, w, bias, **kw), f"stream {what} vs one-shot")
        mxc, _, _ = close_scaled(y, fft_conv(xp, w, bias, impl="xla", **kw),
                                 f"stream {what} vs composed")
        check(torch.equal(state, x[..., x.shape[-1] - (k_dil - 1):]),
              f"stream {what}: the final state is not the last K_dil - 1 samples")
        print(json.dumps({"phase": "streaming", "case": what, "chunks": list(sizes),
                          "launches": rose, "max_abs_err_vs_oneshot": mx, "mean_abs_err": mean,
                          "max_abs_err_vs_composed": mxc, "sigma": sigma,
                          "state_exact": True}))

    # one step's weight gradient at K=1024, from a state of real samples
    x, w, bias, _ = inputs[1]
    k = w.shape[-1]
    state = x[..., STREAM_CHUNK - (k - 1):STREAM_CHUNK]
    chunk = x[..., STREAM_CHUNK:2 * STREAM_CHUNK]
    g = torch.randn(2, 8, STREAM_CHUNK, generator=torch.Generator().manual_seed(3)).to(x.device)
    wg = w.clone().requires_grad_()
    before = fused1d.launches
    y, _ = streaming_conv1d_step(state, chunk, wg, bias)
    (y * g).sum().backward()
    torch.cuda.synchronize()
    check(fused1d.launches == before + 1, "the differentiated step did not launch B1 once")
    w_ref = w.clone().requires_grad_()
    (fft_conv(torch.cat([state, chunk], dim=-1), w_ref, bias, impl="xla") * g).sum().backward()
    gw_err, _, _ = close_scaled(wg.grad, w_ref.grad, "stream step weight grad vs composed")
    print(json.dumps({"phase": "streaming", "case": "K=1024 step, weight gradient",
                      "weight_grad_max_abs_err": gw_err}))

    # timings: "*_ms" device time (CUDA graph replay), "*_call_ms" latency
    out = []
    for (x, w, bias, _), row in zip(inputs, rows):
        k = w.shape[-1]
        state0 = streaming_conv1d_init(x.shape[0], x.shape[1], k)
        chunk = x[..., :STREAM_CHUNK]

        def step():
            return streaming_conv1d_step(state0, chunk, w, bias)

        def stream():
            return run_stream(torch, x, w, bias, frames)

        n = fused1d.choose_fft_size(k, STREAM_CHUNK + k - 1, x.shape[1], w.shape[0],
                                    batch=x.shape[0])
        srow = {
            "K": k, "chunk": STREAM_CHUNK, "chunks": STREAM_CHUNKS, "N": n,
            "stream_step_ms": device_ms(step),
            "stream_step_call_ms": call_ms(step),
            "stream_ms": device_ms(stream),
            "stream_call_ms": call_ms(stream),
            # B1's own device time in one stream, from torch.profiler
            "stream_b1_ms": sum(phase_split_ms(torch, stream, "fused1d_").values()),
            # the kernel spectra that every step computes anew
            "step_spectra_ms": device_ms(lambda: fused1d.kernel_spectra_one_sided(w, n)),
            "auto_ms": row["auto_ms"], "auto_call_ms": row["auto_call_ms"],
        }
        srow["stream_over_auto"] = srow["stream_ms"] / srow["auto_ms"]
        out.append(srow)
        print(json.dumps({"phase": "timing", "kernel": "B1", "case": "streaming", **srow}))
        torch.cuda.synchronize()
    return launched, out


def phase_harness(torch, inputs, rows):
    """Phase 7, the measurement modules on the 1D K=1024 row: benchmark_fori
    on the serving plan (the median of CUDA-event times of graph replays,
    the timer of device_ms too) within 10% of a witness that shares none of
    its code, the host clock over WITNESS_REPLAYS back-to-back replays of a
    graph of the same calls captured here (the card, not the host, sets
    their pace); torch.profiler's time of B1's two kernels over eager calls
    of the plan no more than 10% above it; measure's peak (above 0 GiB),
    benchmark and benchmark_chained on the auto call (positive means),
    cost_analysis of the auto call (B1 recorded once with its kernel_flops,
    plus the flops of the spectra the call computes), roofline's
    hbm_fraction in (0, 1.05], and a trace file that names B1's two
    kernels."""
    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.bench.harness import (
        benchmark, benchmark_chained, benchmark_fori, measure, peak_memory_gib)
    from fft_conv_tpu_torch.bench.profiling import cost_analysis, roofline, trace
    from fft_conv_tpu_torch.kernels import fused1d
    from fft_conv_tpu_torch.kernels.costs import fused1d_kernel_flops, fused1d_work
    from fft_conv_tpu_torch.ops import plan_fft_conv

    x, w, _, n = inputs[1]
    b, cin, l = x.shape
    cout, _, k = w.shape
    planned = plan_fft_conv(w, signal_spatial=(l,), max_batch=b)
    fori_ms = benchmark_fori(planned, x, num_iterations=GRAPH_REPS).mean * 1e3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_REPS):
            planned(x)
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WITNESS_REPLAYS):
        graph.replay()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (WITNESS_REPLAYS * GRAPH_REPS)
    del graph
    check(abs(fori_ms / wall_ms - 1) <= 0.10,
          f"benchmark_fori {fori_ms:.5f} ms is not within 10% of the host clock's "
          f"{wall_ms:.5f} ms over {WITNESS_REPLAYS} graph replays")
    b1_split = phase_split_ms(torch, lambda: planned(x), "fused1d_")
    b1_ms = sum(b1_split.values())
    check(len(b1_split) == 2 and b1_ms <= 1.10 * fori_ms,
          f"the profiler's B1 kernels {b1_split} exceed benchmark_fori {fori_ms:.5f} ms")

    with measure() as r:
        fft_conv(x, w, impl="auto")
    check(r["memory"] > 0, f"measure() read a peak of {r['memory']} GiB")
    t, mem = benchmark(lambda: fft_conv(x, w, impl="auto"), num_iterations=10)
    tc = benchmark_chained(fft_conv, x, w, num_iterations=16)
    check(t.mean > 0 and tc.mean > 0, f"benchmark {t}, benchmark_chained {tc}")
    peak, source = peak_memory_gib(fft_conv, x, w)

    counts = cost_analysis(fft_conv, x, w)
    kernel_flops = fused1d_kernel_flops(b, cin, cout, l, k, n)
    spectra_flops = cost_analysis(fused1d.kernel_spectra_one_sided, w, n)["flops"]
    b1 = counts["kernels"].get("B1", {})
    check(b1.get("flops") == kernel_flops and b1.get("calls") == 1
          and spectra_flops > 0 and counts["flops"] == kernel_flops + spectra_flops,
          f"cost_analysis {counts} is not B1's kernel_flops {kernel_flops} plus the "
          f"spectra's {spectra_flops}")
    rl = roofline(fft_conv, x, w)
    check(0 < rl["hbm_fraction"] <= 1.05, f"roofline's hbm_fraction {rl['hbm_fraction']}")

    log_dir = os.path.join(HERE, "build", "chip_smoke", "trace")
    with trace(log_dir):
        fft_conv(x, w, impl="auto")
    with open(os.path.join(log_dir, "trace.json")) as f:
        text = f.read()
    named = {name: name in text for name in ("fused1d_spectra", "fused1d_mac_inverse")}
    check(all(named.values()), f"the trace does not name B1's kernels: {named}")
    print(json.dumps({
        "phase": "harness", "K": k, "benchmark_fori_ms": fori_ms, "replay_wall_ms": wall_ms,
        "fori_over_wall": fori_ms / wall_ms, "profiler_b1_ms": b1_ms,
        "profiler_b1_split_ms": b1_split, "measure_s": r["time"], "measure_gib": r["memory"],
        "benchmark_mean_s": t.mean, "benchmark_std_s": t.std, "benchmark_gib": mem.mean,
        "benchmark_chained_mean_s": tc.mean, "peak_memory_gib": peak, "peak_source": source,
        "cost_flops": counts["flops"], "cost_bytes": counts["bytes accessed"],
        "cost_kernels": counts["kernels"], "kernel_flops": kernel_flops,
        "spectra_flops": spectra_flops,
        "kernel_bytes": fused1d_work(b, cin, cout, l, k, n)[0], "roofline": rl,
        "trace_names": named, "auto_ms": rows[1]["auto_ms"]}))
    torch.cuda.synchronize()


def phase_checkpoint(torch, inputs):
    """Phase 8, checkpoints on the card: an FFTConv1d(8, 8, 1024) saved and
    loaded into a layer built from another seed (weights, bias and outputs
    equal bit for bit, B1 launched), and a torch.nn.ConvTranspose1d state
    dict restored into FFTConvTranspose1d, held to conv_transpose1d (TF32
    off) at the bar."""
    import numpy as np

    from fft_conv_tpu_torch import FFTConv1d, FFTConvTranspose1d
    from fft_conv_tpu_torch.kernels import fused1d
    from fft_conv_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    x = inputs[1][0]
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "ckpt.npz")
    layer = FFTConv1d(8, 8, 1024, device="cuda", generator=torch.Generator().manual_seed(0))
    save_checkpoint(path, layer)
    fresh = FFTConv1d(8, 8, 1024, device="cuda", generator=torch.Generator().manual_seed(1))
    check(not torch.equal(fresh.weight, layer.weight), "the two seeds gave one weight")
    loaded = load_checkpoint(path, fresh)
    check(loaded is fresh and fresh.weight.is_cuda, "load_checkpoint did not load in place")
    check(torch.equal(fresh.weight, layer.weight) and torch.equal(fresh.bias, layer.bias),
          "the loaded parameters differ from the saved ones")
    before = fused1d.launches
    with torch.no_grad():
        y, y_loaded = layer(x), fresh(x)
    torch.cuda.synchronize()
    check(fused1d.launches == before + 2, "the layers did not launch B1")
    check(torch.equal(y, y_loaded), "the loaded layer's outputs differ from the saved layer's")

    gen = torch.Generator().manual_seed(2)
    tl = torch.nn.ConvTranspose1d(8, 8, 1024)
    with torch.no_grad():
        tl.weight.copy_(torch.randn(8, 8, 1024, generator=gen) / (8 * 1024) ** 0.5)
        tl.bias.copy_(torch.randn(8, generator=gen))
    tl = tl.to(x.device)
    tpath = os.path.join(ckpt_dir, "conv_transpose1d.npz")
    np.savez(tpath, **{k: v.detach().cpu().numpy() for k, v in tl.state_dict().items()})
    ours = load_checkpoint(tpath, FFTConvTranspose1d(8, 8, 1024, device="cuda",
                                                     generator=torch.Generator().manual_seed(3)))
    before = fused1d.launches
    with torch.no_grad():
        y = ours(x)
        torch.cuda.synchronize()
        rose = fused1d.launches - before
        mx, mean, sigma = close_scaled(y, tl(x), "FFTConvTranspose1d from a ConvTranspose1d")
    check(rose >= 1, "FFTConvTranspose1d did not launch B1")
    print(json.dumps({"phase": "checkpoint", "npz_round_trip_bit_equal": True,
                      "layer": "FFTConv1d(8, 8, 1024)", "launches": rose,
                      "conv_transpose1d_interop_max_abs_err": mx, "mean_abs_err": mean,
                      "sigma": sigma}))
    torch.cuda.synchronize()


def kind_split_ms(torch, fn):
    """Device time per call of fn() by kind of kernel (``profile_ms``):
    cuBLAS products ("gemm" in the name), reductions ("reduce"), and the
    rest (elementwise ops and the copies that permute operands)."""
    return profile_ms(
        torch, fn, lambda key: next((k for k in ("gemm", "reduce") if k in key.lower()), "other"))


def phase_tiled(torch, inputs1d, inputs2d, inputs3d):
    """Phase 9, the DFT-matmul path. impl="tiled" at the 2D rows, the 1D
    K=1024 row, the 2D transposed K=16 row and the 3D row, and an
    FFTConv2d(8, 8, 16, impl="tiled") forward and backward: each call's tile
    (read from the transforms it runs) is plan_tiles's, its result is within
    the bar of impl="xla" (the 3D row, whose plan is the whole volume, equal
    to it), and no fused kernel launches. Times: tiled_ms (device) and
    tiled_call_ms beside composed_ms and auto_ms; cost_analysis and roofline
    of the 2D K=16 tiled call. Then the 2D K=16 tiled call with TF32
    allowed globally, through the legacy flag and through the newer
    per-backend flag where torch has it: within the bar, the caller's flag
    as it was after (beside it, for reading only, the same call with the
    FP32 scope removed)."""
    import contextlib

    from fft_conv_tpu_torch import FFTConv2d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.bench.profiling import cost_analysis, roofline
    from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d
    from fft_conv_tpu_torch.kernels.costs import FP32_FLOPS_PER_S
    from fft_conv_tpu_torch.ops import spectral, tiled

    names = ("B1", "B2", "B5", "B3", "B4", "B6")

    def counts():
        torch.cuda.synchronize()
        return dict(zip(names, (fused1d.launches, fused2d.launches, fused2d.launches_v3,
                                fused3d.launches, fused3d.launches_tap,
                                fused3d.launches_pack)))

    def traced_tiles(fn):
        """fn()'s result and the tile shapes of the DFT-matmul transforms it ran."""
        tiles = set()
        real = tiled.rfftn_matmul
        tiled.rfftn_matmul = lambda x, shape: tiles.add(tuple(shape)) or real(x, shape)
        try:
            y = fn()
        finally:
            tiled.rfftn_matmul = real
        return y, sorted(tiles)

    x2, w16, b16, _ = inputs2d[0]
    # (what, impl="tiled" call, the same call composed, auto, plan_tiles's
    # arguments); a transposed call's tiles cover the interior-stuffed signal
    rows = []
    for (x, w, b, _), fn in [(i, fft_conv) for i in inputs2d + [inputs1d[1]]] + [
            (inputs2d[0], fft_conv_transpose), (inputs3d[0], fft_conv)]:
        spatial, k = tuple(x.shape[2:]), tuple(w.shape[2:])
        out_len = tuple(s - kk + 1 for s, kk in zip(spatial, k))
        cout = w.shape[0]
        if fn is fft_conv_transpose:
            spatial = out_len = tuple(s + kk - 1 for s, kk in zip(spatial, k))
            cout = w.shape[1]
        rows.append((f"{fn.__name__} {len(k)}D K={k[0]}",
                     functools.partial(fn, x, w, b, impl="tiled"),
                     functools.partial(fn, x, w, b, impl="xla"), functools.partial(fn, x, w, b),
                     (spatial, k, out_len, (x.shape[0], x.shape[1], cout))))
    out = []
    for what, call, composed, auto, plan_args in rows:
        tile = tiled.plan_tiles(*plan_args)[0]
        degenerate = tile == tiled.untiled_shape(*plan_args[:3])
        y_ref = composed()
        before = counts()
        y, ran = traced_tiles(call)
        check(counts() == before, f"{what} impl='tiled' launched a fused kernel")
        if degenerate:
            check(ran == [] and torch.equal(y, y_ref), f"{what}: not the composed path")
            mx = mean = 0.0
        else:
            check(ran == [tile], f"{what} ran tiles {ran}, not plan_tiles's {tile}")
            mx, mean, _ = close_scaled(y, y_ref, f"{what} impl='tiled' vs xla")
        row = {"case": what + (" (whole-signal plan: composed)" if degenerate else ""),
               "tile": list(tile), "tiled": not degenerate,
               "launches": {n: 0 for n in names}, "max_abs_err_vs_composed": mx,
               "mean_abs_err": mean,
               "tiled_ms": device_ms(call), "tiled_call_ms": call_ms(call),
               "composed_ms": device_ms(composed), "auto_ms": device_ms(auto)}
        out.append(row)
        print(json.dumps({"phase": "tiled", **row}))
        torch.cuda.synchronize()

    cout, cin, k = w16.shape[:3]
    layer = FFTConv2d(cin, cout, k, impl="tiled", device=x2.device,
                      generator=torch.Generator().manual_seed(0))
    x = x2.clone().requires_grad_()
    before = counts()
    y, ran = traced_tiles(lambda: layer(x))
    y.sum().backward()
    check(counts() == before, "FFTConv2d(impl='tiled') launched a fused kernel")
    check(ran == [tuple(out[0]["tile"])], f"FFTConv2d(impl='tiled') ran tiles {ran}")
    w_ref = layer.weight.detach().clone().requires_grad_()
    x_ref = x2.clone().requires_grad_()
    y_ref = fft_conv(x_ref, w_ref, layer.bias.detach(), impl="xla")
    y_ref.sum().backward()
    mx, _, _ = close_scaled(y, y_ref, "FFTConv2d(impl='tiled') forward vs xla")
    gw_err, _, _ = close_scaled(layer.weight.grad, w_ref.grad, "tiled weight grad vs xla")
    gx_err, _, _ = close_scaled(x.grad, x_ref.grad, "tiled input grad vs xla")
    print(json.dumps({"phase": "tiled", "case": f"FFTConv2d({cin}, {cout}, {k}, impl='tiled')",
                      "tile": out[0]["tile"], "launches": {n: 0 for n in names},
                      "max_abs_err_vs_composed": mx, "weight_grad_max_abs_err": gw_err,
                      "input_grad_max_abs_err": gx_err}))

    tiled16 = rows[0][1]
    counted = cost_analysis(tiled16)
    rl = roofline(lambda s: fft_conv(s, w16, b16, impl="tiled"), x2)
    kinds = kind_split_ms(torch, tiled16)
    print(json.dumps({"phase": "tiled", "case": f"cost of {rows[0][0]} impl='tiled'",
                      "cost_flops": counted["flops"], "cost_bytes": counted["bytes accessed"],
                      "cost_kernels": counted["kernels"],
                      "fp32_fraction_of_tiled_ms": counted["flops"] / (out[0]["tiled_ms"] * 1e-3)
                      / FP32_FLOPS_PER_S, "roofline": rl, "kind_split_ms": kinds,
                      "fp32_fraction_of_gemm_ms": counted["flops"] / (kinds.get("gemm", 0) * 1e-3)
                      / FP32_FLOPS_PER_S if kinds.get("gemm") else None}))

    # the FP32 scope under a global TF32 setting
    y_ref = rows[0][2]()
    m = torch.backends.cuda.matmul
    settings = [("allow_tf32=True", lambda: setattr(m, "allow_tf32", True))]
    if hasattr(m, "fp32_precision"):
        settings.append(("fp32_precision='tf32'", lambda: setattr(m, "fp32_precision", "tf32")))
    scope = spectral._fp32_products
    for what, allow in settings:
        try:
            allow()
            y = tiled16()
            check(m.fp32_precision == "tf32" if hasattr(m, "fp32_precision") else m.allow_tf32,
                  f"the tiled call did not restore {what}")
            spectral._fp32_products = contextlib.nullcontext
            y_unscoped = tiled16()
        finally:
            spectral._fp32_products = scope
            torch.set_float32_matmul_precision("highest")
            if hasattr(m, "fp32_precision"):
                m.fp32_precision = "none"
        mx, mean, _ = close_scaled(y, y_ref, f"tiled K=16 under {what} vs xla")
        err = (y_unscoped.double() - y_ref.double()).abs()
        print(json.dumps({"phase": "tiled", "case": f"{rows[0][0]} impl='tiled', {what}",
                          "max_abs_err_vs_composed": mx, "mean_abs_err": mean,
                          "without_fp32_scope_max_abs_err": float(err.max()),
                          "without_fp32_scope_mean_abs_err": float(err.mean())}))
        torch.cuda.synchronize()


def phase_parallel(torch, inputs1d, inputs2d, inputs3d):
    """Phase 10, ``fft_conv_tpu_torch.parallel`` on a one-rank NCCL group
    (a FileStore in a temporary directory, no network) and the mesh
    ``make_mesh()`` = (1, 1, 1) on the card, counted from zero:
    fft_conv_sharded(impl="auto") at 1D K=1024, 2D K=16 and 3D K=8 (B1, B2,
    B3 once each), tp_mode="in" at 1D K=256 (B1), fft_conv_transpose_sharded
    at 1D K=256 and 2D K=16 (B1, B2); each output equal, bit for bit, to the
    unsharded call on the same inputs, and within the bar of impl="xla".
    The weight gradient through fft_conv_sharded(impl="fused") at 1D K=1024
    within the bar of xla's; one-shard overlap-save at 1D K=1024 within the
    bar of fft_conv with no fused kernel launched; no NCCL kernel and no
    NCCL call in the DP forward (torch.profiler). Times: sharded_ms and
    sharded_call_ms beside auto_ms and auto_call_ms at 1D K=1024 and 2D
    K=16. The group is destroyed at the end."""
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from fft_conv_tpu_torch import fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.parallel import (
        fft_conv_sharded, fft_conv_spatial_sharded, fft_conv_transpose_sharded, make_mesh)

    x1, w1, b1, _ = inputs1d[1]     # K=1024
    x0, w0, b0, _ = inputs1d[0]     # K=256
    x2, w2, b2, _ = inputs2d[0]     # K=16
    x3, w3, b3, _ = inputs3d[0]     # K=8
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            check(tuple(mesh.shape) == (1, 1, 1) and mesh.device_type == "cuda",
                  f"make_mesh() gave {mesh}")
            # (what, sharded call, the same call unsharded, xla's, the kernel it launches)
            calls = [
                ("fft_conv_sharded 1D K=1024", lambda: fft_conv_sharded(x1, w1, b1, mesh=mesh),
                 lambda: fft_conv(x1, w1, b1), lambda: fft_conv(x1, w1, b1, impl="xla"), "B1"),
                ("fft_conv_sharded 2D K=16", lambda: fft_conv_sharded(x2, w2, b2, mesh=mesh),
                 lambda: fft_conv(x2, w2, b2), lambda: fft_conv(x2, w2, b2, impl="xla"), "B2"),
                ("fft_conv_sharded 3D K=8", lambda: fft_conv_sharded(x3, w3, b3, mesh=mesh),
                 lambda: fft_conv(x3, w3, b3), lambda: fft_conv(x3, w3, b3, impl="xla"), "B3"),
                ("fft_conv_sharded 1D K=256 tp_mode='in'",
                 lambda: fft_conv_sharded(x0, w0, b0, mesh=mesh, tp_mode="in"),
                 lambda: fft_conv(x0, w0, b0), lambda: fft_conv(x0, w0, b0, impl="xla"), "B1"),
                ("fft_conv_transpose_sharded 1D K=256",
                 lambda: fft_conv_transpose_sharded(x0, w0, b0, mesh=mesh),
                 lambda: fft_conv_transpose(x0, w0, b0),
                 lambda: fft_conv_transpose(x0, w0, b0, impl="xla"), "B1"),
                ("fft_conv_transpose_sharded 2D K=16",
                 lambda: fft_conv_transpose_sharded(x2, w2, b2, mesh=mesh),
                 lambda: fft_conv_transpose(x2, w2, b2),
                 lambda: fft_conv_transpose(x2, w2, b2, impl="xla"), "B2"),
            ]
            _reset_counts()
            path = dict.fromkeys(KERNEL_NAMES, 0)
            for what, sharded, unsharded, xla, kernel in calls:
                before = _counts(torch)
                y = sharded()
                rose = {k: v - before[k] for k, v in _counts(torch).items()}
                check(rose == {k: int(k == kernel) for k in KERNEL_NAMES},
                      f"{what} launched {rose}, not {kernel} once")
                for k in KERNEL_NAMES:
                    path[k] += rose[k]
                placements = [repr(p) for p in y.placements]
                y = y.to_local()  # one rank: the local block is the whole
                y_ref = unsharded()
                check(torch.equal(y, y_ref), f"{what}: not bit-equal to the unsharded call")
                mx, mean, _ = close_scaled(y, xla(), f"{what} vs xla")
                print(json.dumps({"phase": "parallel", "case": what, "launches": rose[kernel],
                                  "kernel": kernel, "placements": placements,
                                  "bit_equal_to_unsharded": True,
                                  "max_abs_err_vs_xla": mx, "mean_abs_err": mean}))
            print(json.dumps({"phase": "main_path_counts", "kernels": "B1, B2, B3 (parallel)",
                              "launches": path}))

            # the weight gradient through the fused route
            w = w1.clone().requires_grad_()
            before = _counts(torch)
            fft_conv_sharded(x1, w, b1, mesh=mesh, impl="fused").to_local().sum().backward()
            check(_counts(torch)["B1"] - before["B1"] == 1,
                  "the sharded fused call did not launch B1")
            w_ref = w1.clone().requires_grad_()
            fft_conv(x1, w_ref, b1, impl="xla").sum().backward()
            gw_err, _, _ = close_scaled(w.grad, w_ref.grad, "sharded fused weight grad vs xla")
            print(json.dumps({"phase": "parallel", "case": "fft_conv_sharded 1D K=1024 "
                              "impl='fused', weight gradient", "max_abs_err_vs_xla": gw_err}))

            # one-shard overlap-save: the composed path, no fused kernel
            before = _counts(torch)
            y = fft_conv_spatial_sharded(x1, w1, b1, mesh=mesh)
            check(_counts(torch) == before, "overlap-save launched a fused kernel")
            mx, mean, _ = close_scaled(y, fft_conv(x1, w1, b1, impl="xla"), "overlap-save vs xla")
            print(json.dumps({"phase": "parallel", "case": "fft_conv_spatial_sharded 1D K=1024, "
                              "one shard", "launches": 0, "max_abs_err_vs_xla": mx,
                              "mean_abs_err": mean}))

            # the DP forward makes no NCCL call and launches no NCCL kernel
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fft_conv_sharded(x1, w1, b1, mesh=mesh)
                torch.cuda.synchronize()
            nccl = sorted({e.name for e in prof.events() if "nccl" in e.name.lower()})
            device = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            check(device and not nccl, f"the DP forward: NCCL events {nccl}, "
                  f"{len(device)} device events")
            print(json.dumps({"phase": "parallel", "case": "DP forward, torch.profiler",
                              "nccl_events": nccl, "device_events": len(device)}))

            # times, beside the unsharded auto call's, in the same phase
            for what, (x, wt, bias) in (("1D K=1024", (x1, w1, b1)), ("2D K=16", (x2, w2, b2))):
                def sharded():
                    return fft_conv_sharded(x, wt, bias, mesh=mesh)

                def auto():
                    return fft_conv(x, wt, bias, impl="auto")

                # the DTensor wrapper is host work only: a CUDA graph captures the call
                row = {"case": what, "sharded_ms": device_ms(sharded), "auto_ms": device_ms(auto),
                       "sharded_call_ms": call_ms(sharded), "auto_call_ms": call_ms(auto)}
                row["sharded_over_auto"] = row["sharded_ms"] / row["auto_ms"]
                row["call_ms_added"] = row["sharded_call_ms"] - row["auto_call_ms"]
                print(json.dumps({"phase": "timing", "kernel": "B1" if x.ndim == 3 else "B2",
                                  "path": "parallel", **row}))
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()


def _counts(torch):
    """The seven launch counters (B1, B2, B5, B3, B4, B6, B7), after a sync."""
    from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d

    torch.cuda.synchronize()
    return dict(zip(KERNEL_NAMES, (fused1d.launches, fused2d.launches, fused2d.launches_v3,
                                   fused3d.launches, fused3d.launches_tap,
                                   fused3d.launches_pack, fused3d.launches_spectra)))


def _reset_counts():
    from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d

    fused1d.launches = fused2d.launches = fused2d.launches_v3 = 0
    fused3d.launches = fused3d.launches_tap = fused3d.launches_pack = 0
    fused3d.launches_spectra = 0


def _errors(pairs):
    """{name: [max abs err, mean abs err]} of each (name, output, impl="xla"
    reference) pair, each within the bar."""
    errs = {}
    for what, y, y_ref in pairs:
        mx, mean, _ = close_scaled(y, y_ref, what)
        errs[what] = [mx, mean]
    return errs


def phase_examples(torch):
    """Phase 11, the five examples of ``fft_conv_tpu_torch.examples`` at the
    JAX scripts' sizes on the card, each counted from zero: every output
    within the bar of the same calls under impl="xla", the launches each
    example must make (EXAMPLE_LAUNCHES), and the example's main call timed.
    Then the volume example's call under impl="fused" (B3 over two W
    blocks), held to the composed path."""
    import torch.nn.functional as TF

    from fft_conv_tpu_torch import FFTConv1d, fft_conv, fft_conv_transpose
    from fft_conv_tpu_torch.examples import (
        image_filter_bank_2d, long_audio_filter, serving_plans, train_fft_cnn,
        volume_stencil_3d)
    from fft_conv_tpu_torch.utils.convert import module_from_jax_state

    def layer_errors(what, layer, x, pad, y):
        # the layer's output and its loss's gradients against xla's
        w = layer.weight.detach().clone().requires_grad_()
        b = layer.bias.detach().clone().requires_grad_()
        y_ref = fft_conv(x, w, b, padding=pad, impl="xla")
        (y_ref ** 2).mean().backward()
        return [(f"{what} forward", y, y_ref),
                (f"{what} weight grad", layer.weight.grad, w.grad),
                (f"{what} bias grad", layer.bias.grad, b.grad)]

    def audio(r):
        taps = r["fir"].shape[-1]
        x, fir = r["audio"], r["fir"]
        y_ref = fft_conv(x, fir, padding=taps // 2, impl="xla")
        stream_ref = fft_conv(TF.pad(x, (taps - 1, 0)), fir, impl="xla")
        pairs = [("one-shot", r["filtered"], y_ref), ("planned", r["served"], y_ref),
                 ("streamed", r["streamed"], stream_ref)]
        return pairs, lambda: fft_conv(x, fir, padding=taps // 2)

    def serving(r):
        check(r["rejected"] is not None, "the wrong-shape call was not rejected")
        up_image = r["small"].shape[-1]
        feats = fft_conv(r["images"], r["bank"], r["bias"], padding=r["bank"].shape[-1] // 2,
                         impl="xla")

        def up_ref(x):
            return fft_conv_transpose(x, r["up_k"], stride=2, padding=1, impl="xla")

        head = up_ref(torch.tanh(feats)[:, :r["bank"].shape[0], :up_image, :up_image])
        pairs = [("planned conv", r["feats"], feats),
                 ("planned transpose", r["big"], up_ref(r["small"])),
                 ("composed pipeline", r["head"], head)]
        return pairs, lambda: r["conv"](r["images"])

    def filter_bank(r):
        pad = r["bank"].shape[-1] // 2
        pairs = [("responses", r["responses"],
                  fft_conv(r["images"], r["bank"], padding=pad, impl="xla"))]
        pairs += layer_errors("FFTConv2d", r["layer"], r["images"], pad, r["y"])
        return pairs, lambda: fft_conv(r["images"], r["bank"], padding=pad)

    def volume(r):
        pad = r["psf"].shape[-1] // 2
        pairs = [("smoothed", r["smoothed"],
                  fft_conv(r["volumes"], r["psf"], padding=pad, impl="xla"))]
        pairs += layer_errors("FFTConv3d", r["layer"], r["volumes"], pad, r["y"])
        return pairs, lambda: fft_conv(r["volumes"], r["psf"], padding=pad)

    def train(r):
        # the same five steps from the same parameters, every layer on xla
        k = r["model"]["conv1"].kernel_size[0]
        hidden = r["model"]["conv1"].out_channels
        model = torch.nn.ModuleDict({
            "conv1": FFTConv1d(3, hidden, k, padding=k // 2, impl="xla", device=r["x"].device),
            "conv2": FFTConv1d(hidden, 1, k, padding=k // 2, impl="xla", device=r["x"].device)})
        module_from_jax_state(model, r["initial_state"])
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        losses = []
        for _ in r["losses"]:
            opt.zero_grad()
            loss = torch.mean((model["conv2"](torch.relu(model["conv1"](r["x"])))
                               - r["target"]) ** 2)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        pairs = [("losses", torch.tensor(r["losses"], dtype=torch.float64),
                  torch.tensor(losses, dtype=torch.float64))]
        trained = model.state_dict()
        pairs += [(f"trained {name}", value, trained[name])
                  for name, value in r["model"].state_dict().items()]

        def forward():
            with torch.no_grad():
                return r["model"]["conv2"](torch.relu(r["model"]["conv1"](r["x"])))

        return pairs, forward

    examples = [("long_audio_filter", long_audio_filter, audio),
                ("serving_plans", serving_plans, serving),
                ("image_filter_bank_2d", image_filter_bank_2d, filter_bank),
                ("volume_stencil_3d", volume_stencil_3d, volume),
                ("train_fft_cnn", train_fft_cnn, train)]
    path = dict.fromkeys(KERNEL_NAMES, 0)
    for name, module, reference in examples:
        _reset_counts()
        t0 = time.perf_counter()
        r = module.run()
        rose = _counts(torch)
        run_s = time.perf_counter() - t0
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want.update(EXAMPLE_LAUNCHES[name])
        check(rose == want, f"example {name} launched {rose}, not {want}")
        for k in KERNEL_NAMES:
            path[k] += rose[k]
        pairs, main_call = reference(r)
        errs = _errors(pairs)
        print(json.dumps({"phase": "examples", "example": name,
                          "launches": {k: v for k, v in rose.items() if v},
                          "max_and_mean_abs_err_vs_xla": errs, "run_s": run_s,
                          "call_ms": call_ms(main_call), "ms": device_ms(main_call)}))
        if name == "volume_stencil_3d":
            volume_r = r
        del r
        torch.cuda.synchronize()
    print(json.dumps({"phase": "main_path_counts", "kernels": "examples", "launches": path}))

    # the volume example's call under impl="fused": B3 over two W blocks
    x, psf = volume_r["volumes"], volume_r["psf"]
    pad = psf.shape[-1] // 2
    _reset_counts()
    y = fft_conv(x, psf, padding=pad, impl="fused")
    rose = _counts(torch)
    check(rose["B3"] >= 1 and sum(rose.values()) == rose["B3"],
          f"the fused volume call launched {rose}, not B3 alone")
    mx, mean, _ = close_scaled(y, volume_r["smoothed"], "fused volume vs composed")
    print(json.dumps({"phase": "examples", "case": "volume_stencil_3d call, impl='fused' "
                      "(70^3 padded, two W blocks)", "launches": rose["B3"], "kernel": "B3",
                      "max_abs_err_vs_composed": mx, "mean_abs_err": mean,
                      "fused_ms": device_ms(lambda: fft_conv(x, psf, padding=pad,
                                                             impl="fused")),
                      "auto_ms": device_ms(lambda: fft_conv(x, psf, padding=pad))}))
    torch.cuda.synchronize()


def phase_sweep(torch, rows1d, rows2d, rows3d):
    """Phase 12, ``bench.generate_benchmark_plot.run_sweep`` on the card at
    SWEEP_KS, counted from zero: every (config, K, method) row present but
    the fused rows whose plan does not fit, each time finite and positive,
    the allocator's peak read, B1, B2 and B3 launched; the checkpoint holds
    the rows; ``plot`` writes a PNG or prints its skip line. At one K per
    rank the methods are held to the baselines, and the sweep's fft_conv
    time printed beside phase 5's auto_ms."""
    import dataclasses
    import io
    import tempfile
    from contextlib import redirect_stdout
    from importlib.util import find_spec

    from fft_conv_tpu_torch.bench import generate_benchmark_plot as gbp
    from fft_conv_tpu_torch.kernels.fused1d import choose_fft_size
    from fft_conv_tpu_torch.kernels.fused2d import fused2d_fits
    from fft_conv_tpu_torch.kernels.fused3d import plan_3d_blocked

    def fits(cfg, k, transposed):
        # the gates of the fused wrappers, at the padded (stuffed) size
        s = cfg.input_size + (2 * k - 2 if transposed else 0)
        b, cin, cout = cfg.batch_size, cfg.in_channels, cfg.out_channels
        if cfg.ndim == 1:
            return choose_fft_size(k, s, cin, cout, batch=b) is not None
        if cfg.ndim == 2:
            return fused2d_fits(k, k, cin, cout, (s, s), batch=b)
        return plan_3d_blocked(cin, cout, s, s, s, k, k, k) is not None

    configs = [dataclasses.replace(c, kernel_sizes=ks) for c, ks in zip(gbp.CONFIGS, SWEEP_KS)]
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = os.path.join(tmp, "benchmark_results.json")
        _reset_counts()
        t0 = time.perf_counter()
        rows = gbp.run_sweep(configs, checkpoint_path=checkpoint)
        sweep_s = time.perf_counter() - t0
        rose = _counts(torch)
        with open(checkpoint) as f:
            check(json.load(f) == rows, "the checkpoint does not hold the sweep's rows")
        printed = io.StringIO()
        with redirect_stdout(printed):
            gbp.plot(rows, os.path.join(tmp, "benchmark.png"))
    plot_line = printed.getvalue().strip()
    check(plot_line == ("matplotlib unavailable; skipping plot" if find_spec("matplotlib") is None
                        else f"wrote {os.path.join(tmp, 'benchmark.png')}"),
          f"plot printed {plot_line!r}")
    check(all(rose[k] > 0 for k in ("B1", "B2", "B3")), f"the sweep launched {rose}")
    want = [(c.label, k, m) for c in configs for k in c.kernel_sizes for m in gbp._methods(c.ndim)
            if "fused" not in m or fits(c, k, "transpose" in m)]
    got = [(r["config"], r["kernel_size"], r["method"]) for r in rows]
    check(got == want, f"the sweep's rows {got} are not {want}")
    for r in rows:
        check(r["time_mean_s"] is not None and math.isfinite(r["time_mean_s"])
              and r["time_mean_s"] > 0, f"{r}: no finite positive time")
        check(r["peak_mem_source"] == "cuda_allocator" and r["peak_mem_gib"] > 0,
              f"{r}: the allocator's peak was not read")
        check(r["platform"] == torch.cuda.get_device_name(), f"{r}: platform")

    # at one K per rank: the FFT methods against the baselines
    gen = torch.Generator().manual_seed(12)
    held = {}
    for cfg, k in zip(configs, SWEEP_HELD_K):
        shape = (cfg.batch_size, cfg.in_channels) + (cfg.input_size,) * cfg.ndim
        sig = torch.randn(shape, generator=gen).cuda()
        ker = torch.randn((cfg.out_channels, cfg.in_channels) + (k,) * cfg.ndim,
                          generator=gen).cuda()
        ker_t = ker.transpose(0, 1).contiguous()
        bias = torch.randn(cfg.out_channels, generator=gen).cuda()
        methods = gbp._methods(cfg.ndim)
        naive = methods["naive_conv"](sig, ker, bias)
        naive_t = methods["naive_conv_transpose"](sig, ker_t, bias)
        for m in ("fft_conv", "fft_conv_fused"):
            held[f"{cfg.label} K={k} {m}"] = close_scaled(
                methods[m](sig, ker, bias), naive, f"sweep {cfg.label} K={k} {m}")[0]
        for m in ("fft_conv_transpose", "fft_conv_transpose_fused"):
            held[f"{cfg.label} K={k} {m}"] = close_scaled(
                methods[m](sig, ker_t, bias), naive_t, f"sweep {cfg.label} K={k} {m}")[0]
    phase5 = {("1D", r["K"]): r["auto_ms"] for r in rows1d}
    phase5.update({("2D", r["K"]): r["auto_ms"] for r in rows2d})
    phase5.update({("3D", r["K"]): r["auto_ms"] for r in rows3d if r["dhw"] == [64, 64, 64]})
    beside = [{"config": r["config"], "K": r["kernel_size"],
               "sweep_fft_conv_ms": r["time_mean_s"] * 1e3,
               "phase5_auto_ms": phase5[(r["config"], r["kernel_size"])]}
              for r in rows if r["method"] == "fft_conv"
              and (r["config"], r["kernel_size"]) in phase5]
    print(json.dumps({"phase": "sweep", "rows": len(rows), "sweep_s": sweep_s,
                      "launches": {k: v for k, v in rose.items() if v},
                      "max_abs_err_vs_baseline": held, "plot": plot_line,
                      "fft_conv_beside_auto": beside}))
    print(json.dumps({"phase": "sweep", "ms": {
        f"{r['config']} K={r['kernel_size']} {r['method']}": r["time_mean_s"] * 1e3
        for r in rows}}))
    torch.cuda.synchronize()


def kernel_entry(name, source, replaces, launches, errs, rows):
    """One entry of the ``kernels`` line: the sums over the timed rows."""
    from fft_conv_tpu_torch.kernels.costs import bound

    def total(key):
        return sum(r.get(key, 0) for r in rows)

    library = [r["library_ms"] for r in rows]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(errs),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": bound(total("bytes"), total("flops"), total("bf16_flops"))[1],
        "library_ms": None if None in library else sum(library), "shapes": rows,
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
    from fft_conv_tpu_torch.kernels.costs import (
        bound, fused1d_dense_work, fused1d_kernel_flops, fused1d_work)
    from fft_conv_tpu_torch.kernels import _build, fused1d
    from fft_conv_tpu_torch.ops import plan_fft_conv

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
        name: [ln.strip() for ln in log.splitlines()
               if "entry function" in ln or "registers" in ln or "spill" in ln]
        for name, log in _build.build_logs.items()
    }
    print(json.dumps({"phase": "build", "seconds": round(build_s, 2),
                      "libraries": {k: str(v.relative_to(HERE)) for k, v in paths.items()},
                      "ptxas": ptxas}))
    for name in ("fused1d", "fused2d", "fused3d"):
        if name not in _build.build_logs:  # built by an earlier run: again, for its report
            paths[name].unlink()
            _build.build([name])
    spills = ptxas_spills(_build.build_logs["fused1d"])
    # the FP32 pair: both phases at N1 = 16, 32, 64, each at 256 and 512
    # threads; the tensor-core pair: the same under "bf16x3" and under
    # "bf16", each entry point holding HMMA (tensor-core) instructions
    entries = [fn for fn in spills if "fused1d_" in fn and "_tc" not in fn]
    tc_entries = [fn for fn in spills if "fused1d_" in fn and "_tc" in fn]
    check(len(entries) == 12 and len(tc_entries) == 24
          and not any(sum(v) for v in spills.values()),
          f"B1's 36 entry points spill registers or are missing: {spills}")
    hmma = {fn: c for fn, c in sass_hmma(paths["fused1d"]).items() if "fused1d_" in fn}
    check(sorted(fn for fn in hmma if "_tc" in fn) == sorted(tc_entries)
          and all(hmma[fn] > 0 for fn in tc_entries),
          f"B1's tensor-core entry points lack HMMA instructions: {hmma}")
    print(json.dumps({"phase": "ptxas", "kernel": "B1", "spill_bytes": spills,
                      "registers": ptxas_registers(_build.build_logs["fused1d"]),
                      "sass_hmma": hmma}))
    # B5: both phases at each of the four tile plans
    spills = {fn: v for fn, v in ptxas_spills(_build.build_logs["fused2d"]).items()
              if "fused2d_v3_" in fn and "_tc" not in fn}
    check(len(spills) == 8 and not any(sum(v) for v in spills.values()),
          f"B5's 8 entry points spill registers or are missing: {spills}")
    print(json.dumps({"phase": "ptxas", "kernel": "B5", "spill_bytes": spills}))
    # B2's tensor-core route: phase 1, the MAC stage and the inverse stage at
    # each of the four tile plans under "bf16x3" and under "bf16", each
    # holding HMMA instructions; B5's: its phase 1 and inverse stage likewise,
    # each holding HMMA instructions, and B2's MAC stage without its W DFT
    # (MODE 0) at each plan, which holds none
    def b5_mac(fn):
        return re.search(r"fused2d_mac_tcILi\d+ELi\d+ELi0E", fn) is not None

    def route(fn):
        return "B5" if "fused2d_v3_" in fn or b5_mac(fn) else "B2"

    spills = {fn: v for fn, v in ptxas_spills(_build.build_logs["fused2d"]).items()
              if "fused2d_" in fn and "_tc" in fn}
    hmma = {fn: c for fn, c in sass_hmma(paths["fused2d"]).items()
            if "fused2d_" in fn and "_tc" in fn}
    regs = {fn: r for fn, r in ptxas_registers(_build.build_logs["fused2d"]).items()
            if "_tc" in fn}
    for name, count in (("B2", 24), ("B5", 20)):
        mine = {fn: v for fn, v in spills.items() if route(fn) == name}
        check(len(mine) == count and not any(sum(v) for v in mine.values()),
              f"{name}'s {count} tensor-core entry points spill registers or are missing: {mine}")
        counts = {fn: c for fn, c in hmma.items() if route(fn) == name}
        check(sorted(counts) == sorted(mine)
              and all((c == 0) == b5_mac(fn) for fn, c in counts.items()),
              f"{name}'s tensor-core entry points lack HMMA instructions: {counts}")
        print(json.dumps({"phase": "ptxas", "kernel": f"{name} tensor-core route",
                          "spill_bytes": mine,
                          "registers": {fn: r for fn, r in regs.items() if route(fn) == name},
                          "sass_hmma": counts}))
    # B3, B4 and B6: every entry point of fused3d.cu (the dense H/W kernels
    # at SB = 4, 2, 1, direct and packed; the factored ones built for H = 16,
    # 32, 64, 128 and the one that takes any split, direct and packed; the D
    # kernels d_mac at 8, 4, 2, 1 and tap_mac at 4, 2, 1 output channels a
    # block; the pack kernel; B7; the tensor-core kernels under "bf16x3" and
    # "bf16": hw_forward_tc direct at the splits (8, 8), (8, 6), (13, 6), (7,
    # 12) and the one taken as arguments, packed at (8, 8) and at the one
    # taken as arguments, hw_inverse_tc at the five, d_mac_tc at 4, 2, 1
    # output channels a block, each holding HMMA instructions), and every
    # entry point's registers; the tensor-core kernels within the 128
    # registers that let two blocks share an SM (16 warps: d_mac_tc's 264
    # blocks at 64^3 in one wave)
    spills = ptxas_spills(_build.build_logs["fused3d"])
    tc_entries = [fn for fn in spills if "_tc" in fn]
    check(len(spills) == 63 and len(tc_entries) == 30 and not any(sum(v) for v in spills.values()),
          f"fused3d.cu's 63 entry points spill registers or are missing: {spills}")
    hmma = {fn: c for fn, c in sass_hmma(paths["fused3d"]).items() if "_tc" in fn}
    check(sorted(hmma) == sorted(tc_entries) and all(c > 0 for c in hmma.values()),
          f"fused3d.cu's tensor-core entry points lack HMMA instructions: {hmma}")
    regs = ptxas_registers(_build.build_logs["fused3d"])
    tc_regs = {fn: r for fn, r in regs.items() if "_tc" in fn}
    check(len(tc_regs) == 30 and max(tc_regs.values()) <= 128,
          f"a tensor-core kernel of fused3d.cu takes more than 128 registers: {tc_regs}")
    print(json.dumps({"phase": "ptxas", "kernel": "B3, B4, B6, B7 and B3's, B4's tensor-core "
                      "chains", "spill_bytes": spills, "registers": regs, "sass_hmma": hmma,
                      "build_s": round(build_s, 2)}))
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

    # phase 3a: each kernel against its plain version, at the main path's
    # shapes and the cases around them
    print("tolerance: err_mean < 2e-5*sigma and err_max < 1.2e-4*sigma, "
          "sigma = max(1, std(ref)) (tests/helpers.py:_assert_close_scaled)")
    errs = check_fused1d(torch, dev, inputs)
    inputs2d, errs2d = check_fused2d(torch, dev, gen)
    errs2v3 = check_fused2d_v3(torch, dev, gen, inputs2d)
    inputs3d, errs3d = check_fused3d(torch, dev, gen)
    inputs3t, errs3t = check_fused3d_tap(torch, dev, gen)
    timed_pack, errs_pack = check_pack3d(torch, dev, gen, inputs3d)

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
    per_row2v3, main_launches2v3 = main_path_2d_v3(torch, inputs2d)
    main_path_transposed(torch, inputs, inputs2d)
    per_row3d, main_launches3d = main_path_3d(torch, inputs3d)
    per_row3t, main_launches3t, t_inputs = main_path_3d_tap(torch, inputs3t)
    main_launches_pack = main_path_pk(torch, inputs3d)
    main_path_plans(torch, inputs, inputs2d, inputs3d, inputs3t)

    # phase 5: timings. "*_ms" is device time (CUDA graph replay), "*_call_ms"
    # the latency a caller sees; inputs stay in L2 between calls, as for a
    # caller that has just made them. The card's busy share during a call of
    # fft_conv(impl="auto") is its device time over its call latency.
    shapes = []
    for (b, cin, cout, l, k), (x, w, bias, n), err, nl in zip(
        BENCH_SHAPES, inputs, errs, per_shape_launches
    ):
        spectra = fused1d.kernel_spectra_one_sided(w, n)
        planned = plan_fft_conv(w, signal_spatial=(l,), max_batch=b)

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
            # B1's two kernels, one by one (device time per call)
            "phase_ms": phase_split_ms(torch, kernel, "fused1d_"),
            "spectra_ms": device_ms(lambda: fused1d.kernel_spectra_one_sided(w, n)),
            "auto_ms": device_ms(auto),
            "auto_call_ms": call_ms(auto),
            "plan_ms": device_ms(lambda: planned(x)),
            "plan_call_ms": call_ms(lambda: planned(x)),
            "composed_ms": device_ms(composed),
            "composed_call_ms": call_ms(composed),
            # the plain version copies its constants from the host on every
            # call, which a CUDA graph cannot capture: call latency only
            "plain_ms": call_ms(lambda: fused1d._fused_forward_reference(x, w, n)),
            "library_ms": device_ms(lambda: TF.conv1d(x, w)),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_flops": fused1d_kernel_flops(b, cin, cout, l, k, n),
            # the bound of the dense count, every DFT a dense product
            "dense_bound_ms": bound(*fused1d_dense_work(b, cin, cout, l, k, n))[0],
        }
        row["auto_busy_share"] = row["auto_ms"] / row["auto_call_ms"]
        shapes.append(row)
        print(json.dumps({"phase": "timing", **row}))
        torch.cuda.synchronize()

    rows2d = time_2d(torch, inputs2d, errs2d, per_row2d)
    rows2v3 = time_2d_v3(torch, inputs2d, errs2v3, per_row2v3)
    rows3d = time_3d(torch, inputs3d, errs3d, per_row3d)
    rows3t = time_3d_tap(torch, inputs3t, errs3t, per_row3t)
    time_transposed_3d(torch, inputs3t[0][0], t_inputs)
    # phase 5b: the inline spectra (B7 ahead of B3), counted from zero
    main_launches_b7, errs_b7, rows_b7 = phase_inline(torch, gen, inputs3d, inputs3t[0][0],
                                                      t_inputs)
    time_transposed_1d_2d(torch, inputs, inputs2d)
    time_tier3(torch, inputs2d)
    rows_pack = time_pack3d(torch, timed_pack)
    # phase 5c: B1's precision modes (the tensor-core pair), counted from zero
    precision = phase_precision(torch, dev, inputs, shapes)
    # phase 5d: B2's precision modes (its tensor-core route), counted from zero
    precision2d = phase_precision_2d(torch, inputs2d, rows2d)
    # phase 5e: B3's and B4's precision modes (their tensor-core chains),
    # counted from zero
    precision3d = phase_precision_3d(torch, inputs3d, inputs3t, t_inputs, rows3d, rows3t)

    # phases 6 to 8: the streaming path (counted from zero), the
    # measurement modules, checkpoints
    phase_streaming(torch, inputs, shapes)
    phase_harness(torch, inputs, shapes)
    phase_checkpoint(torch, inputs)
    # phase 9: impl="tiled" (cuBLAS products, no kernel)
    phase_tiled(torch, inputs, inputs2d, inputs3d)
    # phase 10: the parallel package on a one-rank NCCL group (B1, B2, B3)
    phase_parallel(torch, inputs, inputs2d, inputs3d)
    # phase 11: the five examples at the JAX scripts' sizes
    phase_examples(torch)
    # phase 12: the benchmark sweep at SWEEP_KS
    phase_sweep(torch, shapes, rows2d, rows3d)
    check("jax" not in sys.modules and "fft_conv_tpu" not in sys.modules,
          "the port pulled in JAX or the JAX package")

    print(json.dumps({"kernels": [
        kernel_entry("B1_fused1d", "fft_conv_tpu_torch/kernels/csrc/fused1d.cu",
                     "fft_conv_tpu/kernels/fused1d.py:291", main_launches, errs, shapes),
        kernel_entry("B2_fused2d", "fft_conv_tpu_torch/kernels/csrc/fused2d.cu",
                     "fft_conv_tpu/kernels/fused2d.py:308", main_launches2d, errs2d, rows2d),
        kernel_entry("B5_fused2d_v3", "fft_conv_tpu_torch/kernels/csrc/fused2d.cu",
                     "fft_conv_tpu/kernels/fused2d.py:419", main_launches2v3, errs2v3,
                     rows2v3),
        kernel_entry("B3_fused3d", "fft_conv_tpu_torch/kernels/csrc/fused3d.cu",
                     "fft_conv_tpu/kernels/fused3d.py:735", main_launches3d, errs3d, rows3d),
        kernel_entry("B4_fused3d_tap", "fft_conv_tpu_torch/kernels/csrc/fused3d.cu",
                     "fft_conv_tpu/kernels/fused3d.py:1233", main_launches3t, errs3t, rows3t),
        kernel_entry("B6_pack3d", "fft_conv_tpu_torch/kernels/csrc/fused3d.cu",
                     "fft_conv_tpu/kernels/fused3d.py:1184", main_launches_pack, errs_pack,
                     rows_pack),
        kernel_entry("B7_fused3d_spectra", "fft_conv_tpu_torch/kernels/csrc/fused3d.cu",
                     "fft_conv_tpu/kernels/fused3d.py:792", main_launches_b7, errs_b7,
                     rows_b7),
    ] + [
        kernel_entry(f"B1_fused1d_{mode}", "fft_conv_tpu_torch/kernels/csrc/fused1d.cu",
                     "fft_conv_tpu/kernels/fused1d.py:291", *precision[mode])
        for mode in fused1d.PRECISION_MODES[1:]
    ] + [
        kernel_entry(f"{name}_{mode}", "fft_conv_tpu_torch/kernels/csrc/fused2d.cu",
                     replaces, *precision2d[f"{name[:2]}_{mode}"])
        for mode in fused1d.PRECISION_MODES[1:]
        for name, replaces in (("B2_fused2d", "fft_conv_tpu/kernels/fused2d.py:308"),
                               ("B5_fused2d_v3", "fft_conv_tpu/kernels/fused2d.py:419"))
    ] + [
        kernel_entry(f"{name}_{mode}", "fft_conv_tpu_torch/kernels/csrc/fused3d.cu",
                     replaces, *precision3d[mode][i])
        for mode in fused1d.PRECISION_MODES[1:]
        for i, (name, replaces) in enumerate((
            ("B3_fused3d", "fft_conv_tpu/kernels/fused3d.py:735"),
            ("B4_fused3d_tap", "fft_conv_tpu/kernels/fused3d.py:1233")))
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
