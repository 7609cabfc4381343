"""The port's measurement modules on the CPU: the harness against the JAX
package's (``tests/test_bench_utils.py``'s cases), the kernels' cost counts
of ``kernels/costs.py`` pinned at the benchmark shapes, and the cost records
that ``cost_analysis`` reads."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import fft_conv_tpu_torch as ft
from fft_conv_tpu import benchmark_utils as jax_bu
from fft_conv_tpu_torch import benchmark_utils as bu
from fft_conv_tpu_torch.bench import harness
from fft_conv_tpu_torch.bench.profiling import cost_analysis
from fft_conv_tpu_torch.kernels import _build, costs, fused1d, fused2d, fused3d


def test_benchmark_strings_equal_jax():
    for mean, std in [(1.234e-3, 5.6e-5), (2.0, 0.0), (7.5e-7, 1.25e-8)]:
        ours, theirs = bu.Benchmark(mean=mean, std=std), jax_bu.Benchmark(mean=mean, std=std)
        assert repr(ours) == repr(theirs)
        assert str(ours) == str(theirs)
    assert repr(bu.Benchmark(1.234e-3, 5.6e-5)) == (
        "BenchmarkResult(mean: 1.234e-03, std: 5.600e-05)")
    assert str(bu.Benchmark(1.234e-3, 5.6e-5)) == "(1.234e-03 ± 5.600e-05) s"


def test_alias_exports_the_jax_names():
    assert sorted(bu.__all__) == sorted(jax_bu.__all__)
    for name in bu.__all__:
        assert getattr(bu, name) is getattr(harness, name)


def test_measure_records_time_and_memory():
    with bu.measure() as r:
        torch.ones((128, 128)).sum()
    assert r["time"] > 0
    assert r["memory"] == 0.0  # no card: the allocator is not read


def test_benchmark_drops_warmup():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones((8,))

    t, m = bu.benchmark(fn, num_iterations=5)
    assert len(calls) == 5
    assert t.mean >= 0 and m.mean == 0.0


def test_benchmark_chained_runs():
    sig, ker = torch.ones((2, 3, 64)), torch.ones((4, 3, 9))
    t = bu.benchmark_chained(ft.fft_conv, sig, ker, num_iterations=4)
    assert t.mean > 0


def test_benchmark_fori_is_a_plain_loop_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = harness.benchmark_fori(fn, torch.ones(4), num_iterations=3)
    assert len(calls) == 4  # one warm-up call and three timed
    assert t.mean > 0


def test_peak_memory_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.peak_memory_gib(lambda: None)


def test_assert_almost_equal_thresholds():
    x = np.zeros(10, np.float32)
    assert bu._assert_almost_equal(x, x + 4e-5)  # mean 4e-5 < 5e-5, max < 1e-4
    with pytest.raises(AssertionError):
        bu._assert_almost_equal(x, x + 6e-5)  # mean above threshold
    y = x.copy()
    y[0] = 2e-4  # max above 1e-4, mean fine
    with pytest.raises(AssertionError):
        bu._assert_almost_equal(x, y)


def test_assert_almost_equal_takes_tensors():
    x = torch.zeros(10, requires_grad=True)
    assert bu._assert_almost_equal(x, torch.full((10,), 4e-5))
    with pytest.raises(AssertionError):
        bu._assert_almost_equal(x, np.full(10, 6e-5, np.float32))


def test_gcd():
    for a, b in [(12, 8), (3, 2), (7, 0), (0, 5), (48, 180)]:
        assert bu._gcd(a, b) == jax_bu._gcd(a, b)
    assert bu._gcd(12, 8) == 4


def test_roofline_helpers():
    assert bu.hbm_gbps(1e9, 1.0) == pytest.approx(1.0)
    assert bu.hbm_gbps(1e9, 0.0) == float("inf")
    for shapes in [((2, 3, 100), (4, 3, 10), (2, 4, 91)), ((2, 8, 512, 512), (8, 8, 16, 16),
                                                           (2, 8, 497, 497))]:
        assert bu.fft_conv_bytes(*shapes) == jax_bu.fft_conv_bytes(*shapes)
        assert bu.fft_conv_bytes(*shapes, dtype_bytes=2) == jax_bu.fft_conv_bytes(
            *shapes, dtype_bytes=2)
    assert bu.fft_conv_bytes((2, 3, 100), (4, 3, 10), (2, 4, 91)) == (600 + 120 + 728) * 4


def test_repo_cache_dir_is_the_kernels_build_directory():
    assert harness.repo_cache_dir() == str(_build.BUILD_DIR)


# the benchmark rows (B=2, 8 -> 8 channels) and their bound_ms as PERF.md
# gives them, to 5 decimals
@pytest.mark.parametrize("l,k,want", [(32768, 256, 0.00142), (32768, 1024, 0.00157),
                                      (32768, 3840, 0.00182)])
def test_bound_1d_at_the_benchmark_rows(l, k, want):
    n = fused1d.choose_fft_size(k, l, 8, 8, batch=2)
    assert round(costs.bound(*costs.fused1d_work(2, 8, 8, l, k, n))[0], 5) == want


@pytest.mark.parametrize("k,bound_ms,b2_gflop,b5_gflop", [(16, 0.01100, 0.630, 0.616),
                                                          (34, 0.01066, 0.906, 0.857)])
def test_counts_2d_at_the_benchmark_rows(k, bound_ms, b2_gflop, b5_gflop):
    plan = fused2d.tile_plan_2d(k, k, 8, 8)
    shape = (2, 8, 8, 512, 512, k, plan)
    assert costs.bound(*costs.fused2d_work(*shape))[1] == "bytes"
    assert round(costs.bound(*costs.fused2d_work(*shape))[0], 5) == bound_ms
    assert round(costs.fused2d_kernel_flops(*shape) / 1e9, 3) == b2_gflop
    assert round(costs.fused2d_v3_kernel_flops(*shape) / 1e9, 3) == b5_gflop


def test_counts_3d_at_the_benchmark_rows():
    assert round(costs.bound(*costs.fused3d_work(2, 8, 8, 64, 64, 64, 8))[0], 5) == 0.01371
    ms, by = costs.bound(*costs.fused3d_tap_work(2, 8, 8, 64, 64, 64, 10))
    assert (round(ms, 5), by) == (0.01998, "operations")
    pack = [costs.bound(costs.pack3d_bytes(2, 8, s, s, s, 40, nwb), 0)[0]
            for s, nwb in ((64, 1), (78, 2))]
    assert [round(p, 5) for p in pack] == [0.01127, 0.02433]


@pytest.mark.parametrize("h,nbytes,bound_ms", [
    (64, 17432576, 0.00520), (48, 13238272, 0.00395), (78, 21102592, 0.00630)])
def test_spectra_counts_at_the_3d_rows(h, nbytes, bound_ms):
    """B7 at the 8 -> 8, K=8 rows (64^3, 48^3 and the stuffed 78^3 of the
    transposed call): 131 KB of taps read and the spectra (8, 8, 16, Hw/2+1,
    64) complex64 written (17.3 MB at 64^3), bytes bound; the kernel does no
    less than the separable least work."""
    got, flops = costs.fused3d_spectra_work(8, 8, h, 8)
    assert got == nbytes == 8 * 8 * (4 * 512 + 8 * 16 * (h // 2 + 1) * 64)
    ms, by = costs.bound(got, flops)
    assert (round(ms, 5), by) == (bound_ms, "bytes")
    assert flops <= costs.fused3d_spectra_kernel_flops(8, 8, h, 8)


def test_d_stage_counts_3d_at_the_benchmark_rows():
    """B3's and B4's D kernels at the 64^3 rows: the kernels' own flops (B3's
    DFT-16 factored 4 x 4 at one output a lane, the tap MAC onto chunks of 8
    d; the H/W kernels' radix-2 H steps take root[n/4] = -i as a swap), and
    the D stages' bounds, T and the spectra in and Z out (50.0 and 43.0 MB):
    bytes bind B3's, operations B4's. The least work of each stage is part
    of its chain's and no more than the kernel does."""
    assert round(costs.fused3d_kernel_flops(2, 8, 8, 64, 64, 64, 8) / 1e9, 3) == 0.677
    assert round(costs.fused3d_tap_kernel_flops(2, 8, 8, 64, 64, 64, 10) / 1e9, 3) == 1.409
    d_bytes, d_flops = costs.fused3d_d_work(2, 8, 8, 64, 64, 64, 8)
    t_bytes, t_flops = costs.fused3d_tap_mac_work(2, 8, 8, 64, 64, 64, 10)
    assert (d_bytes, t_bytes) == (50012160, 42983424)
    ms, by = costs.bound(d_bytes, d_flops)
    assert (round(ms, 5), by) == (0.01493, "bytes")
    ms, by = costs.bound(t_bytes, t_flops)
    assert (round(ms, 5), by) == (0.01775, "operations")
    assert d_flops < costs.fused3d_work(2, 8, 8, 64, 64, 64, 8)[1]
    assert t_flops < costs.fused3d_tap_work(2, 8, 8, 64, 64, 64, 10)[1]
    assert t_flops <= costs.fused3d_tap_kernel_flops(2, 8, 8, 64, 64, 64, 10)


# (H = D = W, K, chain bytes, chain bound, by, kernel GFLOP, H/W stage bytes,
# H/W stage bound): B3 and B4 at 48^3 (Hw = 48 = 8 x 6), the stuffed 78^3 of
# the transposed K=8 call (B3, Hw = 78 = 13 x 6) and 82^3 of K=10 (B4, Hw =
# 84 = 7 x 12), B=2, 8 -> 8
MIXED_ROWS = [
    (48, 8, 24596032, 0.00734, "bytes", 0.389, 29716032, 0.00887),
    (48, 10, 19066304, 0.01063, "operations", 0.771, 28691904, 0.00856),
    (78, 8, 74249152, 0.02417, "operations", 2.173, 150926272, 0.04505),
    (82, 10, 73947200, 0.07722, "operations", 5.422, 166844480, 0.04980),
]


@pytest.mark.parametrize("s,k,nbytes,bound_ms,by,kernel_gflop,hw_bytes,hw_ms", MIXED_ROWS)
def test_counts_3d_at_mixed_radix_rows(s, k, nbytes, bound_ms, by, kernel_gflop, hw_bytes, hw_ms):
    """Least work at the signal's own H: an H that splits into factors of at
    most 16 is counted as that four-step transform (78 = 13 x 6 through the
    real-symmetric 13-point DFT), and 82 through 41 x 2, so the bound does
    not credit the kernels' padding to Hw = 84 and counts no dense H DFT.
    The kernels' own flops are counted at Hw. The H/W stage (the signal and
    T, Z and the output, once each at the signal's NBH) is bytes-bound."""
    work = costs.fused3d_work if k <= 9 else costs.fused3d_tap_work
    kernel = costs.fused3d_kernel_flops if k <= 9 else costs.fused3d_tap_kernel_flops
    got_bytes, flops = work(2, 8, 8, s, s, s, k)
    ms, got_by = costs.bound(got_bytes, flops)
    assert (got_bytes, round(ms, 5), got_by) == (nbytes, bound_ms, by)
    assert round(kernel(2, 8, 8, s, s, s, k) / 1e9, 3) == kernel_gflop
    hw = costs.fused3d_hw_work(2, 8, 8, s, s, s, k)
    assert hw[0] == hw_bytes and costs.bound(*hw) == (pytest.approx(hw_ms, abs=5e-6), "bytes")
    # least work: no more than the kernels do, and less than every dense count
    assert hw[1] < flops <= kernel(2, 8, 8, s, s, s, k)
    assert ms < costs.bound(*work(2, 8, 8, s, s, s, k, dense=True))[0]
    assert costs._split(s) == ({48: (8, 6), 78: (13, 6), 82: (41, 2)}[s])


def test_symmetric_short_dfts_count_their_terms():
    """The 3D H steps' short DFTs of lengths that are not powers of two run
    the real-symmetric form (csrc/fused3d.cu: dft_emit): 18 flops for the
    kernel's 3-point DFT (s and d 4, X[0] 2, one complex-by-real FMA pair
    each for P and Q 8, X[1] and X[2] 4) and 16 of least work (Q's first
    product a multiply); B2's 24-point DFT keeps the dense count."""
    assert costs._short_dft_flops(3, 3, 3, True) == 18
    assert costs._short_dft_flops(3, 3, 3, False) == 16
    assert costs._short_dft_flops(13, 13, 13, True) == 348
    for n in (5, 6, 7, 9, 10, 11, 12, 13, 14, 15):
        assert costs._short_dft_flops(n, n, n, False) <= costs._short_dft_flops(n, n, n, True)
    assert costs._short_dft_flops(24, 24, 24, True) == 24 * (2 * 23) + 6 * sum(
        1 for m in range(24) for j in range(24) if m * j % 24)


def test_int_and_tuple_kernel_sizes_count_alike():
    plan = fused2d.tile_plan_2d(16, 16, 8, 8)
    assert costs.fused2d_work(2, 8, 8, 512, 512, 16, plan) == costs.fused2d_work(
        2, 8, 8, 512, 512, (16, 16), plan)
    assert costs.fused3d_kernel_flops(2, 8, 8, 64, 64, 64, 8) == costs.fused3d_kernel_flops(
        2, 8, 8, 64, 64, 64, (8, 8, 8))


def test_record_does_nothing_without_a_tally(monkeypatch):
    """Outside a cost_analysis the wrappers enter costs.IDLE and compute no
    count."""
    def fail(*args, **kwargs):
        raise AssertionError("counted without a tally")

    monkeypatch.setattr(costs, "fused1d_kernel_flops", fail)
    monkeypatch.setattr(costs, "fused1d_work", fail)
    assert not costs.active()
    y = ft.fft_conv(torch.ones(1, 2, 300), torch.ones(3, 2, 20), impl="fused")
    assert y.shape == (1, 3, 281) and not costs.active()


def test_cost_analysis_records_b1_exactly():
    """impl="fused" on the CPU runs B1's plain version: the call records
    B1's own count once, and the only flops outside it are those of the
    kernel spectra the unplanned call computes."""
    rng = np.random.default_rng(0)
    b, cin, cout, l, k = 2, 4, 6, 3000, 200
    x = torch.from_numpy(rng.standard_normal((b, cin, l)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((cout, cin, k)).astype(np.float32))
    n = fused1d.choose_fft_size(k, l, cin, cout, batch=b)
    out = cost_analysis(lambda s, kk: ft.fft_conv(s, kk, impl="fused"), x, w)
    want = costs.fused1d_kernel_flops(b, cin, cout, l, k, n)
    assert out["kernels"] == {"B1": {"calls": 1, "flops": want,
                                     "bytes": costs.fused1d_work(b, cin, cout, l, k, n)[0]}}
    spectra = cost_analysis(fused1d.kernel_spectra_one_sided, w, n)["flops"]
    assert spectra > 0 and out["flops"] == want + spectra


def _records(fn):
    out = cost_analysis(fn)
    assert out["flops"] > float(sum(e["flops"] for e in out["kernels"].values()))
    return out["kernels"]


def test_cost_analysis_records_the_2d_and_3d_kernels():
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x2, w2 = t(1, 2, 40, 36), t(2, 2, 5, 3)
    plan = fused2d.tile_plan_2d(5, 3, 2, 2)
    shape2 = (1, 2, 2, 40, 36, (5, 3), plan)
    assert _records(lambda: ft.fft_conv(x2, w2, impl="fused")) == {"B2": {
        "calls": 1, "flops": costs.fused2d_kernel_flops(*shape2),
        "bytes": costs.fused2d_work(*shape2)[0]}}
    fused2d.set_fused2d_kernel("v3")
    try:
        got = _records(lambda: ft.fft_conv(x2, w2, impl="fused"))
    finally:
        fused2d.set_fused2d_kernel("v2")
    assert got == {"B5": {"calls": 1, "flops": costs.fused2d_v3_kernel_flops(*shape2),
                          "bytes": costs.fused2d_work(*shape2)[0]}}

    x3, w3 = t(1, 2, 12, 10, 12), t(2, 2, 3, 3, 3)
    shape3 = (1, 2, 2, 12, 10, 12, (3, 3, 3))
    b3 = {"calls": 1, "flops": costs.fused3d_kernel_flops(*shape3),
          "bytes": costs.fused3d_work(*shape3)[0]}
    assert _records(lambda: ft.fft_conv(x3, w3, impl="fused")) == {"B3": b3}
    fused3d.set_fused3d_xpack("pk")
    try:
        got = _records(lambda: ft.fft_conv(x3, w3, impl="fused"))
    finally:
        fused3d.set_fused3d_xpack("h2")
    plan3, nwb, _ = fused3d.plan_3d_blocked(2, 2, 12, 10, 12, 3, 3, 3)
    assert got == {"B3": b3, "B6": {"calls": 1, "flops": 0,
                                    "bytes": costs.pack3d_bytes(1, 2, 12, 10, 12, plan3[3], nwb)}}

    # under inline B7 computes the spectra: its record and B3's are all the
    # call counts, as no aten op computes spectra
    fused3d.set_fused3d_inline(True)
    try:
        out = cost_analysis(lambda: ft.fft_conv(x3, w3, impl="fused"))
    finally:
        fused3d.set_fused3d_inline(False)
    b7 = {"calls": 1, "flops": costs.fused3d_spectra_kernel_flops(2, 2, 10, (3, 3, 3)),
          "bytes": costs.fused3d_spectra_work(2, 2, 10, (3, 3, 3))[0]}
    assert out["kernels"] == {"B7": b7, "B3": b3}
    assert out["flops"] == b7["flops"] + b3["flops"]
    assert b7["bytes"] == 2 * 2 * (4 * 27 + 8 * 16 * 6 * 64)

    x4, w4 = t(1, 2, 14, 8, 8), t(2, 2, 11, 3, 3)
    shape4 = (1, 2, 2, 14, 8, 8, (11, 3, 3))
    assert _records(lambda: ft.fft_conv(x4, w4, impl="fused")) == {"B4": {
        "calls": 1, "flops": costs.fused3d_tap_kernel_flops(*shape4),
        "bytes": costs.fused3d_tap_work(*shape4)[0]}}


def _spectra_1d(w, x):
    n = fused1d.choose_fft_size(w.shape[-1], x.shape[-1], w.shape[1], w.shape[0],
                                batch=x.shape[0])
    return fused1d.kernel_spectra_one_sided(w, n)


def _spectra_2d(w, x):
    t1, _, nb1, t2, _ = fused2d.tile_plan_2d(*w.shape[2:], w.shape[1], w.shape[0])
    return fused2d.kernel_spectra_2d(w, t1, nb1, t2)


# (signal shape, kernel shape, kernel, the spectra the unplanned call computes)
UNPLANNED = [
    ((2, 3, 900), (4, 3, 70), "B1", _spectra_1d),
    ((1, 2, 40, 36), (2, 2, 5, 3), "B2", _spectra_2d),
    ((1, 2, 12, 10, 12), (2, 2, 3, 3, 3), "B3",
     lambda w, x: fused3d.kernel_spectra_3d(w, x.shape[3])),
    ((1, 2, 14, 8, 8), (2, 2, 11, 3, 3), "B4",
     lambda w, x: fused3d.kernel_spectra_tap(w, x.shape[3])),
]


@pytest.mark.parametrize("x_shape,w_shape,kernel,spectra", UNPLANNED,
                         ids=[u[2] for u in UNPLANNED])
def test_unplanned_call_counts_its_kernel_spectra(x_shape, w_shape, kernel, spectra):
    """An unplanned fused call computes the kernel spectra ahead of its
    kernel's record: cost_analysis counts their transforms on top of the
    kernel's own flops, as XLA's cost analysis counts the JAX package's
    spectra outside the pallas_call."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(w_shape).astype(np.float32))
    out = cost_analysis(lambda: ft.fft_conv(x, w, impl="fused"))
    assert list(out["kernels"]) == [kernel]
    alone = out["kernels"][kernel]["flops"]
    extra = cost_analysis(spectra, w, x)["flops"]
    assert extra > 0 and out["flops"] == alone + extra


def test_cost_analysis_counts_aten_ops():
    x = torch.ones(4, 1024)
    out = cost_analysis(torch.fft.rfft, x)
    assert out["flops"] == 0.5 * 2.5 * 1024 * 10 * 4
    assert out["bytes accessed"] == 4 * 1024 * 4 + 4 * 513 * 8
    c = cost_analysis(torch.fft.fft, torch.ones(2, 256, dtype=torch.complex64))
    assert c["flops"] == 2.5 * 256 * 8 * 2
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert cost_analysis(torch.mm, a, b)["flops"] == 2 * 8 * 16 * 4
    assert cost_analysis(lambda t: t.view(16, 8), a)["bytes accessed"] == 0.0
    composed = cost_analysis(lambda s, k: ft.fft_conv(s, k, impl="xla"),
                             torch.ones(1, 2, 256), torch.ones(2, 2, 16))
    assert composed["flops"] > 0 and composed["kernels"] == {}


def test_new_modules_pull_in_no_jax():
    code = (
        "import sys, fft_conv_tpu_torch.benchmark_utils, fft_conv_tpu_torch.bench.profiling, "
        "fft_conv_tpu_torch.kernels.costs, fft_conv_tpu_torch.ops.streaming, "
        "fft_conv_tpu_torch.utils.checkpoint; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fft_conv_tpu' or m.startswith('fft_conv_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
