"""The port's fused 3D path against the JAX package's.

On the CPU the port's wrapper runs the plan's plain version
(``_fused3d_forward_reference`` for kernel B3, ``_fused3d_tap_reference`` for
B4), and the JAX wrapper runs its Pallas kernel in interpret mode with the
bf16x3-exact split, as ``tests/test_pallas3d.py`` runs it. Both are held with
``helpers._assert_close_scaled``, the error model of that precision. The
CUDA kernels themselves are tested on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu_torch.kernels import fused3d

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Cin, Cout, D, H, W, KD, KH, KW, groups, stride, dilation, padding, mode):
# the v4 rows of tests/test_pallas3d.py:CONFIGS (odd sizes, KD = 9 at the hop
# edge, the benchmark-like KD = 8), its stride/dilation cases, the three
# padding modes, groups (2, 3) and (3, 3), and both W-blocked shapes; then
# H = 32 and 128, which take the factored H/W kernels, at odd D (the last
# slab paired with zeros) and odd OD
PARITY = [
    (1, 2, 3, 20, 24, 16, 3, 5, 4, 1, 1, 1, 0, "constant"),
    (2, 4, 4, 32, 32, 32, 4, 4, 4, 1, 1, 1, 2, "constant"),
    (1, 1, 1, 10, 14, 12, 2, 3, 5, 1, 1, 1, 0, "constant"),
    (1, 2, 2, 17, 19, 21, 5, 7, 3, 1, 1, 1, 0, "constant"),
    (1, 1, 2, 24, 16, 16, 9, 3, 3, 1, 1, 1, 1, "constant"),
    (1, 2, 2, 40, 32, 32, 8, 5, 5, 1, 1, 1, 0, "constant"),
    (1, 2, 3, 18, 20, 16, 3, 3, 3, 1, 2, 1, 0, "constant"),
    (1, 2, 3, 18, 20, 16, 3, 3, 3, 1, 1, 2, 0, "constant"),
    (1, 2, 3, 18, 20, 16, 3, 3, 3, 1, (2, 1, 3), 1, 0, "constant"),
    (1, 2, 2, 12, 14, 12, 3, 3, 3, 1, 1, 1, 2, "reflect"),
    (1, 2, 2, 12, 14, 12, 3, 3, 3, 1, 1, 1, 2, "replicate"),
    (1, 2, 2, 12, 14, 12, 3, 3, 3, 1, 1, 1, 2, "circular"),
    (1, 6, 6, 10, 12, 10, 3, 3, 3, 2, 1, 1, 0, "constant"),
    (1, 6, 6, 10, 12, 10, 3, 3, 3, 3, 1, 1, 0, "constant"),
    (2, 2, 3, 10, 8, 200, 2, 2, 7, 1, 1, 1, 0, "constant"),   # nwb = 4
    (1, 1, 1, 8, 8, 122, 2, 2, 7, 1, 1, 1, 0, "constant"),    # nwb = 2, ow = 2 hops
    (1, 2, 3, 11, 32, 20, 3, 3, 3, 1, 1, 1, 0, "constant"),
    (1, 1, 2, 8, 128, 12, 2, 5, 3, 1, 1, 1, 0, "constant"),
    (1, 2, 2, 13, 30, 14, 4, 3, 3, 2, 1, 1, 1, "reflect"),    # H = 32 after padding
]
# tap plans (B4): the KD = 11 rows of tests/test_pallas3d.py (CONFIGS and the
# grouped case of test_fused3d_groups), a W-blocked one, and stride with a
# dilation that takes KD = 6 to 11, under reflect padding; then H = 32 at odd
# D and odd OD, and H = 128, on the factored H/W kernels
TAP_PARITY = [
    (1, 2, 2, 30, 16, 12, 11, 3, 3, 1, 1, 1, 0, "constant"),
    (1, 6, 6, 26, 12, 10, 11, 3, 3, 2, 1, 1, 0, "constant"),
    (1, 2, 2, 24, 10, 100, 10, 3, 5, 1, 1, 1, 0, "constant"),  # nwb = 2
    (1, 2, 3, 24, 14, 12, 6, 3, 3, 1, (2, 1, 2), (2, 1, 1), 1, "reflect"),
    (1, 2, 2, 21, 32, 12, 11, 3, 3, 1, 1, 1, 0, "constant"),
    (1, 1, 2, 12, 128, 10, 10, 3, 3, 1, 1, 1, 0, "constant"),
]


@pytest.mark.parametrize(
    "b,cin,cout,d,h,w,kd,kh,kw,groups,stride,dilation,padding,mode", PARITY + TAP_PARITY
)
def test_plain_version_matches_jax_fused(b, cin, cout, d, h, w, kd, kh, kw, groups,
                                         stride, dilation, padding, mode):
    x, k, bias = _arrays(d + h + w + kd, (b, cin, d, h, w),
                         (cout, cin // groups, kd, kh, kw), (cout,))
    kw_ = dict(padding=padding, padding_mode=mode, stride=stride, dilation=dilation,
               groups=groups)
    y_jax = jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k),
                                         jnp.asarray(bias), **kw_)
    before = fused3d.launches, fused3d.launches_tap
    y = fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw_)
    assert (fused3d.launches, fused3d.launches_tap) == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_tap_rows_plan_tap_in_both_packages():
    for b, cin, cout, d, h, w, kd, kh, kw, groups, _, dil, pad, _ in TAP_PARITY:
        dil = (dil,) * 3 if isinstance(dil, int) else dil
        args = (cin, cout, d + 2 * pad, h + 2 * pad, w + 2 * pad,
                (kd - 1) * dil[0] + 1, (kh - 1) * dil[1] + 1, (kw - 1) * dil[2] + 1, groups)
        assert fused3d.plan_3d_blocked(*args) == jax_fused3d.plan_3d_blocked(*args)
        assert fused3d.plan_3d_blocked(*args)[0][0] == "tap"


def test_fft_conv_fused_3d_matches_jax():
    """The whole slice through the public entry point on both sides."""
    x, k, bias = _arrays(5, (2, 3, 20, 22, 18), (4, 3, 5, 4, 3), (4,))
    kw = dict(padding=(1, 2, 0), stride=(1, 2, 1), impl="fused")
    before = fused3d.launches
    y = ft.fft_conv(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias), **kw)
    assert fused3d.launches == before
    y_jax = fc.fft_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


# (Cin, Cout, D, H, W, KD, KH, KW, groups): padded shapes of the cases above,
# the benchmark row, tap plans (KD > 9), W-blocked plans and shapes that fit
# neither
PLANS = [
    (2, 3, 20, 24, 16, 3, 5, 4, 1), (4, 4, 36, 36, 36, 4, 4, 4, 1),
    (2, 2, 17, 19, 21, 5, 7, 3, 1), (1, 2, 26, 18, 18, 9, 3, 3, 1),
    (8, 8, 64, 64, 64, 8, 8, 8, 1), (6, 6, 10, 12, 10, 3, 3, 3, 3),
    (2, 2, 30, 16, 12, 11, 3, 3, 1), (6, 6, 26, 12, 10, 11, 3, 3, 2),
    (2, 3, 10, 8, 200, 2, 2, 7, 1), (8, 8, 64, 64, 200, 8, 8, 8, 1),
    (1, 1, 8, 8, 122, 2, 2, 7, 1), (1, 1, 8, 8, 300, 2, 2, 70, 1),
    (3, 3, 6, 6, 6, 7, 3, 3, 1), (3, 4, 12, 12, 12, 3, 3, 3, 2),
]


@pytest.mark.parametrize("cin,cout,d,h,w,kd,kh,kw,groups", PLANS)
def test_plans_match_jax(cin, cout, d, h, w, kd, kh, kw, groups):
    args = (cin, cout, d, h, w, kd, kh, kw, groups)
    assert fused3d.plan_3d(*args) == jax_fused3d.plan_3d(*args)
    assert fused3d.plan_3d_blocked(*args) == jax_fused3d.plan_3d_blocked(*args)


def test_plan_fuses_the_benchmark_row():
    """64^3, K=8, 8 -> 8 channels: one W block, the JAX geometry, and spectra
    of 17.3 MB, past the 1D/2D kernels' 16 MiB budget but inside this one."""
    assert fused3d.plan_3d_blocked(8, 8, 64, 64, 64, 8, 8, 8) == (
        ("v4", 33, 40, 40, 8, 32), 1, 57)
    spectra = 16 * 8 * 8 * 33 * 64 * 8
    assert 16 * 2**20 < spectra <= fused3d._SPECTRA_BUDGET
    assert fused3d._slabs_per_block(33) == 4 and fused3d._smem_bytes(33) == 67584
    assert fused3d._scratch_bytes_per_item(8, 8, 64, 33, 8, 57) <= fused3d._SCRATCH_BUDGET


def test_budgets_differ_from_jax_where_intended():
    """ROADMAP §C: the kernel's own budgets replace the TPU's. The port's v4
    plan fits wherever the JAX one does, and also where only the TPU's
    limits refused it."""
    # the TPU kernel unrolls (Cin/g) x Cout MAC statements, at most 128
    assert jax_fused3d.plan_3d(16, 16, 16, 16, 16, 3, 3, 3)[0] == "tap"
    assert fused3d.plan_3d(16, 16, 16, 16, 16, 3, 3, 3)[0] == "v4"
    # the TPU's 96 MiB whole-volume cell; here the scratch of one item counts
    assert jax_fused3d.plan_3d(1, 4, 64, 200, 8, 3, 3, 3)[0] == "tap"
    assert fused3d.plan_3d(1, 4, 64, 200, 8, 3, 3, 3)[0] == "v4"
    assert jax_fused3d.plan_3d(1, 8, 128, 200, 8, 3, 3, 3) is None
    assert fused3d.plan_3d(1, 8, 128, 200, 8, 3, 3, 3)[0] == "v4"
    # the stuffed 78^3 volume of a transposed conv at the benchmark row
    assert jax_fused3d.plan_3d_blocked(8, 8, 78, 78, 78, 8, 8, 8) == (("tap", 40, 40, 48), 2, 57)
    assert fused3d.plan_3d_blocked(8, 8, 78, 78, 78, 8, 8, 8) == (("v4", 40, 40, 40, 9, 40), 2, 57)
    assert fused3d._scratch_bytes_per_item(1, 1, 2048, 129, 256, 2046) > fused3d._SCRATCH_BUDGET
    assert fused3d._plan_v4(1, 1, 2048, 256, 64, 3, 3, 3) is None
    # spectra counted at NBH x 64 bins in L2, not NBHP x 128 lanes of VMEM
    assert jax_fused3d.plan_3d(10, 10, 16, 48, 16, 3, 3, 3)[0] == "tap"
    assert fused3d.plan_3d(10, 10, 16, 48, 16, 3, 3, 3)[0] == "v4"
    assert fused3d._plan_v4(16, 16, 16, 64, 16, 3, 3, 3) is None  # 69 MB of spectra
    # shared memory: SB = 4, 2, 1 slabs a block, no plan past NBH = 454
    assert [fused3d._slabs_per_block(n) for n in (113, 114, 227, 228, 454, 455)] == \
        [4, 2, 2, 1, 1, None]
    assert fused3d._plan_v4(1, 1, 9, 908, 8, 3, 3, 3) is None
    # the tap plan keeps the JAX geometry under B4's budgets: its spectra
    # (Cout, Cin/g, KD, NBH, 64) in L2, B3's shared memory, T + Z per item.
    # The B4 row (64^3, K=10, 8 -> 8) plans alike, with 10.8 MB of spectra
    assert fused3d.plan_3d(8, 8, 64, 64, 64, 10, 10, 10) == ("tap", 33, 32, 40)
    assert jax_fused3d.plan_3d(8, 8, 64, 64, 64, 10, 10, 10) == ("tap", 33, 32, 40)
    assert 8 * 8 * 10 * 33 * 64 * 8 <= fused3d._SPECTRA_BUDGET
    assert fused3d._tap_scratch_bytes_per_item(8, 8, 64, 33, 55) == (8 * 64 + 8 * 55) * 33 * 64 * 8
    # K=11: the TPU's spectra of 12 taps at 128 lanes are 25.9 MB, past its
    # 24 MiB; here 11 taps at 64 bins are 11.9 MB
    assert jax_fused3d.plan_3d(8, 8, 64, 64, 64, 11, 11, 11) is None
    assert fused3d.plan_3d(8, 8, 64, 64, 64, 11, 11, 11) == ("tap", 33, 32, 40)
    # 16 -> 16 at 64^3, KD <= 5: v4's 16 D-bins of spectra are 69 MB, KD taps
    # are not (the TPU refuses v4 for its unroll limit and tap for its 80 MiB
    # cell); KD = 6 is 25.9 MB, past B4's budget too
    assert jax_fused3d.plan_3d(16, 16, 64, 64, 64, 3, 3, 3) is None
    assert fused3d._plan_v4(16, 16, 64, 64, 64, 3, 3, 3) is None
    assert fused3d.plan_3d(16, 16, 64, 64, 64, 3, 3, 3) == ("tap", 33, 32, 40)
    assert fused3d.plan_3d(16, 16, 64, 64, 64, 5, 5, 5)[0] == "tap"
    assert fused3d.plan_3d(16, 16, 64, 64, 64, 6, 6, 6) is None
    # the stuffed 82^3 volume of a transposed conv at 64^3, K=10: two W
    # blocks of B4 here, nothing in the JAX package (its auto and fused
    # routes take the composed path)
    assert jax_fused3d.plan_3d_blocked(8, 8, 82, 82, 82, 10, 10, 10) is None
    assert fused3d.plan_3d_blocked(8, 8, 82, 82, 82, 10, 10, 10) == (("tap", 42, 40, 48), 2, 55)
    # shared memory: no tap plan past NBH = 454, where the TPU's cell fits
    assert jax_fused3d.plan_3d(1, 1, 10, 908, 8, 10, 3, 3) == ("tap", 455, 8, 16)
    assert fused3d.plan_3d(1, 1, 10, 908, 8, 10, 3, 3) is None
    assert fused3d.plan_3d(1, 1, 10, 906, 8, 10, 3, 3) == ("tap", 454, 8, 16)
    # scratch: T + Z of one item within 256 MiB
    assert fused3d._tap_scratch_bytes_per_item(1, 1, 2048, 129, 2039) > fused3d._SCRATCH_BUDGET
    assert fused3d._plan_tap(1, 1, 2048, 256, 64, 10, 3, 3) is None
    # no fallback: the port raises where the JAX function takes the composed path
    x, k = np.zeros((1, 1, 8, 8, 300), np.float32), np.zeros((1, 1, 2, 2, 70), np.float32)
    assert jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k)).shape == (1, 1, 7, 7, 231)
    with pytest.raises(ValueError, match="no fused 3D FFT configuration"):
        fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k))


@pytest.mark.parametrize("h,vh", [(64, 57), (19, 13), (200, 194)])
def test_mats_match_jax(h, vh):
    ours = fused3d._mats_3d(h, vh)
    fr, fi, bwr, bwi, bur, bui, cr, ci = jax_fused3d._mats_3d(h, vh)
    theirs = (fr, fi, bwr[:64, :64], bwi[:64, :64], bur[:64, :64], bui[:64, :64], cr, ci)
    for a, b in zip(ours[:6] + ours[10:], theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_w_dft_factored_matches_dense(inverse, dtype):
    """The W DFT-64 and its inverse through the 8 x 8 factors (the plain
    version's ``fourstep.dft_last`` with ``_W_SPLIT``, 1/64 applied after the
    inverse as the kernel applies it) against the dense matrices of
    ``ops/spectral.py:_dft_mats(64)``: exact in float64, within the bar in
    float32."""
    from fft_conv_tpu_torch.kernels.fourstep import dft_last
    from fft_conv_tpu_torch.ops.spectral import _dft_mats

    xr, xi = (torch.from_numpy(a).to(dtype) for a in _arrays(64 + inverse, (3, 5, 64), (3, 5, 64)))
    yr, yi = dft_last(xr, xi, fused3d._W_SPLIT, inverse)
    if inverse:
        yr, yi = yr / 64, yi / 64
    wr, wi = (torch.from_numpy(m) for m in _dft_mats(64, inverse, np.float64))
    x = torch.complex(xr.double(), xi.double())
    ref = x @ torch.complex(wr, wi)
    assert yr.dtype == dtype and yr.shape == (3, 5, 64)
    if dtype == torch.float64:
        assert (yr - ref.real).abs().max() < 1e-12 and (yi - ref.imag).abs().max() < 1e-12
    else:
        _assert_close_scaled(yr.numpy(), ref.real.numpy())
        _assert_close_scaled(yi.numpy(), ref.imag.numpy())


def test_w_factors_are_laid_out_as_the_kernel_reads_them():
    """``_w_factors`` is the 8 roots of step 1, the 8 of step 2 and the (8, 8)
    twiddle row-major, complex64: f1[m, j] = root[(m * j) % 8] rebuilds the
    short DFT, tw[m1, j2] = exp(-2 pi i m1 j2 / 64); ``_device_mats`` hands
    the vector in its one slot, which the forward and the inverse both read,
    in the order of the entry points' arguments: with the dense F_H and
    irfft rows at an H the kernels do not factor (78), with the H factors in
    their place at one they do (64, split 8 x 8 like W)."""
    from fft_conv_tpu_torch.kernels.fourstep import fft_factor_matrices

    fac = fused3d._w_factors(torch.device("cpu"))
    assert fac.dtype == torch.complex64 and fac.shape == (8 + 8 + 64,)
    f1, f2, tw = fft_factor_matrices(8, 8)
    m = np.arange(8)
    for roots, f in ((fac[:8].numpy(), f1), (fac[8:16].numpy(), f2)):
        np.testing.assert_allclose(roots, np.exp(-2j * np.pi * m / 8), atol=1e-7)
        np.testing.assert_allclose(roots[np.outer(m, m) % 8], f, atol=1e-7)
    np.testing.assert_allclose(fac[16:].numpy().reshape(8, 8),
                               np.exp(-2j * np.pi * np.outer(m, m) / 64), atol=1e-7)
    np.testing.assert_allclose(fac[16:].numpy().reshape(8, 8), tw, atol=1e-7)
    fh, wfac, hfac, df, ei, ch = fused3d._device_mats(78, 71, torch.device("cpu"))
    assert wfac is fac and hfac is None
    fr, fi, _, _, _, _, dr, di, er, eim, cr, ci = fused3d._mats_3d(78, 71)
    for got, re, im in ((fh, fr, fi), (df, dr, di), (ei, er, eim), (ch, cr, ci)):
        assert got.dtype == torch.complex64
        assert torch.equal(got, torch.complex(torch.from_numpy(re), torch.from_numpy(im)))
    fh, wfac, hfac, df2, ei2, ch = fused3d._device_mats(64, 57, torch.device("cpu"))
    assert fh is None and ch is None and wfac is fac
    assert torch.equal(hfac, fac) and torch.equal(df2, df) and torch.equal(ei2, ei)


@pytest.mark.parametrize("h", [16, 32, 64, 128])
def test_h_factors_are_laid_out_as_the_kernel_reads_them(h):
    """The H factors of ``_device_mats`` for each H the kernels factor: the
    split of ``fourstep.split_factors`` (csrc/fused3d.cu: HSplit), its A
    roots, its B roots and the (A, B) twiddle exp(-2 pi i m1 j2 / H),
    row-major, complex64; no dense F_H or irfft rows."""
    from fft_conv_tpu_torch.kernels.fourstep import split_factors

    a, b = fused3d._H_SPLITS[h]
    assert (a, b) == split_factors(h) == {16: (4, 4), 32: (8, 4), 64: (8, 8), 128: (16, 8)}[h]
    fh, _, hfac, _, _, ch = fused3d._device_mats(h, h - 3, torch.device("cpu"))
    assert fh is None and ch is None
    assert hfac.dtype == torch.complex64 and hfac.shape == (a + b + a * b,)
    np.testing.assert_allclose(hfac[:a].numpy(), np.exp(-2j * np.pi * np.arange(a) / a), atol=1e-7)
    np.testing.assert_allclose(hfac[a:a + b].numpy(), np.exp(-2j * np.pi * np.arange(b) / b),
                               atol=1e-7)
    np.testing.assert_allclose(hfac[a + b:].numpy().reshape(a, b),
                               np.exp(-2j * np.pi * np.outer(np.arange(a), np.arange(b)) / h),
                               atol=1e-7)
    assert fused3d._h_path(h) == "factored" and fused3d._h_path(h + 2) == "dense"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("h", [16, 32, 64, 128])
def test_h_dft_factored_matches_dense(h, inverse, dtype):
    """The factored H/W kernel's H transforms (the plain versions
    ``_h_forward_pairs``, slab pairs through one H-point DFT and the split of
    bins k and H - k, and ``_h_inverse_pairs``, the c2r of two slabs at once)
    against the dense float64 oracle of ``_mats_3d``, the one-sided DFT rows
    and the irfft rows: within 1e-12 relative in float64, within the bar in
    float32. An odd slab count (the last slab paired with zeros) and OH < H."""
    d, oh, cols = 5, h - 5, 7
    fr, fi, _, _, _, _, _, _, _, _, cr, ci = (torch.from_numpy(m) for m in
                                               fused3d._mats_3d(h, oh, np.float64))
    if inverse:
        er, ei = (torch.from_numpy(a) for a in _arrays(h + 1, (2, d, h // 2 + 1, cols),
                                                         (2, d, h // 2 + 1, cols)))
        got = (fused3d._h_inverse_pairs(er.to(dtype), ei.to(dtype), h, oh),)
        want = (cr @ er.double() + ci @ ei.double(),)
        assert got[0].shape == (2, d, oh, cols)
    else:
        (x,) = (torch.from_numpy(a) for a in _arrays(h, (2, d, h, cols)))
        got = fused3d._h_forward_pairs(x.to(dtype))
        want = (fr @ x.double(), fi @ x.double())
        assert got[0].shape == got[1].shape == (2, d, h // 2 + 1, cols)
    for y, y_ref in zip(got, want):
        assert y.dtype == dtype
        if dtype == torch.float64:
            assert (y - y_ref).abs().max() <= 1e-12 * y_ref.abs().max()
        else:
            _assert_close_scaled(y.numpy(), y_ref.numpy())


def test_shared_memory_and_plans_are_unchanged():
    """The factored H/W kernels use at most the plan's shared memory, so the
    plan's figures stay as they were: SB = 4, 2, 1 by the formula SB * NBH *
    64 * 8 <= 232448 at every NBH from 5 to 454, and the plans of both
    chains at the H around each factored length and at the dense ones."""
    for nbh in range(5, 455):
        sb = 4 if nbh <= 113 else 2 if nbh <= 227 else 1
        assert fused3d._slabs_per_block(nbh) == sb
        assert fused3d._smem_bytes(nbh) == sb * nbh * 64 * 8 <= fused3d._SMEM_LIMIT
    assert fused3d._slabs_per_block(455) is None and fused3d._smem_bytes(455) == -1
    v4 = {15: ("v4", 8, 8, 16, 2, 8), 16: ("v4", 9, 16, 16, 2, 8), 17: ("v4", 9, 16, 16, 2, 8),
          32: ("v4", 17, 24, 16, 2, 8), 64: ("v4", 33, 40, 16, 2, 8),
          78: ("v4", 40, 40, 16, 2, 8), 82: ("v4", 42, 48, 16, 2, 8),
          127: ("v4", 64, 64, 16, 2, 8), 128: ("v4", 65, 72, 16, 2, 8),
          129: ("v4", 65, 72, 16, 2, 8), 226: ("v4", 114, 120, 16, 2, 8),
          454: ("v4", 228, 232, 16, 2, 8), 906: ("v4", 454, 456, 16, 2, 8), 908: None}
    tap = {15: ("tap", 8, 8, 16), 16: ("tap", 9, 8, 16), 32: ("tap", 17, 8, 16),
           64: ("tap", 33, 8, 16), 128: ("tap", 65, 8, 16), 454: ("tap", 228, 8, 16),
           908: None}
    for h, plan in v4.items():
        assert fused3d.plan_3d(1, 2, 16, h, 64, 3, 3, 3) == plan
    for h, plan in tap.items():
        assert fused3d.plan_3d(1, 2, 16, h, 64, 10, 3, 3) == plan
    assert fused3d.plan_3d_blocked(8, 8, 64, 64, 64, 8, 8, 8) == (("v4", 33, 40, 40, 8, 32), 1, 57)
    assert fused3d.plan_3d_blocked(8, 8, 64, 64, 64, 10, 10, 10) == (("tap", 33, 32, 40), 1, 55)


@pytest.mark.parametrize("shape,h", [((4, 4, 8, 8, 8), 64), ((6, 2, 5, 7, 3), 19),
                                     ((2, 3, 9, 3, 3), 16)])
def test_kernel_spectra_match_jax(shape, h):
    """The JAX package packs two D-bins into 128 lanes, fd = f8 + 8 s; the port
    keeps (Cout, Cin/g, 16, NBH, 64)."""
    cout, cpg = shape[:2]
    (k,) = _arrays(sum(shape), shape)
    k /= np.sqrt(k[0].size)
    nbh = h // 2 + 1
    nbhp = -(-nbh // 8) * 8
    kr, ki = jax_fused3d._kernel_spectra_v4(jnp.asarray(k), h, nbh, nbhp)

    def unpack(a):  # (f8, c, o, NBHP, s * 64 + z) -> (o, c, f8 + 8 s, n, z)
        a = np.asarray(a).reshape(8, cpg, cout, nbhp, 2, 64)[:, :, :, :nbh]
        return a.transpose(2, 1, 4, 0, 3, 5).reshape(cout, cpg, 16, nbh, 64)

    spectra = fused3d.kernel_spectra_3d(torch.from_numpy(k), h)
    assert spectra.dtype == torch.complex64 and spectra.shape == (cout, cpg, 16, nbh, 64)
    assert np.abs(spectra.real.numpy() - unpack(kr)).max() < 2e-5
    assert np.abs(spectra.imag.numpy() - unpack(ki)).max() < 2e-5


@pytest.mark.parametrize("shape,h", [((4, 2, 11, 3, 3), 16), ((3, 3, 10, 5, 7), 19),
                                     ((2, 1, 1, 4, 4), 12)])
def test_kernel_spectra_tap_match_jax(shape, h):
    """The JAX package packs the taps for its d-pair lanes: (NBH, Cin/g,
    ME + MR, Cout, 128) with even tap 2t at t < ME and odd tap 2m' + 1 in R
    tap ME + m' (m' < MO), each in lanes [0, 64). The port keeps (Cout, Cin/g,
    KD, NBH, 64)."""
    cout, cpg, kd = shape[:3]
    (k,) = _arrays(sum(shape) + h, shape)
    k /= np.sqrt(k[0].size)
    nbh = h // 2 + 1
    me, _ = fused3d._tap_counts(kd)

    def unpack(a):  # (n, c, T, o, 128) -> (o, c, kd, n, 64)
        a = np.asarray(a)[..., :64].transpose(3, 1, 2, 0, 4)
        out = np.empty((cout, cpg, kd, nbh, 64), a.dtype)
        out[:, :, 0::2] = a[:, :, :me]
        out[:, :, 1::2] = a[:, :, me:me + kd // 2]
        return out

    kr, ki = jax_fused3d._kernel_spectra_3d(jnp.asarray(k), h, nbh)
    spectra = fused3d.kernel_spectra_tap(torch.from_numpy(k), h)
    assert spectra.dtype == torch.complex64 and spectra.shape == (cout, cpg, kd, nbh, 64)
    assert np.abs(spectra.real.numpy() - unpack(kr)).max() < 2e-5
    assert np.abs(spectra.imag.numpy() - unpack(ki)).max() < 2e-5


@pytest.mark.parametrize("shape,k,groups", [
    ((2, 4, 20, 24, 30), (4, 2, 5, 3, 4), 2),   # one W block, 3 D blocks
    ((1, 2, 12, 9, 150), (3, 2, 9, 4, 7), 1),   # 3 W blocks, odd H, KD = 9
])
def test_plain_version_is_exact_in_float64(shape, k, groups):
    """The blocked pipeline in float64 against the composed path: agreement to
    float64 rounding shows the D blocks, the one-sided rows, the irfft
    weights, the W blocks and the valid-region crop are exact."""
    x, w = _arrays(sum(shape), shape, k)
    xt = torch.from_numpy(x).double()
    wt = torch.from_numpy(w).double()
    y = fused3d._fused3d_forward_reference(xt, wt, groups)
    y_ref = ft.fft_conv(xt, wt, groups=groups, impl="xla")
    assert y.dtype == torch.float64 and y.shape == y_ref.shape
    assert (y - y_ref).abs().max() < 1e-9


@pytest.mark.parametrize("shape,k,groups", [
    ((2, 3, 28, 16, 20), (4, 3, 12, 3, 5), 1),  # one W block
    ((1, 4, 24, 9, 150), (6, 2, 10, 4, 7), 2),  # 3 W blocks, odd H, groups
])
def test_tap_plain_version_is_exact_in_float64(shape, k, groups):
    """B4's plain version in float64 against the composed path: agreement to
    float64 rounding shows the tap windows, the one-sided rows, the irfft
    weights, the W blocks and the valid-region crop are exact."""
    x, w = _arrays(sum(shape) + 1, shape, k)
    xt = torch.from_numpy(x).double()
    wt = torch.from_numpy(w).double()
    assert fused3d._plan_for(xt.shape, wt.shape, groups)[0][0] == "tap"
    y = fused3d._fused3d_tap_reference(xt, wt, groups)
    y_ref = ft.fft_conv(xt, wt, groups=groups, impl="xla")
    assert y.dtype == torch.float64 and y.shape == y_ref.shape
    assert (y - y_ref).abs().max() < 1e-9


def test_tap_plan_raises_naming_b4():
    """KD = 11 plans the tap kernel (B4): every fused route runs its plain
    version on a CPU tensor and launches nothing; auto on a CPU signal is
    the composed path. Each plain version takes only its own plan."""
    x, k = _arrays(11, (1, 2, 30, 16, 12), (2, 2, 11, 3, 3))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    assert fused3d.plan_3d(2, 2, 30, 16, 12, 11, 3, 3)[0] == "tap"
    before = fused3d.launches, fused3d.launches_tap
    y_ref = fused3d._fused3d_tap_reference(xt, kt)
    assert torch.equal(fused3d.fft_conv3d_fused(xt, kt), y_ref)
    assert torch.equal(ft.fft_conv(xt, kt, impl="fused"), y_ref)
    assert torch.equal(fused3d._fused3d_forward(xt, kt), y_ref)
    assert (fused3d.launches, fused3d.launches_tap) == before
    _assert_close_scaled(y_ref.numpy(), ft.fft_conv(xt, kt, impl="xla").numpy())
    y = ft.fft_conv(xt, kt, impl="auto")
    assert torch.equal(y, ft.fft_conv(xt, kt, impl="xla"))
    with pytest.raises(ValueError, match="plans 'tap', not 'v4'"):
        fused3d._fused3d_forward_reference(xt, kt)
    with pytest.raises(ValueError, match="plans 'v4', not 'tap'"):
        fused3d._fused3d_tap_reference(xt, kt[:, :, :9])


def test_tap_gradients_match_composed():
    x, w = _arrays(4, (2, 4, 24, 12, 14), (4, 2, 11, 3, 5))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    kw = dict(padding=(0, 1, 2), groups=2)
    (fused3d.fft_conv3d_fused(xt, wt, **kw) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv(xt, wt, impl="xla", **kw) ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


# (B, Cin, Cout, D, H, W, K, stride, padding, output_padding, dilation, groups):
# tests/test_pallas3d.py:TCONFIGS; the last one's stuffed W of 78 runs in two
# W blocks
TCONFIGS = [
    (1, 2, 3, 10, 12, 10, 3, 1, 0, 0, 1, 1),
    (2, 2, 2, 8, 9, 10, 4, 2, 1, 1, 1, 1),
    (1, 4, 4, 7, 8, 9, 3, 1, 0, 0, 2, 2),
    (1, 2, 2, 12, 14, 64, 8, 1, 0, 0, 1, 1),
]


@pytest.mark.parametrize("b,cin,cout,d,h,w,k,st,pad,op,dil,groups", TCONFIGS)
def test_transpose_matches_jax_fused(b, cin, cout, d, h, w, k, st, pad, op, dil, groups):
    x, wt, bias = _arrays(d + k + st, (b, cin, d, h, w), (cin, cout // groups, k, k, k),
                          (cout,))
    kw = dict(stride=st, padding=pad, output_padding=op, dilation=dil, groups=groups)
    y_jax = jax_fused3d.fft_conv_transpose3d_fused(jnp.asarray(x), jnp.asarray(wt),
                                                   jnp.asarray(bias), **kw)
    before = fused3d.launches, fused3d.launches_tap
    y = fused3d.fft_conv_transpose3d_fused(torch.from_numpy(x), torch.from_numpy(wt),
                                           torch.from_numpy(bias), **kw)
    assert (fused3d.launches, fused3d.launches_tap) == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_fft_conv_transpose_fused_3d_matches_jax():
    """The transposed route through the public entry point on both sides: a
    tap plan (K = 11 on the stuffed volume) with stride and output padding."""
    x, wt, bias = _arrays(6, (1, 2, 8, 7, 9), (2, 3, 11, 3, 3), (3,))
    kw = dict(stride=(2, 1, 2), padding=(1, 0, 2), output_padding=(1, 0, 1), impl="fused")
    cout = 3
    assert fused3d.plan_3d_blocked(2, cout, 35, 13, 37, 11, 3, 3)[0][0] == "tap"
    y = ft.fft_conv_transpose(torch.from_numpy(x), torch.from_numpy(wt),
                              torch.from_numpy(bias), **kw)
    y_jax = fc.fft_conv_transpose(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))
    _assert_close_scaled(y.numpy(), ft.fft_conv_transpose(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
        **{**kw, "impl": "xla"}).numpy())


def test_transpose_fused_validation():
    x, w = torch.zeros(1, 4, 6, 6, 6), torch.zeros(4, 2, 3, 3, 3)
    with pytest.raises(ValueError, match="expects"):
        fused3d.fft_conv_transpose3d_fused(x[0], w)
    with pytest.raises(ValueError, match="!= signal Cin"):
        fused3d.fft_conv_transpose3d_fused(x, w[:3])
    with pytest.raises(ValueError, match="divisible"):
        fused3d.fft_conv_transpose3d_fused(x, w, groups=3)
    with pytest.raises(ValueError, match="non-positive"):
        fused3d.fft_conv_transpose3d_fused(x, w, padding=5)
    # an output_padding past torch's limit is accepted, as in the JAX package
    y = fused3d.fft_conv_transpose3d_fused(x, w, output_padding=2)
    assert y.shape == ft.fft_conv_transpose(x, w, output_padding=2, impl="xla").shape
    # no plan fits the stuffed volume: W blocks need KW <= 64
    wide = (torch.zeros(1, 1, 4, 4, 80), torch.zeros(1, 1, 2, 2, 70))
    with pytest.raises(ValueError, match="no fused 3D FFT configuration"):
        ft.fft_conv_transpose(*wide, impl="fused")
    with pytest.raises(ValueError, match="no fused 3D FFT configuration"):
        fused3d.fft_conv_transpose3d_fused(*wide)


def test_fused3d_gradients_match_composed():
    x, w = _arrays(3, (2, 4, 14, 12, 16), (4, 2, 3, 5, 3))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    kw = dict(padding=(1, 2, 0), groups=2)
    (fused3d.fft_conv3d_fused(xt, wt, **kw) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv(xt, wt, impl="xla", **kw) ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_fused3d_validation():
    x = torch.zeros(1, 4, 10, 10, 10)
    with pytest.raises(ValueError, match="expects"):
        fused3d.fft_conv3d_fused(x[0], torch.zeros(2, 4, 3, 3, 3))
    with pytest.raises(ValueError, match="groups"):
        fused3d.fft_conv3d_fused(x, torch.zeros(2, 3, 3, 3, 3), groups=2)
    with pytest.raises(ValueError, match="divisible"):
        fused3d.fft_conv3d_fused(x, torch.zeros(3, 2, 3, 3, 3), groups=2)
    with pytest.raises(ValueError, match="greater than"):
        fused3d.fft_conv3d_fused(x, torch.zeros(2, 4, 11, 3, 3))
    wide = (torch.zeros(1, 1, 8, 8, 300), torch.zeros(1, 1, 2, 2, 70))
    assert fused3d.fft_conv3d_fused_if_fits(*wide) is None
    with pytest.raises(ValueError, match="no fused 3D FFT configuration"):
        ft.fft_conv(*wide, impl="fused")
    # auto fuses single-block plans only
    blocked = (torch.zeros(1, 1, 8, 8, 200), torch.zeros(1, 1, 2, 2, 7))
    assert fused3d.fft_conv3d_fused_if_fits(*blocked, w_blocks=False) is None
    assert fused3d.fft_conv3d_fused_if_fits(*blocked).shape == (1, 1, 7, 7, 194)


def test_kernel_wrapper_takes_only_cuda_tensors():
    spectra = fused3d.kernel_spectra_3d(torch.zeros(2, 2, 3, 3, 3), 10)
    with pytest.raises(ValueError, match="CUDA"):
        fused3d._launch_fused3d(torch.zeros(1, 2, 10, 10, 10), spectra, 1, (3, 3, 3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused3d._fused3d_forward(torch.zeros(1, 2, 10, 10, 10, device="meta"),
                                 torch.zeros(2, 2, 3, 3, 3, device="meta"))
