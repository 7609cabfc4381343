"""The port's fused 2D path against the JAX package's.

On the CPU the port's wrapper runs the kernel's plain version
(``_fused2d_forward_reference``), and the JAX wrapper runs its Pallas kernel
in interpret mode with the bf16x3-exact split, as ``tests/test_pallas2d.py``
runs it. Both are held with ``helpers._assert_close_scaled``, the error model
of that precision. The CUDA kernel itself is tested on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused2d as jax_fused2d
from fft_conv_tpu_torch.kernels import fused2d

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Cin, Cout, H, W, K1, K2, groups, stride, dilation, padding, padding_mode),
# from tests/test_pallas2d.py at widths <= 200
PARITY = [
    (1, 2, 3, 200, 160, 10, 12, 1, 1, 1, 0, "constant"),
    (1, 3, 2, 129, 130, 16, 16, 1, 1, 1, 0, "constant"),    # odd sizes, partial tiles
    (1, 2, 2, 130, 200, 5, 60, 1, 1, 1, 0, "constant"),     # nt2 = 3
    (2, 4, 4, 160, 150, 9, 7, 2, (2, 3), 2, 3, "circular"),
    (2, 4, 4, 160, 150, 9, 7, 1, 1, 1, 3, "reflect"),
    (2, 4, 4, 160, 150, 9, 7, 1, (2, 1), (1, 2), 3, "constant"),
    (1, 2, 2, 420, 150, 200, 9, 1, 1, 1, 0, "constant"),    # T1 = 384
    (1, 2, 2, 130, 300, 12, 100, 1, 1, 1, 0, "constant"),   # T2 = 256
]


@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups,stride,dilation,padding,mode", PARITY)
def test_plain_version_matches_jax_fused(b, cin, cout, h, w, k1, k2, groups, stride,
                                         dilation, padding, mode):
    x, k, bias = _arrays(h + w + k2, (b, cin, h, w), (cout, cin // groups, k1, k2), (cout,))
    kw = dict(padding=padding, padding_mode=mode, stride=stride, dilation=dilation,
              groups=groups)
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(k),
                                         jnp.asarray(bias), **kw)
    before = fused2d.launches
    y = fused2d.fft_conv2d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw)
    assert fused2d.launches == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_fft_conv_fused_2d_matches_jax():
    """The whole slice through the public entry point on both sides."""
    x, k, bias = _arrays(5, (2, 3, 140, 170), (4, 3, 16, 16), (4,))
    kw = dict(padding=2, impl="fused")
    before = fused2d.launches
    y = ft.fft_conv(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias), **kw)
    assert fused2d.launches == before
    y_jax = fc.fft_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


# (K1, K2, Cin/g, Cout, Hp, Wp, Cin): the benchmark's two rows and the shapes above
SHAPES = [
    (16, 16, 8, 8, 512, 512, 8), (34, 34, 8, 8, 512, 512, 8),
    (10, 12, 2, 3, 200, 160, 2), (16, 16, 3, 2, 129, 130, 3),
    (5, 60, 2, 2, 130, 200, 2), (17, 13, 2, 4, 166, 156, 4),
    (9, 13, 4, 4, 166, 156, 4), (70, 5, 2, 2, 300, 140, 2), (12, 100, 2, 6, 200, 300, 4),
]


@pytest.mark.parametrize("k1,k2,cin_g,cout,hp,wp,cin", SHAPES)
def test_tile_plan_and_fits_match_jax(k1, k2, cin_g, cout, hp, wp, cin):
    assert fused2d.tile_plan_2d(k1, k2, cin_g, cout) == \
        jax_fused2d.tile_plan_2d(k1, k2, cin_g, cout)
    assert fused2d.fused2d_fits(k1, k2, cin_g, cout, (hp, wp), cin_total=cin, batch=2) == \
        jax_fused2d.fused2d_fits(k1, k2, cin_g, cout, (hp, wp), cin_total=cin)


def test_tile_plan_at_the_benchmark_rows():
    assert fused2d.tile_plan_2d(16, 16, 8, 8) == (128, 112, 65, 128, 113)
    assert fused2d.tile_plan_2d(34, 34, 8, 8) == (128, 88, 65, 128, 95)
    # 5 x 5 and 6 x 6 tiles per 512 x 512 image
    assert fused2d._tiling(fused2d.tile_plan_2d(16, 16, 8, 8), 512, 512, 16, 16)[2:] == (5, 5)
    assert fused2d._tiling(fused2d.tile_plan_2d(34, 34, 8, 8), 512, 512, 34, 34)[2:] == (6, 6)
    assert fused2d._smem_bytes(65, 128) == 102784


def test_budgets_differ_from_jax_where_intended():
    """ROADMAP §C: the kernel's own budgets replace the TPU's VMEM budgets."""
    # spectra of 8-16 MiB: past the TPU's resident budget, inside this one
    assert jax_fused2d.tile_plan_2d(16, 16, 12, 16) is None
    assert fused2d.tile_plan_2d(16, 16, 12, 16) == (128, 112, 65, 128, 113)
    assert fused2d.tile_plan_2d(16, 16, 16, 16) is None
    # a block's shared memory: no T2 = 256 with T1 = 256, no T1 = 512
    assert jax_fused2d.tile_plan_2d(70, 100, 1, 1) is not None
    assert fused2d.tile_plan_2d(70, 100, 1, 1) is None
    assert fused2d.tile_plan_2d(200, 16, 1, 1)[0] == 384
    assert jax_fused2d.tile_plan_2d(300, 16, 1, 1) is not None
    assert fused2d.tile_plan_2d(300, 16, 1, 1) is None
    # no per-cell budget that grows with the image width; the scratch of one
    # tile of the whole batch is the limit instead
    assert not jax_fused2d.fused2d_fits(16, 16, 8, 8, (512, 20000), cin_total=8)
    assert fused2d.fused2d_fits(16, 16, 8, 8, (512, 20000), cin_total=8, batch=2)
    assert not fused2d.fused2d_fits(16, 16, 8, 8, (512, 512), cin_total=8, batch=4096)


@pytest.mark.parametrize("t1,t2,v1", [(128, 128, 112), (256, 128, 184), (128, 256, 88)])
def test_mats_match_jax(t1, t2, v1):
    nb1 = t1 // 2 + 1
    for a, b in zip(fused2d._mats_2d(t1, nb1, t2, v1), jax_fused2d._mats_2d(t1, nb1, t2, v1)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("k1,k2,groups", [(16, 16, 1), (34, 20, 2), (70, 100, 1)])
def test_kernel_spectra_match_jax(k1, k2, groups):
    t1 = 128 if k1 <= 65 else 256
    t2 = 128 if k2 <= 97 else 256
    (k,) = _arrays(k1 * k2, (4, 4 // groups, k1, k2))
    k /= np.sqrt(k[0].size)
    kr, ki = jax_fused2d._kernel_spectra_2d(jnp.asarray(k), t1, t1 // 2 + 1, t2)
    spectra = fused2d.kernel_spectra_2d(torch.from_numpy(k), t1, t1 // 2 + 1, t2)
    assert spectra.dtype == torch.complex64 and spectra.shape == kr.shape
    assert np.abs(spectra.real.numpy() - np.asarray(kr)).max() < 1e-6
    assert np.abs(spectra.imag.numpy() - np.asarray(ki)).max() < 1e-6


@pytest.mark.parametrize("t", [128, 256, 384])
def test_factored_transforms_match_dense_products(t):
    """B2's four-step transforms (the plain version's, with the kernel's
    factors and natural bin order) against the dense DFT matrices of
    ``_torch_mats`` in float64: the one-sided H DFT and the H irfft at
    T1 = t, the W DFT (``_dft_last``) and its inverse at T2 = t."""
    nb1, v1 = t // 2 + 1, t - 7
    fr, fi, wr, wi, ur, ui, cr, ci = fused2d._torch_mats(t, nb1, t, v1, torch.float64,
                                                        torch.device("cpu"))
    a, yr, yi = (torch.from_numpy(m).double() for m in _arrays(t, (2, t, t), (2, nb1, t),
                                                              (2, nb1, t)))

    def close(got, want):
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()

    hr, hi = fused2d._h_forward(a)
    close(hr, fr @ a)
    close(hi, fi @ a)
    dr, di = fused2d._dft_last(yr, yi, False)
    close(dr, yr @ wr - yi @ wi)
    close(di, yr @ wi + yi @ wr)
    er, ei = fused2d._w_inverse(yr, yi)
    close(er, yr @ ur - yi @ ui)
    close(ei, yr @ ui + yi @ ur)
    close(fused2d._h_irfft(yr, yi, v1), cr @ yr + ci @ yi)


@pytest.mark.parametrize("shape,k,groups", [
    ((2, 4, 300, 260), (4, 4, 16, 16), 1),    # 3 x 3 tiles, partial last ones
    ((1, 4, 130, 400), (6, 2, 12, 100), 2),   # T2 = 256
    ((1, 2, 300, 140), (2, 2, 70, 5), 1),     # T1 = 256
])
def test_plain_version_is_exact_in_float64(shape, k, groups):
    """The tiled one-sided pipeline in float64 against the composed path:
    agreement to float64 rounding shows the tiling, the one-sided rows, the
    irfft weights and the valid-region crop are exact."""
    x, w = _arrays(sum(shape), shape, k)
    xt = torch.from_numpy(x).double()
    wt = torch.from_numpy(w).double()
    y = fused2d._fused2d_forward_reference(xt, wt, groups)
    y_ref = ft.fft_conv(xt, wt, groups=groups, impl="xla")
    assert y.dtype == torch.float64 and y.shape == y_ref.shape
    assert (y - y_ref).abs().max() < 1e-9


def test_fused2d_gradients_match_composed():
    x, w = _arrays(3, (2, 4, 140, 150), (4, 2, 9, 11))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    kw = dict(padding=(2, 3), groups=2)
    (fused2d.fft_conv2d_fused(xt, wt, **kw) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv(xt, wt, impl="xla", **kw) ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_fused2d_validation():
    x = torch.zeros(1, 4, 50, 50)
    with pytest.raises(ValueError, match="expects"):
        fused2d.fft_conv2d_fused(x[0], torch.zeros(2, 4, 3, 3))
    with pytest.raises(ValueError, match="groups"):
        fused2d.fft_conv2d_fused(x, torch.zeros(2, 3, 3, 3), groups=2)
    with pytest.raises(ValueError, match="divisible"):
        fused2d.fft_conv2d_fused(x, torch.zeros(3, 2, 3, 3), groups=2)
    with pytest.raises(ValueError, match="greater than"):
        fused2d.fft_conv2d_fused(x, torch.zeros(2, 4, 51, 3))
    with pytest.raises(ValueError, match="no fused 2D FFT configuration"):
        fused2d.fft_conv2d_fused(torch.zeros(1, 1, 200, 300), torch.zeros(1, 1, 70, 100))
    assert fused2d.fft_conv2d_fused_if_fits(
        torch.zeros(1, 1, 200, 300), torch.zeros(1, 1, 70, 100)) is None
    with pytest.raises(ValueError, match="no fused 2D FFT configuration"):
        ft.fft_conv(torch.zeros(1, 1, 200, 300), torch.zeros(1, 1, 70, 100), impl="fused")


def test_kernel_wrapper_takes_only_cuda_tensors():
    plan = fused2d.tile_plan_2d(5, 5, 2, 2)
    spectra = fused2d.kernel_spectra_2d(torch.zeros(2, 2, 5, 5), plan[0], plan[2], plan[3])
    with pytest.raises(ValueError, match="CUDA"):
        fused2d._launch_fused2d(torch.zeros(1, 2, 40, 40), spectra, plan, 1, (5, 5))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused2d._fused2d_forward(torch.zeros(1, 2, 40, 40, device="meta"),
                                 torch.zeros(2, 2, 5, 5, device="meta"))
