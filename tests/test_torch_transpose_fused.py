"""The port's fused 1D and 2D transposed routes against the JAX package's.

A transposed conv runs the unit-stride fused forward on the zero-stuffed
signal. On the CPU the port's forward is the kernel's plain version (B1's,
or B2's); the JAX side runs its Pallas kernel in interpret mode, as its own
tests do. Both are held with ``helpers._assert_close_scaled``. The CUDA
routes are tested on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused1d as jax_fused1d
from fft_conv_tpu.kernels import fused2d as jax_fused2d
from fft_conv_tpu_torch.kernels import fused1d, fused2d

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _counts():
    return fused1d.launches, fused2d.launches, fused2d.launches_v3


# (B, Cin, Cout, L, K, stride, padding, output_padding, dilation, groups);
# the third has output_padding >= stride, which torch refuses and the JAX
# package accepts
CONFIGS_1D = [
    (1, 2, 3, 300, 5, 1, 0, 0, 1, 1),
    (2, 4, 6, 257, 9, 2, 3, 1, 2, 2),
    (1, 2, 2, 200, 40, 3, 5, 4, 1, 1),
    (2, 6, 3, 150, 17, 4, 2, 0, 3, 3),
]


@pytest.mark.parametrize("b,cin,cout,l,k,st,pad,op,dil,groups", CONFIGS_1D)
def test_transpose1d_fused_matches_jax(b, cin, cout, l, k, st, pad, op, dil, groups):
    x, w, bias = _arrays(l + k, (b, cin, l), (cin, cout // groups, k), (cout,))
    kw = dict(padding=pad, stride=st, dilation=dil, groups=groups, output_padding=op)
    y_jax = jax_fused1d.fft_conv_transpose1d_fused(jnp.asarray(x), jnp.asarray(w),
                                                   jnp.asarray(bias), **kw)
    before = _counts()
    y = fused1d.fft_conv_transpose1d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                           torch.from_numpy(bias), **kw)
    assert _counts() == before  # a CPU tensor runs the plain version
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


# (B, Cin, Cout, H, W, K1, K2, stride, padding, output_padding, dilation, groups)
CONFIGS_2D = [
    (1, 2, 3, 30, 25, 5, 3, 1, 0, 0, 1, 1),
    (2, 4, 4, 20, 22, 4, 5, 2, 1, 1, 2, 2),
    (1, 2, 2, 17, 15, 3, 3, (3, 2), (2, 1), (3, 1), 1, 1),
    (1, 3, 6, 40, 12, 7, 2, (1, 3), (3, 0), (0, 2), (1, 2), 3),
]


@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,st,pad,op,dil,groups", CONFIGS_2D)
def test_transpose2d_fused_matches_jax(b, cin, cout, h, w, k1, k2, st, pad, op, dil, groups):
    x, wt, bias = _arrays(h + w + k1, (b, cin, h, w), (cin, cout // groups, k1, k2), (cout,))
    kw = dict(padding=pad, stride=st, dilation=dil, groups=groups, output_padding=op)
    y_jax = jax_fused2d.fft_conv_transpose2d_fused(jnp.asarray(x), jnp.asarray(wt),
                                                   jnp.asarray(bias), **kw)
    before = _counts()
    y = fused2d.fft_conv_transpose2d_fused(torch.from_numpy(x), torch.from_numpy(wt),
                                           torch.from_numpy(bias), **kw)
    assert _counts() == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


@pytest.mark.parametrize("ndim", [1, 2])
def test_fft_conv_transpose_fused_matches_jax(ndim):
    """The public entry point with impl="fused" on both sides, and the
    composed path beside it."""
    shape = (2, 4) + (60, 45)[:ndim]
    x, wt, bias = _arrays(ndim, shape, (4, 3) + (6, 5)[:ndim], (3,))
    kw = dict(stride=2, padding=1, output_padding=1, dilation=2, impl="fused")
    y = ft.fft_conv_transpose(torch.from_numpy(x), torch.from_numpy(wt),
                              torch.from_numpy(bias), **kw)
    y_jax = fc.fft_conv_transpose(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))
    y_xla = ft.fft_conv_transpose(torch.from_numpy(x), torch.from_numpy(wt),
                                  torch.from_numpy(bias), **{**kw, "impl": "xla"})
    _assert_close_scaled(y.numpy(), y_xla.numpy())


@pytest.mark.parametrize("ndim", [1, 2])
def test_auto_on_cpu_stays_composed(ndim):
    """impl="auto" on a CPU signal is the composed path, bit for bit, and
    counts no launch; the transposed layers default to "auto"."""
    x, wt, bias = (torch.from_numpy(a) for a in
                   _arrays(10 + ndim, (2, 4) + (30, 20)[:ndim], (4, 3) + (5, 4)[:ndim], (3,)))
    before = _counts()
    y = ft.fft_conv_transpose(x, wt, bias, stride=2, padding=1)
    assert _counts() == before
    assert torch.equal(y, ft.fft_conv_transpose(x, wt, bias, stride=2, padding=1, impl="xla"))
    layer = (ft.FFTConvTranspose1d, ft.FFTConvTranspose2d)[ndim - 1](4, 3, 5, device="cpu")
    assert layer.impl == "auto"


@pytest.mark.parametrize("ndim", [1, 2])
def test_transpose_fused_gradients_match_composed(ndim):
    x, w = _arrays(20 + ndim, (2, 4) + (80, 70)[:ndim], (4, 3) + (7, 5)[:ndim])
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    kw = dict(stride=2, padding=2, output_padding=1, groups=2 if ndim == 2 else 1)
    (ft.fft_conv_transpose(xt, wt, impl="fused", **kw) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv_transpose(xt, wt, impl="xla", **kw) ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_transpose_fused_validation():
    x1, w1 = torch.zeros(1, 4, 20), torch.zeros(4, 2, 3)
    x2, w2 = torch.zeros(1, 4, 20, 20), torch.zeros(4, 2, 3, 3)
    for fn, x, w in [(fused1d.fft_conv_transpose1d_fused, x1, w1),
                     (fused2d.fft_conv_transpose2d_fused, x2, w2)]:
        with pytest.raises(ValueError, match="expects"):
            fn(x[0], w)
        with pytest.raises(ValueError, match="!= signal Cin"):
            fn(x, w[:3])
        with pytest.raises(ValueError, match="divisible"):
            fn(x, w, groups=3)
        with pytest.raises(ValueError, match="non-positive"):
            fn(x, w, padding=15)
    # no FFT size leaves a full block of valid outputs at K = 8100
    with pytest.raises(ValueError, match="no fused FFT configuration"):
        ft.fft_conv_transpose(torch.zeros(1, 1, 10), torch.zeros(1, 1, 8100), impl="fused")
    assert fused1d.fft_conv_transpose1d_fused_if_fits(
        torch.zeros(1, 1, 10), torch.zeros(1, 1, 8100)) is None
    # no 2D tile plan: T1 = 256 with T2 = 256
    wide = (torch.zeros(1, 1, 20, 20), torch.zeros(1, 1, 70, 100))
    with pytest.raises(ValueError, match="no fused 2D FFT configuration"):
        ft.fft_conv_transpose(*wide, impl="fused")
    assert fused2d.fft_conv_transpose2d_fused_if_fits(*wide) is None
    # where nothing fits, auto takes the composed path
    y = ft.fft_conv_transpose(*wide)
    assert y.shape == (1, 1, 89, 119)
