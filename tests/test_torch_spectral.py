"""The port's split re/im DFT products (``fft_conv_tpu_torch/ops/spectral.py``)
against the JAX package's, the cases of ``tests/test_spectral.py``.

Seeded numpy inputs go through both packages on the CPU and are held with
``helpers._assert_close_scaled``. The port carries the transforms that the
overlap-save tiling runs, not the JAX package's whole-signal DFT-matmul
convolution (gated there to a TPU): the forced cases force it in the JAX
package, as its tests do, and hold the port's composed (``torch.fft``)
path to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu.ops.spectral as jax_spectral
import fft_conv_tpu_torch as ft
import fft_conv_tpu_torch.ops.spectral as spectral

from helpers import _assert_almost_equal, _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def force_matmul_dft(monkeypatch):
    """The JAX package's DFT-matmul convolution on the CPU."""
    monkeypatch.setattr(jax_spectral, "use_matmul_dft", lambda fft_shape, platform=None: True)


@pytest.mark.parametrize("shape,fft_shape", [
    ((2, 3, 24), (32,)),
    ((2, 3, 24, 17), (24, 18)),
    ((1, 2, 8, 9, 10), (8, 10, 12)),
])
def test_rfftn_matmul_matches_jax_and_numpy(shape, fft_shape):
    """The first spatial axis is the one-sided one: numpy's rfftn with that
    axis listed last."""
    (x,) = _arrays(0, shape)
    fr, fi = spectral.rfftn_matmul(torch.from_numpy(x), fft_shape)
    jr, ji = jax_spectral.rfftn_matmul(jnp.asarray(x), fft_shape)
    _assert_close_scaled(fr.numpy(), np.asarray(jr))
    _assert_close_scaled(fi.numpy(), np.asarray(ji))
    n = len(fft_shape)
    axes = tuple(range(-n + 1, 0)) + (-n,)
    ref = np.fft.rfftn(x, s=fft_shape[1:] + (fft_shape[0],), axes=axes)
    assert np.abs(fr.numpy() + 1j * fi.numpy() - ref).max() < 1e-4


def test_irfftn_matmul_roundtrip():
    (x,) = _arrays(1, (2, 2, 20, 16))
    fr, fi = spectral.rfftn_matmul(torch.from_numpy(x), (20, 16))
    y = spectral.irfftn_matmul(fr, fi, (20, 16))
    assert np.abs(y.numpy() - x).max() < 1e-5
    y_jax = jax_spectral.irfftn_matmul(jnp.asarray(fr.numpy()), jnp.asarray(fi.numpy()), (20, 16))
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_irfftn_matmul_odd_axis():
    (x,) = _arrays(2, (1, 1, 15))
    fr, fi = spectral.rfftn_matmul(torch.from_numpy(x), (15,))
    assert np.abs(spectral.irfftn_matmul(fr, fi, (15,)).numpy() - x).max() < 1e-5


def test_implicit_zero_padding_matches_explicit():
    """Row-sliced matrices equal zero-padding the input (the kernel's path),
    and the slices are views of the one copy of each matrix."""
    (k,) = _arrays(3, (4, 3, 5, 5))
    fr, fi = spectral.rfftn_matmul(torch.from_numpy(k), (32, 32))
    k_pad = np.pad(k, ((0, 0), (0, 0), (0, 27), (0, 27)))
    fr2, fi2 = spectral.rfftn_matmul(torch.from_numpy(k_pad), (32, 32))
    assert np.abs(fr.numpy() - fr2.numpy()).max() < 1e-4
    assert np.abs(fi.numpy() - fi2.numpy()).max() < 1e-4
    mats = spectral._device_mats("dft", torch.device("cpu"), 32, False)
    assert spectral._device_mats("dft", torch.device("cpu"), 32, False) is mats
    assert mats[0].dtype == torch.float32 and mats[0][:5]._base is mats[0]


@pytest.mark.parametrize("ndim,size,groups", [(1, 33, 1), (2, 20, 2), (3, 9, 1)])
def test_forced_matmul_conv_matches_jax(force_matmul_dft, ndim, size, groups):
    sig, w, b = _arrays(ndim, (2, 4) + (size,) * ndim, (6, 4 // groups) + (3,) * ndim, (6,))
    kw = dict(stride=2, padding=1, dilation=2, groups=groups, impl="xla")
    y_jax = fc.fft_conv(jnp.asarray(sig), jnp.asarray(w), jnp.asarray(b), **kw)
    y = ft.fft_conv(*map(torch.from_numpy, (sig, w, b)), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))
    y_ref = getattr(torch.nn.functional, f"conv{ndim}d")(
        *map(torch.from_numpy, (sig, w, b)), stride=2, padding=1, dilation=2, groups=groups)
    _assert_almost_equal(y.numpy(), y_ref.numpy())


def test_forced_matmul_transpose_matches_jax(force_matmul_dft):
    sig, w = _arrays(9, (2, 4, 14, 14), (4, 3, 3, 3))
    kw = dict(stride=2, padding=1, output_padding=1, impl="xla")
    y_jax = fc.fft_conv_transpose(jnp.asarray(sig), jnp.asarray(w), **kw)
    y = ft.fft_conv_transpose(torch.from_numpy(sig), torch.from_numpy(w), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_forced_matmul_gradients_match_jax(force_matmul_dft):
    """The port's composed gradients against JAX's AD through its DFT
    products (the port's own products' backward is held in
    ``test_torch_tiled.py``)."""
    sig, w = _arrays(5, (1, 2, 12, 12), (3, 2, 3, 3))
    gw_jax = jax.grad(lambda w_: fc.fft_conv(jnp.asarray(sig), w_, impl="xla").sum())(
        jnp.asarray(w))
    gx_jax = jax.grad(lambda x_: (fc.fft_conv(x_, jnp.asarray(w), impl="xla") ** 2).sum())(
        jnp.asarray(sig))
    wt = torch.from_numpy(w).requires_grad_()
    ft.fft_conv(torch.from_numpy(sig), wt, impl="xla").sum().backward()
    xt = torch.from_numpy(sig).requires_grad_()
    (ft.fft_conv(xt, torch.from_numpy(w), impl="xla") ** 2).sum().backward()
    _assert_close_scaled(wt.grad.numpy(), np.asarray(gw_jax))
    _assert_close_scaled(xt.grad.numpy(), np.asarray(gx_jax))


_SETTINGS = {
    "default": lambda m: None,
    "high": lambda m: torch.set_float32_matmul_precision("high"),
    "medium": lambda m: torch.set_float32_matmul_precision("medium"),
    "allow_tf32": lambda m: setattr(m, "allow_tf32", True),
    "fp32_precision tf32": lambda m: setattr(m, "fp32_precision", "tf32"),
    "global fp32_precision tf32": lambda m: setattr(torch.backends, "fp32_precision", "tf32"),
}


def _matmul_state(m):
    """Every reading of the float32 matmul setting; torch raises on the
    legacy readings where the caller set the newer flags."""
    out = {}
    for key, read in (("precision", torch.get_float32_matmul_precision),
                      ("allow_tf32", lambda: m.allow_tf32),
                      ("fp32_precision", lambda: m.fp32_precision),
                      ("global", lambda: torch.backends.fp32_precision)):
        try:
            out[key] = read()
        except RuntimeError:
            out[key] = "raises"
    return out


@pytest.fixture(params=list(_SETTINGS))
def caller_setting(request):
    """The caller's float32 matmul setting, and torch's defaults after."""
    m = torch.backends.cuda.matmul
    _SETTINGS[request.param](m)
    try:
        yield m
    finally:
        torch.set_float32_matmul_precision("highest")
        m.fp32_precision = "none"
        torch.backends.fp32_precision = "none"


def test_products_run_in_fp32_whatever_the_global_setting(caller_setting):
    """Inside the products' scope cuBLAS float32 products are IEEE FP32,
    through whichever API the caller used; every reading of the caller's
    setting is as it was after it ("medium" stays "medium")."""
    m = caller_setting
    before = _matmul_state(m)
    with spectral._fp32_products():
        assert not m.allow_tf32 and m.fp32_precision == "ieee"
    assert _matmul_state(m) == before


@pytest.mark.parametrize("setting", ["medium", "fp32_precision tf32"])
def test_tiled_call_keeps_the_callers_setting(setting):
    """A tiled call and its backward leave the caller's setting as it was."""
    from fft_conv_tpu_torch.ops import tiled

    m = torch.backends.cuda.matmul
    _SETTINGS[setting](m)
    try:
        before = _matmul_state(m)
        x, w = _arrays(6, (1, 2, 90), (3, 2, 7))
        wt = torch.from_numpy(w).requires_grad_()
        tiled.tiled_valid_corr(torch.from_numpy(x), wt, tile=(32,)).sum().backward()
        assert _matmul_state(m) == before
    finally:
        torch.set_float32_matmul_precision("highest")
        m.fp32_precision = "none"
