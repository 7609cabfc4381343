"""The port's composed path and routing against the JAX package.

Same numpy inputs (seeded ``default_rng``) through ``fft_conv_tpu`` (JAX on
the CPU) and ``fft_conv_tpu_torch`` (torch on the CPU), held with the
reference tolerance ``helpers._assert_almost_equal``. The routes that only a
CUDA tensor takes are tested on the card in ``test_torch_cuda.py``.
"""

import itertools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d

from helpers import _assert_almost_equal, _assert_close_scaled

PAD_MODES = ("constant", "reflect", "replicate", "circular")


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both_conv(x, w, b, **kw):
    y_jax = fc.fft_conv(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        impl="xla", **kw,
    )
    y_torch = ft.fft_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), impl="xla", **kw,
    )
    return np.asarray(y_jax), y_torch.numpy()


CONV_1D = [
    (stride, padding, dilation, groups, PAD_MODES[i % 4])
    for i, (stride, padding, dilation, groups) in enumerate(
        itertools.product([1, 2], [0, 3], [1, 2], [1, 2])
    )
]


@pytest.mark.parametrize("stride,padding,dilation,groups,padding_mode", CONV_1D)
def test_fft_conv_1d_matches_jax(stride, padding, dilation, groups, padding_mode):
    x, w, b = _arrays(stride + 10 * padding + dilation, (2, 4, 37), (6, 4 // groups, 5), (6,))
    y_jax, y_torch = _both_conv(
        x, w, b, stride=stride, padding=padding, dilation=dilation,
        groups=groups, padding_mode=padding_mode,
    )
    _assert_almost_equal(y_torch, y_jax)


def test_fft_conv_2d_matches_jax():
    x, w, b = _arrays(1, (2, 4, 12, 13), (6, 2, 3, 4), (6,))
    y_jax, y_torch = _both_conv(
        x, w, b, stride=(1, 2), padding=(1, 0), dilation=(2, 1), groups=2,
        padding_mode="reflect",
    )
    _assert_almost_equal(y_torch, y_jax)


def test_fft_conv_3d_matches_jax():
    x, w, b = _arrays(2, (1, 2, 6, 7, 8), (3, 2, 2, 3, 2), (3,))
    y_jax, y_torch = _both_conv(x, w, b, stride=(1, 2, 1), padding=1)
    _assert_almost_equal(y_torch, y_jax)


def _both_transpose(x, w, b, **kw):
    y_jax = fc.fft_conv_transpose(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        impl="xla", **kw,
    )
    y_torch = ft.fft_conv_transpose(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), impl="xla", **kw,
    )
    return np.asarray(y_jax), y_torch.numpy()


TRANSPOSE_1D = list(itertools.product([1, 2], [0, 1], [0, 1], [1, 2], [1, 2]))[::2]


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups", TRANSPOSE_1D)
def test_fft_conv_transpose_1d_matches_jax(stride, padding, output_padding, dilation, groups):
    x, w, b = _arrays(stride + 3 * dilation, (2, 4, 19), (4, 6 // groups, 5), (6,))
    y_jax, y_torch = _both_transpose(
        x, w, b, stride=stride, padding=padding, output_padding=output_padding,
        dilation=dilation, groups=groups,
    )
    _assert_almost_equal(y_torch, y_jax)


def test_fft_conv_transpose_2d_matches_jax():
    x, w, b = _arrays(3, (2, 4, 7, 8), (4, 3, 3, 2), (6,))
    y_jax, y_torch = _both_transpose(
        x, w, b, stride=(2, 1), padding=(1, 0), output_padding=(1, 0),
        dilation=(1, 2), groups=2,
    )
    _assert_almost_equal(y_torch, y_jax)


def test_fft_conv_transpose_3d_matches_jax():
    x, w = _arrays(4, (1, 2, 4, 5, 6), (2, 3, 2, 2, 3))
    y_jax, y_torch = _both_transpose(x, w, None, stride=2, padding=(0, 1, 0))
    _assert_almost_equal(y_torch, y_jax)


# (rank, size, K, stride, padding, output_padding, dilation) where the crop
# [p, p + out) of the composed transposed path runs past its correlation
PAST_CORRELATION = [
    (n, *cfg) for n in (1, 2, 3)
    for cfg in ((8, 2, 3, 0, 2, 1), (8, 1, 4, 0, 3, 1), (6, 1, 5, 1, 4, 1))
] + [(1, 9, 2, 6, 0, 5, 1), (2, 5, 2, 6, 0, 5, 2), (1, 8, 2, 6, 1, 5, 2)]


@pytest.mark.parametrize("ndim,size,k,stride,padding,output_padding,dilation",
                         PAST_CORRELATION)
def test_transpose_past_the_correlation_matches_torch(ndim, size, k, stride, padding,
                                                       output_padding, dilation):
    """Where output_padding - padding runs past the full correlation, the
    composed path (impl="xla"), the fused route (its plain version here) and
    the transposed layer give torch's shape, and zeros plus bias there. The
    JAX package raises on these calls, so torch is the reference."""
    k_dil = dilation * (k - 1) + 1
    stuffed = (size - 1) * stride + 1 + k_dil - 1
    out = (size - 1) * stride - 2 * padding + k_dil + output_padding
    assert out + padding > (stuffed + k_dil - 1 + 1) // 2 * 2  # past the old FFT length
    x, w, b = _arrays(ndim + size + k, (2, 2) + (size,) * ndim, (2, 3) + (k,) * ndim, (3,))
    kw = dict(stride=stride, padding=padding, output_padding=output_padding,
              dilation=dilation)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ref = getattr(torch.nn.functional, f"conv_transpose{ndim}d")(xt, wt, bt, **kw).numpy()
    assert ref.shape[2:] == (out,) * ndim
    for impl in ("xla", "fused"):
        _assert_almost_equal(ft.fft_conv_transpose(xt, wt, bt, impl=impl, **kw).numpy(), ref)
    layer = getattr(ft.nn, f"FFTConvTranspose{ndim}d")(2, 3, k, device="cpu", **kw)
    with torch.no_grad():
        layer.weight.copy_(wt)
        layer.bias.copy_(bt)
        _assert_almost_equal(layer(xt).numpy(), ref)


@pytest.mark.parametrize("policy", ["even", "pow2"])
def test_fft_policy_matches_jax(policy):
    x, w = _arrays(5, (1, 3, 50), (2, 3, 7))
    y_jax = fc.fft_conv(jnp.asarray(x), jnp.asarray(w), impl="xla", fft_policy=policy)
    y_torch = ft.fft_conv(torch.from_numpy(x), torch.from_numpy(w), impl="xla",
                          fft_policy=policy)
    _assert_almost_equal(y_torch.numpy(), np.asarray(y_jax))


def test_half_precision_computes_in_float32():
    x, w = _arrays(6, (2, 3, 40), (4, 3, 5))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y16 = ft.fft_conv(xt.bfloat16(), wt.bfloat16(), impl="xla")
    assert y16.dtype == torch.bfloat16
    y32 = ft.fft_conv(xt.bfloat16().float(), wt.bfloat16().float(), impl="xla")
    torch.testing.assert_close(y16, y32.bfloat16())


def test_auto_on_cpu_is_the_composed_path():
    x, w, b = _arrays(7, (2, 4, 300), (3, 4, 9), (3,))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = fused1d.launches
    y_auto = ft.fft_conv(xt, wt, bt, padding=2, impl="auto")
    y_xla = ft.fft_conv(xt, wt, bt, padding=2, impl="xla")
    assert torch.equal(y_auto, y_xla)
    assert fused1d.launches == before


def test_auto_on_cpu_is_the_composed_path_in_2d():
    x, w, b = _arrays(12, (2, 4, 60, 50), (3, 4, 5, 7), (3,))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = fused2d.launches
    y_auto = ft.fft_conv(xt, wt, bt, padding=2, impl="auto")
    y_xla = ft.fft_conv(xt, wt, bt, padding=2, impl="xla")
    assert torch.equal(y_auto, y_xla)
    assert fused2d.launches == before


def test_auto_on_cpu_is_the_composed_path_in_3d():
    x, w, b = _arrays(13, (2, 4, 12, 14, 10), (3, 4, 3, 5, 2), (3,))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = fused3d.launches
    y_auto = ft.fft_conv(xt, wt, bt, padding=1, impl="auto")
    y_xla = ft.fft_conv(xt, wt, bt, padding=1, impl="xla")
    assert torch.equal(y_auto, y_xla)
    assert fused3d.launches == before


def test_fused_on_cpu_runs_the_plain_version():
    x, w, b = _arrays(8, (2, 4, 3000), (6, 2, 200), (6,))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = fused1d.launches
    y = ft.fft_conv(xt, wt, bt, stride=2, padding=5, groups=2, impl="fused")
    assert fused1d.launches == before  # a CPU tensor never reaches the kernel
    y_ref = fc.fft_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2,
                        padding=5, groups=2, impl="xla")
    _assert_close_scaled(y.numpy(), np.asarray(y_ref))


@pytest.mark.parametrize("fn", ["fft_conv", "fft_conv_transpose"])
def test_tiled_is_not_ported(fn):
    """impl="tiled" runs the overlap-save tiles (a 1D plan of several tiles
    here) and matches the JAX package's impl="tiled"."""
    from fft_conv_tpu_torch.ops.tiled import plan_tiles, untiled_shape

    x, w, b = _arrays(9, (2, 4, 3000), (4, 2, 200), (4,))
    kw = dict(stride=2, padding=3, groups=2, impl="tiled")
    if fn == "fft_conv_transpose":
        kw["output_padding"] = 1
    y_jax = getattr(fc, fn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    y = getattr(ft, fn)(*map(torch.from_numpy, (x, w, b)), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))
    spatial, out = ((3006,), (2807,)) if fn == "fft_conv" else ((6198,), (6196,))
    tile = plan_tiles(spatial, (200,), out, (2, 4, 4))[0]
    assert tile != untiled_shape(spatial, (200,), out)


@pytest.mark.parametrize("ndim", [2, 3])
def test_fused_2d_3d_raise_not_implemented(ndim):
    """Nothing of the fused 2D and 3D routes raises NotImplementedError any
    more: the forward routes and the transposed routes run (B2's, B3's and
    B4's plain versions on a CPU tensor)."""
    x = torch.zeros((1, 2) + (8,) * ndim)
    w = torch.zeros((2, 2) + (3,) * ndim)
    assert ft.fft_conv(x, w, impl="fused").shape == (1, 2) + (6,) * ndim
    assert ft.fft_conv_transpose(x, w, impl="fused").shape == (1, 2) + (10,) * ndim
    if ndim == 2:
        return
    y = ft.fft_conv(torch.ones(1, 2, 12, 8, 8), torch.ones(2, 2, 11, 3, 3), impl="fused")
    assert y.shape == (1, 2, 2, 6, 6)
    assert torch.allclose(y, torch.full_like(y, 2 * 11 * 3 * 3), rtol=1e-5)


def test_fused_transpose_raises_not_implemented():
    """The fused 1D transposed route runs on a CPU tensor (B1's plain
    version on the stuffed signal); where no FFT size fits the stuffed
    signal it raises ValueError, as the forward does; impl="tiled" runs
    too (the composed path here, where one tile is the whole signal)."""
    x, w = torch.ones(1, 2, 20), torch.ones(2, 2, 3)
    y = ft.fft_conv_transpose(x, w, impl="fused")
    assert y.shape == (1, 2, 22)
    assert torch.allclose(y[:, :, 2:-2], torch.full_like(y[:, :, 2:-2], 6.0), rtol=1e-5)
    with pytest.raises(ValueError, match="no fused FFT configuration"):
        ft.fft_conv_transpose(torch.zeros(1, 1, 10), torch.zeros(1, 1, 8100), impl="fused")
    assert torch.equal(ft.fft_conv_transpose(x, w, impl="tiled"),
                       ft.fft_conv_transpose(x, w, impl="xla"))


def test_fused_without_a_plan_raises_like_jax():
    # K = 8100 leaves no full 128-sample block of valid outputs at any N
    x, w = _arrays(10, (1, 1, 8200), (1, 1, 8100))
    with pytest.raises(ValueError, match="no fused FFT configuration"):
        ft.fft_conv(torch.from_numpy(x), torch.from_numpy(w), impl="fused")
    with pytest.raises(ValueError, match="no fused FFT configuration"):
        fc.fft_conv(jnp.asarray(x), jnp.asarray(w), impl="fused")


@pytest.mark.parametrize(
    "signal,kernel,kw",
    [
        ((2, 4, 10), (2, 4), {}),                      # kernel rank
        ((4, 10), (2, 4, 3), {}),                      # no batch dim
        ((2, 4, 10), (3, 2, 3), {"groups": 2}),        # Cout % groups
        ((2, 4, 10), (2, 3, 3), {}),                   # Cin per group
        ((2, 4, 10), (2, 4, 3), {"padding_mode": "bogus"}),
        ((2, 4, 10), (2, 4, 3), {"impl": "bogus"}),
        ((2, 4, 10), (2, 4, 3), {"stride": (1, 2)}),   # tuple length
        ((2, 4, 10), (2, 4, 11), {}),                  # kernel longer than signal
    ],
)
def test_fft_conv_validation_matches_jax(signal, kernel, kw):
    kw = {"impl": "xla", **kw}
    with pytest.raises(ValueError):
        fc.fft_conv(jnp.zeros(signal), jnp.zeros(kernel), **kw)
    with pytest.raises(ValueError):
        ft.fft_conv(torch.zeros(signal), torch.zeros(kernel), **kw)


@pytest.mark.parametrize(
    "signal,kernel,kw",
    [
        ((2, 4, 10), (3, 2, 3), {}),             # signal Cin != kernel dim 0
        ((2, 3, 10), (3, 2, 3), {"groups": 2}),  # Cin % groups
        ((2, 4, 10), (4, 2), {}),                # kernel rank
        ((2, 4, 10), (4, 2, 3), {"impl": "bogus"}),
    ],
)
def test_fft_conv_transpose_validation_matches_jax(signal, kernel, kw):
    with pytest.raises(ValueError):
        fc.fft_conv_transpose(jnp.zeros(signal), jnp.zeros(kernel), **kw)
    with pytest.raises(ValueError):
        ft.fft_conv_transpose(torch.zeros(signal), torch.zeros(kernel), **kw)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, fft_conv_tpu_torch, fft_conv_tpu_torch.kernels.fused1d, "
        "fft_conv_tpu_torch.kernels.fused2d, fft_conv_tpu_torch.kernels.fused3d, "
        "fft_conv_tpu_torch.ops.spectral, fft_conv_tpu_torch.ops.tiled, "
        "fft_conv_tpu_torch.ops.plan, "
        "fft_conv_tpu_torch.utils.convert; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fft_conv_tpu' or m.startswith('fft_conv_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True)

