"""The port's overlap-save tiling (``fft_conv_tpu_torch/ops/tiled.py``) and
``impl="tiled"`` against the JAX package's, the cases of
``tests/test_tiled.py`` through the same ``grid(...)`` sampling.

Seeded numpy inputs go through both packages on the CPU and are held with
``helpers._assert_close_scaled``; the planner must return exactly JAX's
tuples, the benchmark rows included.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu.ops.functional as jax_functional
import fft_conv_tpu.ops.tiled as jax_tiled
import fft_conv_tpu_torch.ops.functional as functional
import fft_conv_tpu_torch.ops.tiled as tiled

from helpers import _assert_almost_equal, _assert_close_scaled, grid

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_tiled(x, w, **kw):
    """JAX's ``tiled_valid_corr`` under one ``jax.jit`` (its keywords
    static): op-by-op dispatch on the CPU takes seconds a call."""
    return jax.jit(functools.partial(jax_tiled.tiled_valid_corr, **kw))(x, w)


@pytest.mark.parametrize(
    "ndim,size,k,tile",
    [
        (1, 300, 17, (26,)),
        (1, 300, 17, (64,)),
        (2, 70, 9, (24, 32)),
        (2, 65, 12, (20, 48)),
        (3, 40, 5, (16, 24, 12)),
    ],
)
def test_tiled_valid_corr_matches_jax(ndim, size, k, tile):
    x, w = _arrays(ndim * 100 + k, (2, 3) + (size,) * ndim, (4, 3) + (k,) * ndim)
    got = tiled.tiled_valid_corr(torch.from_numpy(x), torch.from_numpy(w), tile=tile)
    want = _jax_tiled(jnp.asarray(x), jnp.asarray(w), tile=tile)
    _assert_close_scaled(got.numpy(), np.asarray(want))
    _assert_almost_equal(got.numpy(), _CONV[ndim](torch.from_numpy(x), torch.from_numpy(w)).numpy())


def test_tiled_groups_and_out_len_match_jax():
    x, w, x1, w1 = _arrays(0, (2, 6, 80, 77), (4, 3, 11, 7), (2, 3, 50), (5, 3, 9))
    got = tiled.tiled_valid_corr(torch.from_numpy(x), torch.from_numpy(w), groups=2,
                                 tile=(32, 24))
    want = _jax_tiled(jnp.asarray(x), jnp.asarray(w), groups=2, tile=(32, 24))
    _assert_close_scaled(got.numpy(), np.asarray(want))
    # out_len beyond the valid region: the zero-extended signal (the
    # transposed conv's crop)
    got = tiled.tiled_valid_corr(torch.from_numpy(x1), torch.from_numpy(w1), out_len=(55,),
                                 tile=(32,))
    want = _jax_tiled(jnp.asarray(x1), jnp.asarray(w1), out_len=(55,),
                                      tile=(32,))
    _assert_close_scaled(got.numpy(), np.asarray(want))
    ref = torch.nn.functional.conv1d(torch.from_numpy(np.pad(x1, ((0, 0), (0, 0), (0, 20)))),
                                     torch.from_numpy(w1))[:, :, :55]
    _assert_almost_equal(got.numpy(), ref.numpy())


def test_tiled_keeps_the_input_dtype_as_jax_does():
    """bfloat16 in and out, rounded: a loose bar against JAX's bfloat16
    result. float64 (JAX's default x64-off dtype is float32) is computed in
    float32 and held to JAX's float32 result at the usual bar."""
    x, w = _arrays(1, (1, 2, 90), (2, 2, 7))
    got = tiled.tiled_valid_corr(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                                 tile=(32,))
    assert got.dtype == torch.bfloat16
    want = _jax_tiled(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                      tile=(32,))
    assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() < 0.1
    got = tiled.tiled_valid_corr(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                                 tile=(32,))
    assert got.dtype == torch.float64
    want = _jax_tiled(jnp.asarray(x), jnp.asarray(w), tile=(32,))
    _assert_close_scaled(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "stride,padding,dilation,groups,pmode",
    grid([1, 2], [0, 1, 3], [1, 2], [1, 3], ["constant", "reflect", "circular"], step=5),
)
def test_fft_conv_impl_tiled_2d_matches_jax(stride, padding, dilation, groups, pmode):
    x, w, b = _arrays(stride * 7 + padding * 3 + dilation, (2, 3 * groups, 41, 38),
                      (2 * groups, 3, 5, 4), (2 * groups,))
    kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups,
              padding_mode=pmode, impl="tiled")
    got = functional.fft_conv(*map(torch.from_numpy, (x, w, b)), **kw)
    want = jax_functional.fft_conv(*map(jnp.asarray, (x, w, b)), **kw)
    _assert_close_scaled(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "stride,padding,output_padding,groups",
    grid([1, 2, 3], [0, 1, 2], [0, 1], [1, 2], step=3),
)
def test_fft_conv_transpose_impl_tiled_matches_jax(stride, padding, output_padding, groups):
    if output_padding >= stride:
        stride += output_padding
    x, w, b = _arrays(stride * 5 + padding, (2, 4, 33, 29), (4, 6 // groups, 4, 5), (6,))
    kw = dict(stride=stride, padding=padding, output_padding=output_padding, groups=groups,
              impl="tiled")
    got = functional.fft_conv_transpose(*map(torch.from_numpy, (x, w, b)), **kw)
    want = jax_functional.fft_conv_transpose(*map(jnp.asarray, (x, w, b)), **kw)
    _assert_close_scaled(got.numpy(), np.asarray(want))
    ref = torch.nn.functional.conv_transpose2d(
        *map(torch.from_numpy, (x, w, b)), stride=stride, padding=padding,
        output_padding=output_padding, groups=groups)
    _assert_almost_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("shapes,kw", [
    (((2, 4, 3000), (6, 2, 200), (6,)), dict(stride=2, padding=3, dilation=2, groups=2)),
    (((1, 2, 600, 20, 20), (3, 2, 5, 3, 3), (3,)),
     dict(stride=(2, 1, 1), padding=1, dilation=(1, 2, 1), padding_mode="reflect")),
])
def test_fft_conv_impl_tiled_1d_3d_matches_jax(monkeypatch, shapes, kw):
    """impl="tiled" in 1D and 3D, on signals long enough to take several
    tiles (along D in 3D)."""
    calls = []
    real = functional.tiled_valid_corr
    monkeypatch.setattr(functional, "tiled_valid_corr",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w, b = _arrays(len(shapes[0]), *shapes)
    got = functional.fft_conv(*map(torch.from_numpy, (x, w, b)), impl="tiled", **kw)
    want = jax_functional.fft_conv(*map(jnp.asarray, (x, w, b)), impl="tiled", **kw)
    assert calls == [1]
    _assert_close_scaled(got.numpy(), np.asarray(want))


def test_tiled_gradients_match_jax():
    x, w = _arrays(3, (2, 3, 40, 36), (2, 3, 5, 5))

    def jax_grads(impl):
        return jax.grad(
            lambda x_, w_: jnp.sum(jax_functional.fft_conv(x_, w_, impl=impl) ** 2),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (functional.fft_conv(xt, wt, impl="tiled") ** 2).sum().backward()
    gx, gw = jax_grads("tiled")
    _assert_close_scaled(xt.grad.numpy(), np.asarray(gx))
    _assert_close_scaled(wt.grad.numpy(), np.asarray(gw))
    _, gw_xla = jax_grads("xla")
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_xla), rtol=2e-4, atol=2e-3)


# (spatial, dilated kernel, outputs, (batch, cin, cout)): the benchmark rows
# (512^2 K=16 and 34, 1D 32768 K=1024, 64^3 K=8 and 10, 128^3 K=8), the
# stuffed 2D transposed row, the JAX test's 1D row, and a small grid
PLAN_CASES = [
    ((512, 512), (16, 16), (497, 497), (2, 8, 8)),
    ((512, 512), (34, 34), (479, 479), (2, 8, 8)),
    ((32768,), (1024,), (31745,), (2, 8, 8)),
    ((64, 64, 64), (8, 8, 8), (57, 57, 57), (2, 8, 8)),
    ((64, 64, 64), (10, 10, 10), (55, 55, 55), (2, 8, 8)),
    ((128, 128, 128), (8, 8, 8), (121, 121, 121), (2, 8, 8)),
    ((542, 542), (16, 16), (527, 527), (2, 8, 8)),
    ((32768,), (256,), (32513,), (2, 8, 8)),
] + [
    ((s,) * n, (k,) * n, (s - k + 1 + extra,) * n, (b, c, c))
    for n, s, k, extra, b, c in itertools.product((1, 2, 3), (96, 300), (5, 40), (0, 30), (1, 4),
                                                  (2, 16))
    if n < 3 or (s == 96 and b == 1)
]


@pytest.mark.parametrize("spatial,kernel,out_len,channels", PLAN_CASES)
def test_planner_returns_jax_values(spatial, kernel, out_len, channels):
    assert tiled.plan_tiles(spatial, kernel, out_len, channels) == jax_tiled.plan_tiles(
        spatial, kernel, out_len, channels)
    assert tiled.untiled_shape(spatial, kernel, out_len) == jax_tiled.untiled_shape(
        spatial, kernel, out_len)


def test_planner_at_the_benchmark_rows():
    tiles = [tiled.plan_tiles(*case)[0] for case in PLAN_CASES[:6]]
    assert tiles == [(128, 128), (160, 160), (2048,), (64, 64, 64), (64, 64, 64),
                     (128, 128, 128)]
    # the 3D rows' plans are the whole volume: impl="tiled" is composed there
    assert [t == tiled.untiled_shape(*case[:3]) for t, case in zip(tiles, PLAN_CASES)] == \
        [False] * 3 + [True] * 3


@pytest.mark.parametrize("tile,valid,nt,size", [
    (24, 16, 1, 20),   # one window, padded
    (24, 16, 1, 40),   # one window, cut
    (24, 16, 4, 50),   # overlap <= valid, padded past the end
    (24, 20, 2, 90),   # overlap <= valid, cut
    (26, 10, 5, 60),   # tile > 2 * valid
    (16, 16, 3, 48),   # no overlap
])
def test_window_axis_matches_jax(tile, valid, nt, size):
    (x,) = _arrays(tile + nt, (2, 3, size, 5))
    got = tiled._window_axis(torch.from_numpy(x), 2, tile, valid, nt)
    want = jax_tiled._window_axis(jnp.asarray(x), 2, tile, valid, nt)
    assert got.shape == (2, 3, nt, tile, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,kshape,kw,pays", [
    ((1, 2, 256, 256), (2, 2, 5, 5), {}, True),
    ((1, 2, 24, 24, 24), (3, 2, 5, 5, 5), {}, False),
    ((1, 4, 300), (4, 2, 17), dict(stride=2, padding=3, dilation=2, groups=2), True),
])
def test_tiled_falls_through_where_the_plan_is_whole(monkeypatch, shape, kshape, kw, pays):
    """``impl="tiled"`` tiles exactly where JAX's plan is not one whole
    transform (its degenerate-plan rule), and its result is JAX's."""
    calls = []
    real = tiled.tiled_valid_corr
    monkeypatch.setattr(functional, "tiled_valid_corr",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    spatial = tuple(s + 2 * kw.get("padding", 0) for s in shape[2:])
    k_dil = tuple((k - 1) * kw.get("dilation", 1) + 1 for k in kshape[2:])
    out_len = tuple(s - k + 1 for s, k in zip(spatial, k_dil))
    tile = jax_tiled.plan_tiles(spatial, k_dil, out_len, (shape[0], shape[1], kshape[0]))[0]
    assert (tile != jax_tiled.untiled_shape(spatial, k_dil, out_len)) == pays
    x, w = _arrays(len(shape), shape, kshape)
    got = functional.fft_conv(torch.from_numpy(x), torch.from_numpy(w), impl="tiled", **kw)
    assert calls == ([1] if pays else [])
    want = jax_functional.fft_conv(jnp.asarray(x), jnp.asarray(w), impl="tiled", **kw)
    _assert_close_scaled(got.numpy(), np.asarray(want))
