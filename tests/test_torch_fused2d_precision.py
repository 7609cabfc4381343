"""B2's and B5's precision modes, ``set_fused2d_precision``, against the JAX
package's.

The JAX switch picks how the fused 2D kernel forms each DFT matrix product:
FP32 ("highest"), three bf16 products of hi/lo splits ("bf16x3") or one
("bf16"). The port's switch picks the schedule's kernels: the FP32 pair, or
the tensor-core route whose DFT steps are bf16 products. On the CPU the
wrapper runs their plain version, which runs the route's order (B2: W first
on packed rows; B5, under ``set_fused2d_kernel("v3")``: H first on packed
columns) and rounds each product's operands where the kernels do; JAX
runs its Pallas kernel in interpret mode (its "bf16x3" as the exact split
``bf16x3_exact``). Each test sets JAX's mode and restores its default
"bf16x3" afterwards, and restores the port's default "highest" and the "v2"
schedule. The tensor-core kernels themselves are tested on the card in
``test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused2d as jax_fused2d
from fft_conv_tpu_torch.bench.profiling import cost_analysis
from fft_conv_tpu_torch.kernels import (costs, fused1d, fused2d, fused3d,
                                        set_fused2d_kernel, set_fused2d_precision)
from fft_conv_tpu_torch.ops import functional as F

from helpers import _assert_close_scaled
from test_torch_fused1d_precision import _lanes, _mma
from test_torch_fused2d import PARITY
from test_torch_fused2d_v3 import v3  # noqa: F401  (the fixture: both packages on "v3")


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def modes():
    """Sets both packages' 2D modes: ``modes(port, jax)``; restores their
    defaults ("highest" here, "bf16x3" in JAX) and the port's "v2" schedule
    afterwards."""
    def set_modes(port, jax=None):
        set_fused2d_precision(port)
        if jax is not None:
            jax_fused2d.set_fused2d_precision(jax)

    try:
        yield set_modes
    finally:
        set_fused2d_precision("highest")
        set_fused2d_kernel("v2")
        jax_fused2d.set_fused2d_precision("bf16x3")


@pytest.mark.parametrize("mode", ["highest", "bf16x3"])
@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups,stride,dilation,padding,pmode", PARITY)
def test_mode_matches_jax_fused(modes, mode, b, cin, cout, h, w, k1, k2, groups, stride,
                                dilation, padding, pmode):
    """"highest" and "bf16x3" against the JAX package in the same mode, under
    ``_assert_close_scaled``, at the parity cases of ``test_torch_fused2d``
    (every tile plan, groups, stride, dilation, padding modes)."""
    x, k, bias = _arrays(h + w + k2, (b, cin, h, w), (cout, cin // groups, k1, k2), (cout,))
    kw = dict(padding=padding, padding_mode=pmode, stride=stride, dilation=dilation,
              groups=groups)
    modes(mode, mode)
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw)
    before = fused2d.launches, fused2d.launches_tc
    y = fused2d.fft_conv2d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw)
    assert (fused2d.launches, fused2d.launches_tc) == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def _float64_conv(x, w, bias, padding):
    return TF.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                     torch.from_numpy(bias).double(), padding=padding).numpy()


def _err(y, y_ref):
    """(err_mean, err_max) in units of sigma = max(1, std(ref))."""
    sigma = max(1.0, float(np.std(y_ref)))
    err = np.abs(np.asarray(y, np.float64) - y_ref)
    return err.mean() / sigma, err.max() / sigma


# (seed, x shape, kernel shape, padding): the JAX package's bf16 test
# (tests/test_pallas2d.py:272-293, T1 = T2 = 128), then one case at each tile
# shape: 128 x 128, 256 x 128 (K1 = 70), 384 x 128 (K1 = 200), 128 x 256
# (K2 = 100)
BF16_CASES = [
    (38, (1, 2, 200, 180), (2, 2, 5, 5), 3),
    (1, (1, 2, 200, 160), (3, 2, 10, 12), 0),
    (2, (1, 2, 300, 140), (2, 2, 70, 5), 0),
    (3, (1, 2, 420, 150), (2, 2, 200, 9), 0),
    (4, (1, 2, 130, 300), (2, 2, 12, 100), 0),
]


@pytest.mark.parametrize("seed,xs,ws,padding", BF16_CASES)
def test_bf16_meets_the_serving_bar(modes, seed, xs, ws, padding):
    """"bf16", the port's and the JAX package's, each against torch's conv2d
    in float64 under JAX's serving bar (err_mean < 5e-3·σ, err_max <
    5e-2·σ, σ = max(1, std(ref)); ``tests/test_pallas2d.py:272-293``). The
    port's factored steps round twice per axis where JAX's dense products
    round once: on the CPU its err_mean is 3.8e-3 to 4.4e-3·σ here, JAX's
    3.1e-3 to 3.4e-3·σ."""
    x, w, bias = _arrays(seed, xs, ws, (ws[0],))
    if seed == 38:  # the JAX test's own draw order
        rng = np.random.default_rng(38)
        x, w, bias = (rng.standard_normal(s).astype(np.float32) for s in (xs, ws, (ws[0],)))
    y_ref = _float64_conv(x, w, bias, padding)
    modes("bf16", "bf16")
    y = fused2d.fft_conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), padding=padding)
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                         padding=padding)
    for out in (y.numpy(), np.asarray(y_jax)):
        mean, mx = _err(out, y_ref)
        assert mean < 5e-3 and mx < 5e-2, (mean, mx)


@pytest.mark.parametrize("seed,xs,ws,padding", BF16_CASES[1:])
def test_modes_are_told_apart(modes, seed, xs, ws, padding):
    """The three modes' errors against float64 are ordered, each err_mean at
    least 8x the one before ("highest" < "bf16x3" < "bf16"; measured on the
    CPU about 37x and 670x). A mode that runs another's arithmetic gives a
    ratio near 1 and fails."""
    x, w, bias = _arrays(seed, xs, ws, (ws[0],))
    y_ref = _float64_conv(x, w, bias, padding)
    errs = []
    for mode in fused2d.PRECISION_MODES:
        modes(mode)
        errs.append(_err(fused2d.fft_conv2d_fused(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            padding=padding).numpy(), y_ref)[0])
    assert 8 * errs[0] < errs[1] and 100 * errs[1] < errs[2], errs


@pytest.mark.parametrize("t1,t2", [(128, 128), (256, 128), (384, 128), (128, 256)])
def test_tc_pipeline_is_exact_in_float64(t1, t2):
    """The tensor-core route's order (``_tc_spectra``: W first on packed
    rows, the bins k and -k split into columns, the packed DC/Nyquist
    column, the conjugate fill; ``_tc_inverse``: the inverse W DFT, the
    Hermitian extension of column pairs) in float64 with FP32 products
    (``dot`` None) against the FP32 pair's plain order: the same D and the
    same valid rows, to float64 rounding."""
    nb1, v1 = t1 // 2 + 1, t1 - 9
    a, yr, yi = (torch.from_numpy(m).double() for m in _arrays(
        t1 + t2, (2, t1, t2), (2, nb1, t2), (2, nb1, t2)))
    dr, di = fused2d._tc_spectra(a, None)
    wr, wi = fused2d._dft_last(*fused2d._h_forward(a), False)
    assert dr.shape == wr.shape == (2, nb1, t2)
    assert (dr - wr).abs().max() < 1e-9 and (di - wi).abs().max() < 1e-9
    # a one-sided input whose DC and Nyquist rows are those of a real image
    yr[:, 0], yi[:, 0] = wr[:, 0], wi[:, 0]
    yr[:, -1], yi[:, -1] = wr[:, -1], wi[:, -1]
    out = fused2d._tc_inverse(yr, yi, v1, None)
    want = fused2d._h_irfft(*fused2d._w_inverse(yr, yi), v1)
    assert out.shape == want.shape == (2, v1, t2)
    assert (out - want).abs().max() < 1e-12 * want.abs().max()


def test_unknown_mode_raises_and_default_is_highest(modes):
    assert fused2d._PRECISION_2D == "highest"
    with pytest.raises(ValueError, match="fp8"):
        set_fused2d_precision("fp8")
    assert fused2d._PRECISION_2D == "highest"
    modes("bf16")
    assert fused2d._PRECISION_2D == "bf16"
    x, w = (torch.from_numpy(a) for a in _arrays(6, (1, 2, 60, 50), (2, 2, 5, 5)))
    plan = fused2d.tile_plan_2d(5, 5, 2, 2)
    with pytest.raises(ValueError, match="precision mode"):
        fused2d._fused2d_forward_reference(x, w, mode="fp8")
    with pytest.raises(ValueError, match="precision mode"):
        fused2d._launch_fused2d(x, fused2d.kernel_spectra_2d(w, plan[0], plan[2], plan[3]),
                                plan, 1, (5, 5), "fp8")


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_v3_under_a_bf16_mode_runs_its_plain_version(modes, mode):
    """A 2D call under "v3" and a bf16 mode runs B5's tensor-core route, on
    the CPU its plain version of that mode: the fused function,
    ``fft_conv(impl="fused")`` and a plan give
    ``_fused2d_forward_reference_v3(..., mode=)``, launch nothing, and differ
    from "highest" and from B2's route in the same mode."""
    x, w = (torch.from_numpy(a) for a in _arrays(7, (1, 2, 60, 50), (2, 2, 5, 5)))
    plan = fused2d.plan_fft_conv2d(w, signal_hw=(60, 50), device="cpu")
    set_fused2d_kernel("v3")
    modes(mode)
    want = fused2d._fused2d_forward_reference_v3(x, w, mode=mode)
    before = fused2d.launches_v3, fused2d.launches_v3_tc
    for call in (lambda: fused2d.fft_conv2d_fused(x, w), lambda: ft.fft_conv(x, w, impl="fused"),
                 lambda: plan(x)):
        with torch.no_grad():
            assert torch.equal(call(), want)
    assert (fused2d.launches_v3, fused2d.launches_v3_tc) == before
    assert not torch.equal(want, fused2d._fused2d_forward_reference_v3(x, w))
    assert not torch.equal(want, fused2d._fused2d_forward_reference(x, w, mode=mode))
    with pytest.raises(ValueError, match="precision mode"):
        fused2d._fused2d_forward_reference_v3(x, w, mode="fp8")


@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups,stride,dilation,padding,pmode", PARITY)
def test_v3_bf16x3_matches_jax_v3(modes, v3, b, cin, cout, h, w, k1, k2, groups, stride,
                                  dilation, padding, pmode):
    """B5's "bf16x3" (its plain version on the CPU) against JAX's v3 kernel
    under "bf16x3" under ``_assert_close_scaled``, at the parity cases of
    ``test_mode_matches_jax_fused``."""
    x, k, bias = _arrays(h + w + k2, (b, cin, h, w), (cout, cin // groups, k1, k2), (cout,))
    kw = dict(padding=padding, padding_mode=pmode, stride=stride, dilation=dilation,
              groups=groups)
    modes("bf16x3", "bf16x3")
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw)
    before = fused2d.launches_v3, fused2d.launches_v3_tc
    y = fused2d.fft_conv2d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw)
    assert (fused2d.launches_v3, fused2d.launches_v3_tc) == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


# B5's "bf16" error against float64, at most this many times JAX's v3 "bf16"
# (measured on the CPU at BF16_CASES: err_mean 1.21-1.35x, err_max 1.17-1.47x)
V3_BF16_FACTOR = 1.6


@pytest.mark.parametrize("seed,xs,ws,padding", BF16_CASES)
def test_v3_bf16_meets_the_serving_bar(modes, v3, seed, xs, ws, padding):
    """B5's "bf16" against torch's conv2d in float64, under JAX's serving bar
    (err_mean < 5e-3·σ, err_max < 5e-2·σ), with its err_mean and err_max at
    most ``V3_BF16_FACTOR`` times those of JAX's v3 kernel under "bf16"."""
    x, w, bias = _arrays(seed, xs, ws, (ws[0],))
    y_ref = _float64_conv(x, w, bias, padding)
    modes("bf16", "bf16")
    y = fused2d.fft_conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), padding=padding)
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                         padding=padding)
    ours, theirs = _err(y.numpy(), y_ref), _err(np.asarray(y_jax), y_ref)
    assert ours[0] < 5e-3 and ours[1] < 5e-2, ours
    assert ours[0] <= V3_BF16_FACTOR * theirs[0] and ours[1] <= V3_BF16_FACTOR * theirs[1], (
        ours, theirs)


@pytest.mark.parametrize("seed,xs,ws,padding", BF16_CASES[1:])
def test_v3_modes_are_told_apart(modes, v3, seed, xs, ws, padding):
    """Under "v3" the three modes' errors against float64 are ordered as
    B2's (``test_modes_are_told_apart``), each err_mean at least 8x, then
    100x, the one before."""
    x, w, bias = _arrays(seed, xs, ws, (ws[0],))
    y_ref = _float64_conv(x, w, bias, padding)
    errs = []
    for mode in fused2d.PRECISION_MODES:
        modes(mode)
        errs.append(_err(fused2d.fft_conv2d_fused(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            padding=padding).numpy(), y_ref)[0])
    assert 8 * errs[0] < errs[1] and 100 * errs[1] < errs[2], errs


@pytest.mark.parametrize("t1,t2", [(128, 128), (256, 128), (384, 128), (128, 256)])
def test_v3_steps_without_a_mode_product_are_the_fp32_steps(t1, t2):
    """``_v3_forward`` and ``_v3_inverse`` with ``dot=None`` are the undotted
    steps, and with a plain product passed as ``dot`` they equal them to
    float64 rounding: ``dot`` reaches only the DFT products."""
    nb1, v1 = t1 // 2 + 1, t1 - 15
    a, yr, yi = (torch.from_numpy(m).double() for m in _arrays(
        t1 * t2 + 1, (2, t1, t2), (2, nb1, t2), (2, nb1, t2)))
    fwd, inv = fused2d._v3_forward(a), fused2d._v3_inverse(yr, yi, v1)
    for got, want in zip(fused2d._v3_forward(a, None), fwd):
        assert torch.equal(got, want)
    assert torch.equal(fused2d._v3_inverse(yr, yi, v1, None), inv)
    for got, want in zip(fused2d._v3_forward(a, torch.matmul), fwd):
        assert (got - want).abs().max() < 1e-12 * want.abs().max()
    got = fused2d._v3_inverse(yr, yi, v1, torch.matmul)
    assert (got - inv).abs().max() < 1e-12 * inv.abs().max()


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_every_2d_route_follows_the_switch_under_v3(modes, mode):
    """Under "v3" and a bf16 mode the 2D plan, the fused transposed route and
    ``FFTConv2d`` equal ``fft_conv2d_fused`` in that mode (B5's plain
    version of it on the CPU), and differ from their results under
    "highest"."""
    x, w, bias = (torch.from_numpy(a) for a in _arrays(12, (2, 4, 90, 80), (4, 4, 9, 7), (4,)))
    layer = ft.FFTConv2d(4, 4, 9, padding=2, impl="fused", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    plan = fused2d.plan_fft_conv2d(w, bias, padding=2, signal_hw=(90, 80), device="cpu")
    wt = F._transpose_kernel_layout(w, 1, (1, 1))
    set_fused2d_kernel("v3")

    def routes():
        transposed = ft.fft_conv_transpose(x, w, bias, padding=3, impl="fused")
        with torch.no_grad():
            return plan(x), transposed, layer(x)

    def fused_calls():
        stuffed = F._stuff_full(x, wt.shape[2:], (1, 1), (0, 0))
        transposed = (fused2d.fft_conv2d_fused(stuffed, wt)[..., 3:-3, 3:-3]
                      + bias.reshape(1, -1, 1, 1))
        with torch.no_grad():
            return (fused2d.fft_conv2d_fused(x, w, bias, padding=2), transposed,
                    fused2d.fft_conv2d_fused(x, layer.weight, layer.bias, padding=2))

    highest = routes()
    modes(mode)
    for y, y_fused, y_highest in zip(routes(), fused_calls(), highest):
        assert torch.equal(y, y_fused)
        assert not torch.equal(y, y_highest)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_v3_bf16_gradients_equal_highest(modes, mode):
    """The backward of B5 is the composed path in every mode, so the
    gradients under "v3" and a bf16 mode are those under "highest"."""
    x, w, g = (torch.from_numpy(a) for a in _arrays(13, (2, 4, 70, 60), (4, 2, 9, 8),
                                                    (2, 4, 62, 53)))
    set_fused2d_kernel("v3")

    def grads():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fused2d.fft_conv2d_fused(xx, ww, groups=2) * g).sum().backward()
        return xx.grad, ww.grad

    highest = grads()
    modes(mode)
    for a, b in zip(grads(), highest):
        assert torch.equal(a, b)


def test_switch_leaves_1d_and_3d_alone(modes):
    """Under "bf16" the 1D and 3D fused calls (their plain versions here)
    give exactly what they give under "highest", and B1's switch stays
    "highest"."""
    x1, w1, x3, w3 = (torch.from_numpy(a) for a in _arrays(
        5, (1, 2, 3000), (2, 2, 100), (1, 2, 10, 12, 14), (2, 2, 3, 3, 3)))
    calls = (lambda: fused1d.fft_conv1d_fused(x1, w1), lambda: fused3d.fft_conv3d_fused(x3, w3))
    before = [fn() for fn in calls]
    modes("bf16")
    assert fused1d._PRECISION_MODE == "highest"
    for fn, y in zip(calls, before):
        assert torch.equal(fn(), y)


def test_every_2d_route_follows_the_switch(modes):
    """Under "bf16" the 2D plan, the fused transposed route and ``FFTConv2d``
    equal ``fft_conv2d_fused`` under "bf16" (on the CPU each runs B2's plain
    version of that mode), and differ from their results under "highest"."""
    x, w, bias = (torch.from_numpy(a) for a in _arrays(9, (2, 4, 90, 80), (4, 4, 9, 7), (4,)))
    layer = ft.FFTConv2d(4, 4, 9, padding=2, impl="fused", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    plan = fused2d.plan_fft_conv2d(w, bias, padding=2, signal_hw=(90, 80), device="cpu")
    wt = F._transpose_kernel_layout(w, 1, (1, 1))

    def routes():
        transposed = ft.fft_conv_transpose(x, w, bias, padding=3, impl="fused")
        with torch.no_grad():
            return plan(x), transposed, layer(x)

    def fused_calls():
        stuffed = F._stuff_full(x, wt.shape[2:], (1, 1), (0, 0))
        transposed = (fused2d.fft_conv2d_fused(stuffed, wt)[..., 3:-3, 3:-3]
                      + bias.reshape(1, -1, 1, 1))
        with torch.no_grad():
            return (fused2d.fft_conv2d_fused(x, w, bias, padding=2), transposed,
                    fused2d.fft_conv2d_fused(x, layer.weight, layer.bias, padding=2))

    highest = routes()
    modes("bf16")
    for y, y_fused, y_highest in zip(routes(), fused_calls(), highest):
        assert torch.equal(y, y_fused)
        assert not torch.equal(y, y_highest)


def test_bf16_gradients_equal_highest(modes):
    """The backward is the composed path in both packages, so the gradients
    under "bf16" are those under "highest"."""
    x, w, g = (torch.from_numpy(a) for a in _arrays(10, (2, 3, 70, 60), (4, 3, 9, 8),
                                                    (2, 4, 62, 53)))

    def grads():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fused2d.fft_conv2d_fused(xx, ww) * g).sum().backward()
        return xx.grad, ww.grad

    highest = grads()
    modes("bf16")
    for a, b in zip(grads(), highest):
        assert torch.equal(a, b)


def test_fragment_buffer_order():
    """``_tc_fragments`` holds each step's matrix where csrc/bf16_mma.cuh's
    ``frag_offset`` looks for it: for R = 8, 16, 24 the forward and then the
    conjugated R-point DFT, each hi then lo (``fused1d._b_fragments``)."""
    words = fused2d._tc_fragments(torch.device("cpu")).numpy().view(np.uint32)
    offset = {8: 0, 16: 4 * 2 * 64, 24: 4 * 2 * (64 + 256)}  # frag_offset(r, false)
    assert words.size == 4 * 2 * (64 + 256 + 576)
    for r in fused2d._TC_RADICES:
        f = fused1d.fft_factor_matrices(r, 1)[0]
        at = offset[r]
        for m in (f, np.conj(f)):
            for half in fused1d._b_fragments(m):
                assert np.array_equal(words[at:at + 2 * r * r], half)
                at += 2 * r * r


@pytest.mark.parametrize("inverse", [False, True])
def test_24_point_fragments_follow_the_mma_layout(inverse):
    """The 24-point step of T1 = 384 is three whole k-steps of 16 and six
    n-tiles: 16 complex vectors in A registers as ``dft_step`` loads them
    (elements j = 8 s + t and j + 4 at k-step s), through ``_mma`` with each
    n-tile's hi fragments, give the DFT with its entries rounded to bf16."""
    r = 24
    f = fused1d.fft_factor_matrices(r, 1)[0]
    f = np.conj(f) if inverse else f
    hi, _ = fused1d._b_fragments(f)
    rng = np.random.default_rng(r)
    zb = torch.from_numpy(rng.standard_normal((16, r, 2)).astype(np.float32)).to(torch.bfloat16)
    words = zb.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 16
    fb = torch.complex(*(torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16).double()
                         for p in (f.real, f.imag)))
    want = (torch.complex(zb[..., 0].double(), zb[..., 1].double()) @ fb.T).numpy()
    got = np.zeros((16, r), complex)
    frags = hi.reshape(r // 8, r // 4, 32, 2)
    for u in range(r // 4):
        acc = np.zeros((32, 4))
        for s in range(r // 8):
            a = np.array([[words[g, 8 * s + t], words[g + 8, 8 * s + t],
                           words[g, 8 * s + t + 4], words[g + 8, 8 * s + t + 4]]
                          for g, t in _lanes()], np.uint32)
            acc += _mma(a, frags[s, u])
        for lane, (g, t) in enumerate(_lanes()):
            got[g, 4 * u + t] = acc[lane, 0] + 1j * acc[lane, 1]
            got[g + 8, 4 * u + t] = acc[lane, 2] + 1j * acc[lane, 3]
    assert np.abs(got - want).max() < 1e-9


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_cost_analysis_records_the_mode(modes, mode):
    """Under a bf16 mode a fused 2D call records "B2_<mode>" with the
    tensor-core count, three times the products under "bf16x3", and the
    bytes of the route: the function's and the MAC stage's Y; the bound
    weighs the products at the bf16 rate."""
    x, w = (torch.from_numpy(a) for a in _arrays(11, (2, 4, 150, 140), (6, 4, 9, 9)))
    plan = fused2d.tile_plan_2d(9, 9, 4, 6)
    nbytes, products, rest = costs.fused2d_tc_work(2, 4, 6, 150, 140, 9, plan, mode)
    modes(mode)
    out = cost_analysis(lambda s, kk: ft.fft_conv(s, kk, impl="fused"), x, w)
    assert out["kernels"] == {f"B2_{mode}": {"calls": 1, "flops": products + rest,
                                             "bytes": nbytes}}
    other = costs.fused2d_tc_work(2, 4, 6, 150, 140, 9, plan,
                                  "bf16" if mode == "bf16x3" else "bf16x3")
    assert products * (1 if mode == "bf16x3" else 3) == other[1] * (3 if mode == "bf16x3" else 1)
    # the inputs and output once, and the MAC stage's Y (2 x 2 tiles, B = 2,
    # Cout = 6) written and read once
    y_bytes = 2 * 2 * 2 * 6 * plan[2] * plan[3] * 8
    assert nbytes == costs.fused2d_work(2, 4, 6, 150, 140, 9, plan)[0] + 2 * y_bytes
    assert rest == other[2] and nbytes == other[0]
    ms, by = costs.bound(nbytes, rest, products)
    assert ms == max(nbytes / costs.HBM_BYTES_PER_S,
                     rest / costs.FP32_FLOPS_PER_S + products / costs.BF16_FLOPS_PER_S) * 1e3
    # under "v3", "B5_<mode>" with B5's route's count: the same bytes, the H
    # DFTs of the T2/2 packed columns and pairs, the W DFTs of the T1/2 rows
    # (rows 0 and T1/2 packed as one) and of the ceil(V1/2) row pairs
    set_fused2d_kernel("v3")
    out = cost_analysis(lambda s, kk: ft.fft_conv(s, kk, impl="fused"), x, w)
    v3_bytes, v3_products, v3_rest = costs.fused2d_tc_work(2, 4, 6, 150, 140, 9, plan, mode,
                                                           v3=True)
    assert out["kernels"] == {f"B5_{mode}": {"calls": 1, "flops": v3_products + v3_rest,
                                             "bytes": v3_bytes}}
    t1, v1, _, t2, _ = plan
    tiles, passes = 2 * 2 * 2, 3 if mode == "bf16x3" else 1
    dft = lambda a, bb: 8 * (bb * a * a + a * bb * bb)  # noqa: E731
    h_dft, w_dft = dft(*fused2d._SPLITS[t1]), dft(*fused2d._SPLITS[t2])
    assert v3_bytes == nbytes and v3_products == tiles * passes * (
        4 * (t2 // 2 * h_dft + t1 // 2 * w_dft) + 6 * (t2 // 2 * h_dft + -(-v1 // 2) * w_dft))


# (B, Cin, Cout, groups, H, W, K1, K2): shapes fused2d_fits admits, at the
# 2D rows, every tile plan, groups down to one channel a group, a group of
# more output channels than a MAC block holds, the largest spectra a plan
# takes (Cout x Cin/g = 252 at 128 x 128), many tiles, and batches whose
# D and Y of one tile top _SCRATCH_BUDGET (D alone fits)
GEOMETRY = [
    (2, 8, 8, 1, 512, 512, 16, 16),
    (2, 8, 8, 1, 512, 512, 34, 34),
    (3, 8, 8, 1, 512, 512, 16, 16),
    (2, 6, 6, 3, 300, 290, 16, 16),
    (2, 4, 4, 4, 300, 290, 16, 16),
    (2, 24, 24, 3, 200, 210, 9, 9),
    (1, 15, 15, 1, 200, 210, 9, 9),
    (1, 1, 100, 1, 300, 290, 16, 16),
    (1, 1, 252, 1, 200, 200, 5, 5),
    (2, 8, 8, 1, 300, 280, 70, 5),
    (1, 4, 4, 1, 420, 150, 200, 9),
    (2, 4, 6, 2, 200, 300, 12, 100),
    (1, 2, 2, 1, 4096, 4096, 16, 16),
    (128, 15, 15, 1, 256, 256, 16, 16),
    (200, 15, 15, 1, 256, 256, 16, 16),
]


def _mac_blocks(b, cin, cout, groups, plan, ntiles):
    """The tensor-core route's launches as ``_launch_fused2d`` runs them:
    for each tile range, each MAC block's (units, output channels) as the
    kernel derives them from ``_tc_geometry`` (csrc/fused2d.cu:
    fused2d_mac_tc's grid and its first lines). Returns (tiles a launch,
    units a block, output channels a block, [(tile0, ntile, [(units,
    output channels)])])."""
    chunk, upb, ocb = fused2d._tc_geometry(b, cin, cout, groups, plan, ntiles)
    og = cout // groups
    noc = -(-og // ocb)
    launches = []
    for tile0 in range(0, ntiles, chunk):
        ntile = min(chunk, ntiles - tile0)
        units = ntile * b
        blocks = []
        for bx in range(-(-units // upb)):
            for bz in range(groups * noc):
                g, oc0 = bz // noc, bz % noc * ocb
                us = range(bx * upb, min(bx * upb + upb, units))
                blocks.append(([(tile0 + u // b, u % b) for u in us],
                               [g * og + o for o in range(oc0, min(oc0 + ocb, og))]))
        launches.append((tile0, ntile, blocks))
    return chunk, upb, ocb, launches


@pytest.mark.parametrize("budget", ["default", "four tiles of D"])
@pytest.mark.parametrize("b,cin,cout,groups,h,w,k1,k2", GEOMETRY)
def test_tc_launch_geometry_covers_every_admitted_shape(monkeypatch, budget, b, cin, cout,
                                                        groups, h, w, k1, k2):
    """The tensor-core route's launch geometry (``_tc_geometry``, the same
    under "bf16x3" and "bf16") at shapes ``fused2d_fits`` admits: at least
    one tile a launch; the launches' tile ranges cover each tile once and
    their D and Y fit ``_SCRATCH_BUDGET`` unless a launch is one tile; the
    MAC blocks of a launch cover each (tile, batch row, output channel)
    once, each inside one group, with rows that fit the plane
    (``_TC_PLANE_BYTES``) and a grid inside CUDA's limits."""
    cpg = cin // groups
    assert fused2d.fused2d_fits(k1, k2, cpg, cout, (h, w), cin_total=cin, batch=b)
    plan = fused2d.tile_plan_2d(k1, k2, cpg, cout)
    _, _, nb1, t2, _ = plan
    if budget != "default":
        monkeypatch.setattr(fused2d, "_SCRATCH_BUDGET",
                            4 * fused2d._scratch_bytes_per_tile(nb1, t2, b, cin))
    ntiles = math.prod(fused2d._tiling(plan, h, w, k1, k2)[2:])
    chunk, upb, ocb, launches = _mac_blocks(b, cin, cout, groups, plan, ntiles)
    assert chunk >= 1 and upb >= 1 and 1 <= ocb <= cout // groups
    assert upb * ocb * t2 * 8 <= fused2d._TC_PLANE_BYTES
    per_tile = fused2d._scratch_bytes_per_tile(nb1, t2, b, cin + cout)
    assert chunk == 1 or chunk * per_tile <= fused2d._SCRATCH_BUDGET
    tiles = [t for tile0, ntile, _ in launches for t in range(tile0, tile0 + ntile)]
    assert tiles == list(range(ntiles))
    og = cout // groups
    for tile0, ntile, blocks in launches:
        seen = [(t, bb, o) for units, outs in blocks for t, bb in units for o in outs]
        assert sorted(seen) == [(t, bb, o) for t in range(tile0, tile0 + ntile)
                                for bb in range(b) for o in range(cout)]
        assert all(len({o // og for o in outs}) == 1 for _, outs in blocks)
        assert -(-ntile * b // upb) < 2**31 and groups * -(-og // ocb) <= 65535


def test_tc_geometry_fills_the_mac_blocks():
    """At the 2D rows a MAC block holds all 8 output channels of the group
    and 8 units (64 rows: one row group of the inverse W DFT for each of its
    8 warps), the units dealt evenly: 50 units in 7 blocks of at most 8 at
    K=16, 72 in 9 of 8 at K=34; D and Y of all 25 or 36 tiles in one
    launch."""
    for k, ntiles, upb in ((16, 25, 8), (34, 36, 8)):
        plan = fused2d.tile_plan_2d(k, k, 8, 8)
        assert fused2d._tc_geometry(2, 8, 8, 1, plan, ntiles) == (ntiles, upb, 8)
