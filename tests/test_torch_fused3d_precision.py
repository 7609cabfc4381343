"""B3's and B4's precision modes, ``set_fused3d_precision``, against the JAX
package's.

The JAX switch picks how both 3D Pallas bodies form each DFT matrix product:
FP32 ("highest"), three bf16 products of hi/lo splits ("bf16x3", its
default) or one ("bf16"). The port's switch picks B3's and B4's chains: the
FP32 kernels, or the tensor-core kernels whose DFT steps are bf16 products.
On the CPU the wrapper runs their plain version, which runs the tensor-core
kernels' order (the H DFT on slab pairs at every H, one dense step below 16;
the DFT-16 as one dense step) and rounds each product's operands where the
kernels do; JAX runs its Pallas kernels in interpret mode (its "bf16x3" as
the exact split ``bf16x3_exact``). Each test sets JAX's mode and restores its
default "bf16x3" afterwards, and restores the port's default "highest" and
x-pack and inline switches. The tensor-core kernels themselves are tested on
the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu_torch.bench.profiling import cost_analysis
from fft_conv_tpu_torch.kernels import (costs, fused1d, fused2d, fused3d, set_fused2d_precision,
                                        set_fused3d_inline, set_fused3d_precision,
                                        set_fused3d_xpack, set_fused_precision)
from fft_conv_tpu_torch.ops import functional as F

from helpers import _assert_close_scaled
from test_torch_fused1d_precision import _lanes, _mma


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def modes():
    """Sets both packages' 3D modes: ``modes(port, jax)``; restores their
    defaults ("highest" here, "bf16x3" in JAX) and the port's other 3D and
    the 1D and 2D switches afterwards."""
    def set_modes(port, jax=None):
        set_fused3d_precision(port)
        if jax is not None:
            jax_fused3d.set_fused3d_precision(jax)

    try:
        yield set_modes
    finally:
        set_fused3d_precision("highest")
        set_fused3d_xpack("h2")
        set_fused3d_inline(False)
        set_fused_precision("highest")
        set_fused2d_precision("highest")
        jax_fused3d.set_fused3d_precision("bf16x3")


# (B, Cin, Cout, D, H, W, KD, KH, KW, groups, padding): 'v4' plans at H = 12
# and 13 (one dense H step at Hw = H, an even and an odd length), 20 (5 x 4,
# groups 2), 33 (padded to 36 = 6 x 6), 48 (8 x 6) and with W cut into two
# blocks (padding 1, H = 14); 'tap' plans (KD > 9) at H = 48 and at
# H = 10 with groups 3
CASES = [
    (1, 2, 3, 11, 12, 10, 3, 3, 3, 1, 0),
    (1, 2, 2, 9, 13, 12, 4, 3, 3, 1, 0),
    (1, 4, 4, 9, 20, 10, 3, 5, 3, 2, 0),
    (1, 2, 2, 9, 33, 10, 3, 3, 3, 1, 0),
    (1, 2, 2, 9, 48, 10, 5, 3, 3, 1, 0),
    (1, 1, 2, 6, 12, 98, 2, 3, 7, 1, 1),
    (1, 2, 2, 12, 48, 10, 10, 3, 3, 1, 0),
    (1, 6, 6, 13, 10, 10, 11, 3, 3, 3, 0),
]


@pytest.mark.parametrize("mode", ["highest", "bf16x3"])
@pytest.mark.parametrize("b,cin,cout,d,h,w,kd,kh,kw,groups,padding", CASES)
def test_mode_matches_jax_fused(modes, mode, b, cin, cout, d, h, w, kd, kh, kw, groups, padding):
    """"highest" and "bf16x3" against the JAX package in the same mode, under
    ``_assert_close_scaled``, at 'v4' and 'tap' plans, the dense H step (H =
    12, 13), the factored one at a padded and at a mixed-radix working
    length, groups and W blocks. No kernel launches on the CPU."""
    x, k, bias = _arrays(d + h + w + kd, (b, cin, d, h, w), (cout, cin // groups, kd, kh, kw),
                         (cout,))
    kw_ = dict(padding=padding, groups=groups)
    modes(mode, mode)
    y_jax = jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw_)
    counters = ("launches", "launches_tap", "launches_tc", "launches_tap_tc")
    before = [getattr(fused3d, c) for c in counters]
    y = fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw_)
    assert [getattr(fused3d, c) for c in counters] == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


@pytest.mark.parametrize("mode", ["highest", "bf16x3"])
def test_pk_and_transposed_match_jax(modes, mode):
    """The "pk" x-pack route (B6's plain version ahead of B3's) and the fused
    transposed route, each against the JAX package in the same mode."""
    x, k, bias = _arrays(21, (1, 2, 10, 14, 12), (3, 2, 3, 5, 3), (3,))
    modes(mode, mode)
    set_fused3d_xpack("pk")
    jax_fused3d.set_fused3d_xpack("pk")
    try:
        y_jax = jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    finally:
        jax_fused3d.set_fused3d_xpack("h2")
    y = fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias))
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))
    set_fused3d_xpack("h2")
    xt, wt, bt = _arrays(22, (1, 2, 7, 8, 9), (2, 3, 3, 3, 3), (3,))
    kw = dict(stride=2, padding=1, output_padding=1)
    y_jax = jax_fused3d.fft_conv_transpose3d_fused(jnp.asarray(xt), jnp.asarray(wt),
                                                   jnp.asarray(bt), **kw)
    y = fused3d.fft_conv_transpose3d_fused(torch.from_numpy(xt), torch.from_numpy(wt),
                                           torch.from_numpy(bt), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def _err(y, y_ref):
    """(err_mean, err_max) in units of sigma = max(1, std(ref))."""
    sigma = max(1.0, float(np.std(y_ref)))
    err = np.abs(np.asarray(y, np.float64) - y_ref)
    return err.mean() / sigma, err.max() / sigma


def test_bf16_meets_the_serving_bar(modes):
    """"bf16", the port's and the JAX package's, each against torch's conv3d
    in float64 under JAX's serving bar (err_mean < 5e-3·σ, err_max <
    5e-2·σ, σ = max(1, std(ref))) at JAX's own case
    (``tests/test_pallas3d.py:315``: seed 39, H = 12, the dense H step)."""
    rng = np.random.default_rng(39)
    x = rng.standard_normal((1, 4, 14, 12, 10)).astype(np.float32)
    w = rng.standard_normal((4, 4, 3, 3, 3)).astype(np.float32)
    bias = rng.standard_normal((4,)).astype(np.float32)
    y_ref = TF.conv3d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                      torch.from_numpy(bias).double()).numpy()
    modes("bf16", "bf16")
    y = fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias))
    y_jax = jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    for out in (y.numpy(), np.asarray(y_jax)):
        mean, mx = _err(out, y_ref)
        assert mean < 5e-3 and mx < 5e-2, (mean, mx)


@pytest.mark.parametrize("case", [CASES[2], CASES[4], CASES[6]])
def test_modes_are_told_apart(modes, case):
    """The three modes' errors against float64 are ordered, each err_mean at
    least 8x the one before ("highest" < "bf16x3" < "bf16"; on the CPU
    about 40x and 600x). A mode that runs another's arithmetic gives a ratio
    near 1 and fails."""
    b, cin, cout, d, h, w, kd, kh, kw, groups, padding = case
    x, k = _arrays(3, (b, cin, d, h, w), (cout, cin // groups, kd, kh, kw))
    y_ref = TF.conv3d(torch.from_numpy(x).double(), torch.from_numpy(k).double(),
                      padding=padding, groups=groups).numpy()
    errs = []
    for mode in fused3d.PRECISION_MODES:
        modes(mode)
        errs.append(_err(fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                                  padding=padding, groups=groups).numpy(),
                         y_ref)[0])
    assert 8 * errs[0] < errs[1] and 100 * errs[1] < errs[2], errs


@pytest.mark.parametrize("h", [5, 13, 16, 36, 48, 84, 126, 256])
def test_tc_pipeline_is_exact_in_float64(h):
    """The tensor-core chain's order with FP32 products (a plain ``@`` as the
    product) in float64 against the FP32 chain's order: the H/W forward (the
    H DFT on slab pairs at every H, one dense step below 16), the inverse
    (the Hermitian extension of slab pairs, also at an odd H) and the dense
    DFT-16 give the same values to float64 rounding."""
    x, er, ei = (torch.from_numpy(a).double() for a in _arrays(
        h, (1, 2, 5, h, 64), (1, 2, 5, h // 2 + 1, 64), (1, 2, 5, h // 2 + 1, 64)))
    hw = fused3d._h_work(h)[0]
    fr, fi, cr, ci = fused3d._torch_mats(h, h - 2, torch.float64, torch.device("cpu"))
    want = fused3d._hw_forward_reference(x, fr, fi)
    got = fused3d._hw_forward_reference(x, fr, fi, dot=torch.matmul)
    assert all((a - b).abs().max() < 1e-9 for a, b in zip(got, want))
    # a one-sided input whose DC and Nyquist rows are those of a real signal
    if hw == h:
        er[..., 0, :], ei[..., 0, :] = want[0][..., 0, :], want[1][..., 0, :]
        er[..., -1, :], ei[..., -1, :] = want[0][..., -1, :], want[1][..., -1, :]
        blocks = [(0, 0, 64)]
        want = fused3d._hw_inverse_reference(er, ei, cr, ci, blocks, h, 64)
        got = fused3d._hw_inverse_reference(er, ei, cr, ci, blocks, h, 64, torch.matmul)
        assert (got - want).abs().max() < 1e-9 * want.abs().max()
    dr, di = fused3d._dft_steps(x, x.flip(-1), (64, 1), True)
    wr, wi = fused3d.dft_last(x, x.flip(-1), (8, 8), True)
    assert (dr - wr).abs().max() < 1e-9 and (di - wi).abs().max() < 1e-9


def test_unknown_mode_raises_and_default_is_highest(modes):
    assert fused3d._PRECISION_3D == "highest"
    with pytest.raises(ValueError, match="fp8"):
        set_fused3d_precision("fp8")
    assert fused3d._PRECISION_3D == "highest"
    modes("bf16")
    assert fused3d._PRECISION_3D == "bf16"
    x, w = (torch.from_numpy(a) for a in _arrays(6, (1, 2, 10, 12, 10), (2, 2, 3, 3, 3)))
    for fn in (fused3d._fused3d_forward_reference, fused3d._fused3d_tap_reference):
        with pytest.raises(KeyError, match="fp8"):  # the plain versions do not validate
            fn(x, w, mode="fp8")
    with pytest.raises(ValueError, match="precision mode"):
        fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(w, 12), 1, (3, 3, 3), mode="fp8")


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_h_past_256_raises(modes, mode):
    """Under a bf16 mode an H past 256 raises ValueError on the CPU as on the
    card, through the fused function, ``fft_conv(impl="fused")``, a plan,
    the plain versions and the launchers, and runs nothing; under "highest"
    it runs (the dense FP32 H/W kernels)."""
    x, w = (torch.from_numpy(a) for a in _arrays(7, (1, 1, 4, 260, 8), (1, 1, 2, 3, 3)))
    plan = fused3d.plan_fft_conv3d(w, signal_dhw=(4, 260, 8), device="cpu")
    spectra = fused3d.kernel_spectra_3d(w, 260)
    modes(mode)
    calls = (lambda: fused3d.fft_conv3d_fused(x, w), lambda: ft.fft_conv(x, w, impl="fused"),
             lambda: plan(x), lambda: fused3d._fused3d_forward_reference(x, w, mode=mode),
             lambda: fused3d._launch_fused3d(x, spectra, 1, (2, 3, 3), mode=mode),
             lambda: fused3d._launch_fused3d_tap(x, spectra, 1, (2, 3, 3), mode=mode))
    for call in calls:
        with pytest.raises(ValueError, match="H <= 256"):
            call()
    modes("highest")
    assert fused3d.fft_conv3d_fused(x, w).shape == (1, 1, 3, 258, 6)


def test_switches_are_independent(modes):
    """Under "bf16" for 3D the 1D and 2D fused calls give what they give
    under "highest"; under "bf16" for 1D and 2D the 3D call does, and each
    switch leaves the others' state alone."""
    x1, w1, x2, w2, x3, w3 = (torch.from_numpy(a) for a in _arrays(
        5, (1, 2, 3000), (2, 2, 100), (1, 2, 60, 50), (2, 2, 5, 5), (1, 2, 10, 12, 14),
        (2, 2, 3, 3, 3)))
    one_two = (lambda: fused1d.fft_conv1d_fused(x1, w1),
               lambda: fused2d.fft_conv2d_fused(x2, w2))
    before = [fn() for fn in one_two]
    y3 = fused3d.fft_conv3d_fused(x3, w3)
    modes("bf16")
    assert fused1d._PRECISION_MODE == "highest" and fused2d._PRECISION_2D == "highest"
    for fn, y in zip(one_two, before):
        assert torch.equal(fn(), y)
    modes("highest")
    set_fused_precision("bf16")
    set_fused2d_precision("bf16")
    assert fused3d._PRECISION_3D == "highest"
    assert torch.equal(fused3d.fft_conv3d_fused(x3, w3), y3)


def test_every_3d_route_follows_the_switch(modes):
    """Under "bf16" the 3D plan, the fused transposed route, ``FFTConv3d``,
    ``FFTConvTranspose3d``, the "pk" route and the inline route equal the
    fused function's plain version of that mode on the same padded signal,
    and differ from their results under "highest"."""
    x, w, bias = (torch.from_numpy(a) for a in _arrays(9, (1, 2, 12, 14, 12), (2, 2, 3, 3, 3),
                                                       (2,)))
    layer = ft.FFTConv3d(2, 2, 3, padding=1, impl="fused", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    tlayer = ft.FFTConvTranspose3d(2, 2, 3, impl="fused", device="cpu",
                                   generator=torch.Generator().manual_seed(1))
    plan = fused3d.plan_fft_conv3d(w, bias, padding=1, signal_dhw=(12, 14, 12), device="cpu")
    wt = F._transpose_kernel_layout(tlayer.weight, 1, (1, 1, 1))

    def routes():
        with torch.no_grad():
            out = [plan(x), layer(x), tlayer(x)]
        for switch in (lambda: set_fused3d_xpack("pk"), lambda: set_fused3d_inline(True)):
            switch()
            out.append(fused3d.fft_conv3d_fused(x, w, bias, padding=1))
            set_fused3d_xpack("h2")
            set_fused3d_inline(False)
        return out

    def plain(mode):
        xp = F._pad_signal(x, (1, 1, 1), "constant")
        stuffed = F._stuff_full(x, wt.shape[2:], (1, 1, 1), (0, 0, 0))
        ref, b5 = fused3d._fused3d_forward_reference, (1, -1, 1, 1, 1)
        y = ref(xp, w, mode=mode) + bias.reshape(b5)
        inline = fused3d._spectra_v4_reference(w, xp.shape[3])  # B7's FP32 spectra
        with torch.no_grad():
            return [y, ref(xp, layer.weight, mode=mode) + layer.bias.reshape(b5),
                    ref(stuffed, wt, mode=mode) + tlayer.bias.reshape(b5), y,
                    ref(xp, w, spectra=inline, mode=mode) + bias.reshape(b5)]

    highest = routes()
    modes("bf16")
    for i, (y, y_plain, y_highest) in enumerate(zip(routes(), plain("bf16"), highest)):
        assert torch.equal(y, y_plain), i
        assert not torch.equal(y, y_highest), i


def test_bf16_gradients_equal_highest(modes):
    """The backward is the composed path in both packages, so the gradients
    under "bf16" are those under "highest"."""
    x, w, g = (torch.from_numpy(a) for a in _arrays(10, (1, 2, 11, 12, 10), (3, 2, 3, 3, 3),
                                                    (1, 3, 9, 10, 8)))

    def grads():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fused3d.fft_conv3d_fused(xx, ww) * g).sum().backward()
        return xx.grad, ww.grad

    highest = grads()
    modes("bf16")
    for a, b in zip(grads(), highest):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h", [1, 12, 13, 16, 48, 78, 82, 256])
def test_fragment_buffer_order(h):
    """``_tc_fragments_3d`` holds each step's matrix where csrc/fused3d.cu's
    ``tc_table`` looks for it: the HA-point DFT, the HB-point one when HB >
    1, the W 8-point and the D 16-point DFT, each zero-padded to its step
    size (8 up to 8 points, else 16), forward and then conjugated, each hi
    then lo (``fused1d._b_fragments``), ``table_words`` = 8 R² words a
    matrix."""
    split = fused3d._h_steps(h)
    words = fused3d._tc_fragments_3d(split, torch.device("cpu")).numpy().view(np.uint32)
    radices = [split[0]] + ([split[1]] if split[1] > 1 else []) + [8, 16]
    assert words.size == sum(8 * fused3d._tc_radix(r) ** 2 for r in radices)
    at = 0
    for r in radices:
        size = fused3d._tc_radix(r)
        f = np.zeros((size, size), complex)
        f[:r, :r] = fused1d.fft_factor_matrices(r, 1)[0]
        for m in (f, np.conj(f)):
            for half in fused1d._b_fragments(m):
                assert np.array_equal(words[at:at + 2 * size * size], half)
                at += 2 * size * size


@pytest.mark.parametrize("r", [3, 7, 13])
def test_padded_radix_follows_the_mma_layout(r):
    """An r-point DFT run as a step of size 8 or 16 with the r x r matrix in
    its corner: 16 vectors whose elements past r are zeros, through ``_mma``
    with each n-tile's hi fragments, give the r-point DFT (entries rounded
    to bf16) on the first r outputs and zeros past them."""
    size = fused3d._tc_radix(r)
    f = np.zeros((size, size), complex)
    f[:r, :r] = fused1d.fft_factor_matrices(r, 1)[0]
    hi, _ = fused1d._b_fragments(f)
    rng = np.random.default_rng(r)
    z = np.zeros((16, size, 2), np.float32)
    z[:, :r] = rng.standard_normal((16, r, 2))
    zb = torch.from_numpy(z).to(torch.bfloat16)
    words = zb.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 16
    fb = torch.complex(*(torch.from_numpy(p.astype(np.float32)).to(torch.bfloat16).double()
                         for p in (f.real, f.imag)))
    want = (torch.complex(zb[..., 0].double(), zb[..., 1].double()) @ fb.T).numpy()
    got = np.zeros((16, size), complex)
    frags = hi.reshape(size // 8, size // 4, 32, 2)
    for u in range(size // 4):
        acc = np.zeros((32, 4))
        for s in range(size // 8):
            a = np.array([[words[g, 8 * s + t], words[g + 8, 8 * s + t],
                           words[g, 8 * s + t + 4], words[g + 8, 8 * s + t + 4]]
                          for g, t in _lanes()], np.uint32)
            acc += _mma(a, frags[s, u])
        for lane, (g, t) in enumerate(_lanes()):
            got[g, 4 * u + t] = acc[lane, 0] + 1j * acc[lane, 1]
            got[g + 8, 4 * u + t] = acc[lane, 2] + 1j * acc[lane, 3]
    assert np.abs(got - want).max() < 1e-9
    assert np.abs(got[:, r:]).max() == 0


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kd", [3, 11])
def test_cost_analysis_records_the_mode(modes, mode, kd):
    """Under a bf16 mode a fused 3D call records "B3_<mode>" ('v4') or
    "B4_<mode>" ('tap') with the tensor-core count, three times the
    products under "bf16x3"; the bound weighs the products at the bf16
    rate."""
    shape = (1, 4, 4, 14, 20, 12)
    x, w = (torch.from_numpy(a) for a in _arrays(11, (1, 4, 14, 20, 12), (4, 4, kd, 3, 3)))
    k = (kd, 3, 3)
    work = costs.fused3d_tap_tc_work if kd > 9 else costs.fused3d_tc_work
    name = "B4" if kd > 9 else "B3"
    b, cin, cout, d, h, wd = shape
    nbytes, products, rest = work(b, cin, cout, d, h, wd, k, mode)
    modes(mode)
    out = cost_analysis(lambda s, kk: ft.fft_conv(s, kk, impl="fused"), x, w)
    assert out["kernels"] == {f"{name}_{mode}": {"calls": 1, "flops": products + rest,
                                                 "bytes": nbytes}}
    other = work(b, cin, cout, d, h, wd, k, "bf16" if mode == "bf16x3" else "bf16x3")
    assert products * (1 if mode == "bf16x3" else 3) == other[1] * (3 if mode == "bf16x3" else 1)
    fp32 = (costs.fused3d_tap_work if kd > 9 else costs.fused3d_work)(b, cin, cout, d, h, wd, k)
    assert nbytes == fp32[0] and rest == other[2] and products > 0 and rest > 0
    ms, _ = costs.bound(nbytes, rest, products)
    assert ms == max(nbytes / costs.HBM_BYTES_PER_S,
                     rest / costs.FP32_FLOPS_PER_S + products / costs.BF16_FLOPS_PER_S) * 1e3


def test_tc_counts_at_the_benchmark_row():
    """B3's tensor-core count at the 64^3 K=8 row (Hw 64 = 8 x 8, every step
    8 points: 8·8² per vector and step) by hand: per item and channel the
    32 pairs' two H steps on 8·64 vectors each and the 64 slabs' two W steps
    on 33·8 vectors each; the inverse's at OD = 57; the DFT-16 of each
    (channel, block of 4 output channels) and the inverse onto 8 d per
    output channel, at 33·64 bins and 8 D blocks."""
    _, products, _ = costs.fused3d_tc_work(2, 8, 8, 64, 64, 64, 8, "bf16")
    step = 8 * 8 ** 2
    h_pair, w_slab = 2 * 8 * 64 * step, 2 * 33 * 8 * step
    fwd = 32 * h_pair + 64 * w_slab
    inv = 29 * h_pair + 57 * w_slab
    d_stage = 33 * 64 * 8 * ((8 // 4) * 8 * 8 * 256 + 8 * 8 * 16 * 8)
    assert products == 2 * (8 * fwd + 8 * inv + d_stage)


# (B, Cin, Cout, D, H, W, K): the 3D rows of the card's smoke run (64^3 and
# 48^3 at K = 8 ('v4') and K = 10 ('tap')), the stuffed 78^3 and 82^3 of its
# transposed rows, a dense H (12) and an H that pads (37 -> 40)
BOUND_ROWS_3D = [
    (2, 8, 8, 64, 64, 64, 8), (2, 8, 8, 48, 48, 48, 8), (2, 8, 8, 64, 64, 64, 10),
    (2, 8, 8, 48, 48, 48, 10), (2, 8, 8, 78, 78, 78, 8), (2, 8, 8, 82, 82, 82, 10),
    (2, 4, 4, 14, 12, 20, 3), (1, 2, 3, 11, 37, 45, (3, 5, 7)),
]


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("row", BOUND_ROWS_3D)
def test_bf16_bound_is_never_above_fp32(mode, row):
    """A bf16 mode's bound (``costs.mode_bound``) is the lesser of the FP32
    route's least work and the tensor-core route's (``least=True``), so
    never above the FP32 bound of the same call; the tensor-core route's
    least work takes no longer than what its kernels run."""
    tap = (row[-1] if isinstance(row[-1], int) else row[-1][0]) > 9
    fp32 = (costs.fused3d_tap_work if tap else costs.fused3d_work)(*row)
    tc = costs.fused3d_tap_tc_work if tap else costs.fused3d_tc_work
    least, ran = tc(*row, mode, least=True), tc(*row, mode)
    ms, by, work = costs.mode_bound(fp32, least)
    routes = [costs.bound(*fp32), costs.bound(least[0], least[2], least[1])]
    assert (ms, by) == min(routes) and ms <= routes[0][0]
    assert costs.bound(work[0], work[1], work[2]) == (ms, by)
    assert least[0] == ran[0] == fp32[0]
    assert routes[1][0] <= costs.bound(ran[0], ran[2], ran[1])[0]


def test_bf16_bound_at_the_tap_row():
    """B4 at 64^3 K=10 (H = 64, every step 8 points): the tensor-core
    route's least FP32 work is the tap MAC onto the 55 valid d
    (``fused3d_tap_mac_work``, not the kernel's 56) and the twiddles, its
    products those of the FP32 count's short DFTs; under "bf16" that route
    sets the bound, below the FP32 one, and under "bf16x3" (three passes)
    the FP32 route does."""
    row = (2, 8, 8, 64, 64, 64, 10)
    fp32 = costs.fused3d_tap_work(*row)
    _, products, rest = costs.fused3d_tap_tc_work(*row, "bf16", least=True)
    mac = costs.fused3d_tap_mac_work(*row)[1]
    assert mac == 2 * 8 * 33 * 64 * 55 * 8 * 8 * 10
    hw_tc = costs._hw_stage_flops(8, 8, 64, 64, 64, 10, 10, 10, 1, False, tc=True)
    assert rest == mac + 2 * hw_tc[1] and products == 2 * hw_tc[0]
    # the 64-point DFT of a complex row as 8 x 8: 16 dense 8-point steps
    # (8·8² each), 49 twiddles past m1 = 0 and j2 = 0, one of them free
    # (m1 = j2 = 4, the root -i)
    assert costs._four_step_flops(64, 64, 64, tc=True) == (16 * 8 * 64, 6 * (49 - 1))
    x3 = costs.fused3d_tap_tc_work(*row, "bf16x3", least=True)
    assert x3[1] == 3 * products and x3[2] == rest
    ms, by, work = costs.mode_bound(fp32, (fp32[0], products, rest))
    assert ms < costs.bound(*fp32)[0] and work == (fp32[0], rest, products)
    assert costs.mode_bound(fp32, x3)[:2] == costs.bound(*fp32)
