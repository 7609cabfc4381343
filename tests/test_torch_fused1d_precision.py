"""B1's precision modes, ``set_fused_precision``, against the JAX package's.

The JAX switch picks how the fused 1D kernel forms each DFT matrix product:
FP32 ("highest"), three bf16 products of hi/lo splits ("bf16x3") or one
("bf16"). The port's switch picks the kernels: the FP32 pair, or the
tensor-core route whose DFT steps are bf16 products. On the CPU the wrapper
runs their plain version, which rounds each product's operands where
the kernels do (its column DFTs dense at N1 = 16 and 32 and 8 · 8 at 64,
its row DFTs 16 · 8); JAX runs its Pallas kernel in interpret mode (its
"bf16x3" as the exact split ``bf16x3_exact``). Each test sets JAX's mode and
restores its default "bf16x3" afterwards, and restores the port's default
"highest". The tensor-core kernels themselves are tested on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused1d as jax_fused1d
from fft_conv_tpu_torch.bench.profiling import cost_analysis
from fft_conv_tpu_torch.kernels import costs, fused1d, fused2d, fused3d, set_fused_precision
from fft_conv_tpu_torch.ops import functional as F

from helpers import _assert_close_scaled
from test_torch_fused1d import PARITY


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def modes():
    """Sets both packages' modes: ``modes(port, jax)``; restores their
    defaults ("highest" here, "bf16x3" in JAX) afterwards."""
    def set_modes(port, jax=None):
        set_fused_precision(port)
        if jax is not None:
            jax_fused1d.set_fused_precision(jax)

    try:
        yield set_modes
    finally:
        set_fused_precision("highest")
        jax_fused1d.set_fused_precision("bf16x3")


@pytest.mark.parametrize("mode", ["highest", "bf16x3"])
@pytest.mark.parametrize("b,cin,cout,l,k,groups,stride,dilation,padding,pmode", PARITY)
def test_mode_matches_jax_fused(modes, mode, b, cin, cout, l, k, groups, stride, dilation,
                                padding, pmode):
    """"highest" and "bf16x3" against the JAX package in the same mode, under
    ``_assert_close_scaled``, at the parity cases of ``test_torch_fused1d``
    (every FFT size, groups, stride, dilation, padding modes, V1 = 1)."""
    x, w, bias = _arrays(l + k, (b, cin, l), (cout, cin // groups, k), (cout,))
    kw = dict(padding=padding, padding_mode=pmode, stride=stride, dilation=dilation,
              groups=groups)
    modes(mode, mode)
    y_jax = jax_fused1d.fft_conv1d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), **kw)
    y = fused1d.fft_conv1d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def _float64_conv(x, w, bias, padding):
    return TF.conv1d(torch.from_numpy(x).double(), torch.from_numpy(w).double(),
                     torch.from_numpy(bias).double(), padding=padding).numpy()


def _err(y, y_ref):
    """(err_mean, err_max) in units of sigma = max(1, std(ref))."""
    sigma = max(1.0, float(np.std(y_ref)))
    err = np.abs(np.asarray(y, np.float64) - y_ref)
    return err.mean() / sigma, err.max() / sigma


# (seed, B, Cin, Cout, L, K, padding): the JAX package's bf16 test
# (tests/test_pallas.py:test_fused_bf16_serving_mode, N = 2048), then one case
# at each FFT size: 2048, 4096, 8192
BF16_CASES = [
    (37, 2, 3, 4, 4000, 160, 8),
    (1, 2, 2, 4, 4100, 256, 7),
    (2, 2, 4, 4, 5000, 300, 0),
    (3, 1, 4, 2, 12000, 3000, 0),
]


@pytest.mark.parametrize("seed,b,cin,cout,l,k,padding", BF16_CASES)
def test_bf16_meets_the_serving_bar(modes, seed, b, cin, cout, l, k, padding):
    """"bf16", the port's and the JAX package's, each against torch's conv1d
    in float64 under JAX's serving bar (err_mean < 5e-3·σ, err_max <
    5e-2·σ, σ = max(1, std(ref)); ``tests/test_pallas.py:453-478``)."""
    if seed == 37:
        rng = np.random.default_rng(37)
        x, w, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((b, cin, l), (cout, cin, k), (cout,)))
    else:
        x, w, bias = _arrays(seed, (b, cin, l), (cout, cin, k), (cout,))
    y_ref = _float64_conv(x, w, bias, padding)
    modes("bf16", "bf16")
    y = fused1d.fft_conv1d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), padding=padding)
    y_jax = jax_fused1d.fft_conv1d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                                         padding=padding)
    for out in (y.numpy(), np.asarray(y_jax)):
        mean, mx = _err(out, y_ref)
        assert mean < 5e-3 and mx < 5e-2, (mean, mx)


@pytest.mark.parametrize("seed,b,cin,cout,l,k,padding", BF16_CASES[1:])
def test_modes_are_told_apart(modes, seed, b, cin, cout, l, k, padding):
    """The three modes' errors against float64 are ordered, each err_mean at
    least 8x the one before ("highest" < "bf16x3" < "bf16"; measured on the
    CPU about 35x and 650x). A mode that runs another's arithmetic gives a
    ratio near 1 and fails."""
    x, w, bias = _arrays(seed, (b, cin, l), (cout, cin, k), (cout,))
    y_ref = _float64_conv(x, w, bias, padding)
    errs = []
    for mode in fused1d.PRECISION_MODES:
        modes(mode)
        errs.append(_err(fused1d.fft_conv1d_fused(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            padding=padding).numpy(), y_ref)[0])
    assert 8 * errs[0] < errs[1] and 100 * errs[1] < errs[2], errs


def test_unknown_mode_raises_and_default_is_highest(modes):
    assert fused1d._PRECISION_MODE == "highest"
    with pytest.raises(ValueError, match="fp8"):
        set_fused_precision("fp8")
    assert fused1d._PRECISION_MODE == "highest"
    modes("bf16")
    assert fused1d._PRECISION_MODE == "bf16"


def test_switch_leaves_2d_and_3d_alone(modes):
    """Under "bf16" the 2D and 3D fused calls (their plain versions here)
    give exactly what they give under "highest"."""
    x2, w2, x3, w3 = (torch.from_numpy(a) for a in _arrays(
        5, (1, 2, 40, 36), (2, 2, 5, 3), (1, 2, 10, 12, 14), (2, 2, 3, 3, 3)))
    calls = (lambda: fused2d.fft_conv2d_fused(x2, w2), lambda: fused3d.fft_conv3d_fused(x3, w3))
    before = [fn() for fn in calls]
    modes("bf16")
    for fn, y in zip(calls, before):
        assert torch.equal(fn(), y)


def test_every_1d_route_follows_the_switch(modes):
    """Under "bf16" the 1D plan, the fused transposed route and ``FFTConv1d``
    equal ``fft_conv1d_fused`` under "bf16" (on the CPU each runs B1's plain
    version of that mode), and differ from their results under "highest"."""
    x, w, bias = (torch.from_numpy(a) for a in _arrays(9, (2, 4, 6000), (4, 4, 300), (4,)))
    layer = ft.FFTConv1d(4, 4, 300, padding=5, impl="fused", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    plan = fused1d.plan_fft_conv1d(w, bias, padding=5, signal_length=6000, device="cpu")
    wt = F._transpose_kernel_layout(w, 1, (1,))

    def routes():
        transposed = ft.fft_conv_transpose(x, w, bias, padding=4, impl="fused")
        with torch.no_grad():
            return plan(x), transposed, layer(x)

    def fused_calls():
        stuffed = F._stuff_full(x, wt.shape[2:], (1,), (0,))
        transposed = fused1d.fft_conv1d_fused(stuffed, wt)[..., 4:-4] + bias.reshape(1, -1, 1)
        with torch.no_grad():
            return (fused1d.fft_conv1d_fused(x, w, bias, padding=5), transposed,
                    fused1d.fft_conv1d_fused(x, layer.weight, layer.bias, padding=5))

    highest = routes()
    modes("bf16")
    for y, y_fused, y_highest in zip(routes(), fused_calls(), highest):
        assert torch.equal(y, y_fused)
        assert not torch.equal(y, y_highest)


def test_bf16_gradients_equal_highest(modes):
    """The backward is the composed path in both packages
    (``fft_conv_tpu/kernels/fused1d.py:522``), so the gradients under "bf16"
    are those under "highest"."""
    x, w, g = (torch.from_numpy(a) for a in _arrays(10, (2, 3, 3000), (4, 3, 200), (2, 4, 2801)))

    def grads():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fused1d.fft_conv1d_fused(xx, ww) * g).sum().backward()
        return xx.grad, ww.grad

    highest = grads()
    modes("bf16")
    for a, b in zip(grads(), highest):
        assert torch.equal(a, b)


def _halves(words):
    """The two bf16 values of each 32-bit word, as float64 (..., 2), the
    low 16 bits first."""
    bits = np.stack([words & 0xFFFF, words >> 16], -1).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _lanes():
    return [divmod(lane, 4) for lane in range(32)]  # (g, t) of each lane


def _mma(a_words, b_words):
    """One warp's ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``
    from its lanes' registers, by the PTX ISA's fragment layout (lane l, g =
    l // 4, t = l % 4): A[g, 2t..2t+1] in a0, A[g + 8, ..] in a1, A[g, 2t +
    8..] in a2, A[g + 8, 2t + 8..] in a3; B[2t..2t+1, g] in b0, B[2t + 8..,
    g] in b1; C[g, 2t..2t+1] and C[g + 8, 2t..2t+1] back. The lower index of
    a pair is the low 16 bits. ``a_words`` (32, 4), ``b_words`` (32, 2)
    uint32; returns the (32, 4) accumulators."""
    a, b = _halves(a_words), _halves(b_words)  # (32, 4, 2), (32, 2, 2)
    am, bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane, (g, t) in enumerate(_lanes()):
        for reg, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                      (g + 8, 2 * t + 8))):
            am[r, c:c + 2] = a[lane, reg]
        for reg, r in enumerate((2 * t, 2 * t + 8)):
            bm[r:r + 2, g] = b[lane, reg]
    cm = am @ bm
    return np.array([[cm[g, 2 * t], cm[g, 2 * t + 1], cm[g + 8, 2 * t], cm[g + 8, 2 * t + 1]]
                     for g, t in _lanes()])


def _b_matrix(words, r):
    """The real (2r, 2r) matrix that fragment words (k-step, n-tile, lane, 2)
    hold, by ``_mma``'s B layout."""
    frags, m = words.reshape(r // 8, r // 4, 32, 2), np.zeros((2 * r, 2 * r))
    for s in range(r // 8):
        for u in range(r // 4):
            for lane, (g, t) in enumerate(_lanes()):
                for reg, row in enumerate((16 * s + 2 * t, 16 * s + 2 * t + 8)):
                    m[row:row + 2, 8 * u + g] = _halves(frags[s, u, lane, reg])
    return m


@pytest.mark.parametrize("r", [8, 16, 32, 64])
@pytest.mark.parametrize("inverse", [False, True])
def test_fragments_follow_the_mma_layout(r, inverse):
    """``_b_fragments`` against the PTX fragment layout. 16 complex vectors,
    their (re, im) pairs in A registers as ``bf16_mma.cuh:dft_tile`` loads
    them (elements j = 8 s + t and j + 4 at k-step s), each n-tile's hi
    fragments through ``_mma``: each lane's accumulators are the complex
    outputs k = 4 u + t of vectors g and g + 8, equal to the complex DFT with
    its entries rounded to bf16. And hi + lo holds the float32 matrix to
    within 2^-17."""
    f = fused1d.fft_factor_matrices(r, 1)[0]
    f = np.conj(f) if inverse else f
    hi, lo = fused1d._b_fragments(f)
    assert hi.shape == lo.shape == (2 * r * r,)
    rng = np.random.default_rng(r)
    zb = torch.from_numpy(rng.standard_normal((16, r, 2)).astype(np.float32)).to(torch.bfloat16)
    words = zb.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 16  # (16, r): element (re, im) as one word
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
    full = np.zeros((2 * r, 2 * r))  # B[2j + p, 2k + q] of the float32 entries
    fr, fi = f.real.astype(np.float32).T, f.imag.astype(np.float32).T
    full[0::2, 0::2], full[1::2, 0::2], full[0::2, 1::2], full[1::2, 1::2] = fr, -fi, fi, fr
    assert np.abs(_b_matrix(hi, r) + _b_matrix(lo, r) - full).max() <= 2 ** -17


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_cost_analysis_records_the_mode(modes, mode):
    """Under a bf16 mode a fused call records "B1_<mode>" with the
    tensor-core count, three times the products under "bf16x3"; the bound
    weighs the products at the bf16 rate."""
    x, w = (torch.from_numpy(a) for a in _arrays(11, (2, 4, 3000), (6, 4, 200)))
    n = fused1d.choose_fft_size(200, 3000, 4, 6, batch=2)
    nbytes, products, rest = costs.fused1d_tc_work(2, 4, 6, 3000, 200, n, mode)
    modes(mode)
    out = cost_analysis(lambda s, kk: ft.fft_conv(s, kk, impl="fused"), x, w)
    assert out["kernels"] == {f"B1_{mode}": {"calls": 1, "flops": products + rest,
                                             "bytes": nbytes}}
    other = costs.fused1d_tc_work(2, 4, 6, 3000, 200, n, "bf16" if mode == "bf16x3" else "bf16x3")
    assert products * (1 if mode == "bf16x3" else 3) == other[1] * (3 if mode == "bf16x3" else 1)
    nblk = fused1d._blocking(n, 200, 3000)[2]
    planes = 2 * nblk * (n // 256 + 1) * 128 * 8  # bytes of one channel's D or Y planes
    # D written once and read once (one output-channel block), Y written and read
    assert nbytes == costs.fused1d_work(2, 4, 6, 3000, 200, n)[0] + planes * (2 * 4 + 2 * 6)
    assert rest == other[2]
    ms, by = costs.bound(nbytes, rest, products)
    assert ms == max(nbytes / costs.HBM_BYTES_PER_S,
                     rest / costs.FP32_FLOPS_PER_S + products / costs.BF16_FLOPS_PER_S) * 1e3


# (B, Cin, Cout, L, K): the 1D benchmark rows
BENCH_ROWS = [(2, 8, 8, 32768, 256), (2, 8, 8, 32768, 1024), (2, 8, 8, 32768, 3840)]


@pytest.mark.parametrize("b,cin,cout,l,k", BENCH_ROWS)
def test_tc_geometry_at_the_rows(b, cin, cout, l, k):
    """At the 1D rows the tensor-core route runs every block in one launch
    and its MAC stage two units and 8 output channels a block: the fewest
    units whose grid (171 / 187 / 231 blocks) is one wave of two blocks on
    each of 132 SMs; one unit a block would take two."""
    n = fused1d.choose_fft_size(k, l, cin, cout, batch=b)
    nblk = fused1d._blocking(n, k, l)[2]
    chunk, upb, ocb = fused1d._tc_geometry(b, cin, cout, 1, n, nblk, 132)
    assert (chunk, upb, ocb) == (nblk, 2, 8)
    h = n // 256 + 1
    assert -(-nblk * b // upb) * h <= 2 * 132 < nblk * b * h
    assert -(-nblk * b // upb) * h == {256: 171, 1024: 187, 3840: 231}[k]


def test_tc_geometry_grouped_with_a_channel_remainder():
    """Cout/g = 12 is not a multiple of ocb = 8: two output-channel blocks a
    group (8 and 4), and the units a block rise until the grid is one wave,
    dealt evenly; Cout/g = 3 takes all three channels in one block."""
    nblk = fused1d._blocking(4096, 1000, 20000)[2]
    chunk, upb, ocb = fused1d._tc_geometry(2, 8, 24, 2, 4096, nblk, 132)
    og, h, units = 12, 17, 2 * nblk
    assert ocb == 8 and chunk == nblk
    cells = h * 2 * -(-og // ocb)
    assert -(-units // upb) * cells <= 2 * 132 and upb * ocb <= fused1d._TC_PLANE_ROWS
    assert -(-units // (upb - 1)) * cells > 2 * 132
    chunk, upb, ocb = fused1d._tc_geometry(2, 3, 6, 2, 4096, nblk, 132)
    assert ocb == 3 and upb * ocb <= fused1d._TC_PLANE_ROWS


def test_tc_geometry_counts_d_and_y_under_the_budget(monkeypatch):
    """A launch takes as many blocks as the scratch budget holds of D (B, Cin
    planes) and Y (B, Cout planes) together, and at least one when a block of
    both busts it."""
    n, b, cin, cout = 2048, 2, 4, 6
    per = fused1d._scratch_bytes_per_block(n, b, cin + cout)
    assert per == fused1d._scratch_bytes_per_block(n, b, cin) * (cin + cout) // cin
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET", 3 * per + per // 2)
    assert fused1d._tc_geometry(b, cin, cout, 1, n, 40, 132)[0] == 3
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET", per - 1)
    assert fused1d._tc_geometry(b, cin, cout, 1, n, 40, 132)[0] == 1
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET", 10 ** 12)
    assert fused1d._tc_geometry(b, cin, cout, 1, n, 40, 132)[0] == 40


@pytest.mark.parametrize("b,cin,cout,l,k", BENCH_ROWS)
def test_tc_work_reads_d_once_per_output_channel_block(b, cin, cout, l, k):
    """``fused1d_tc_work``'s bytes: the function's least bytes, D written once
    and read once for each output-channel block of its group (one at 8
    output channels, two at 16: not once for each output channel), and Y
    written and read once. ``mode_bound`` still takes the FP32 route's
    least work at the rows."""
    n = fused1d.choose_fft_size(k, l, cin, cout, batch=b)
    nblk = fused1d._blocking(n, k, l)[2]
    plane = b * nblk * (n // 256 + 1) * 128 * 8
    for co, reads in ((cout, 1), (2 * cout, 2)):
        nbytes = costs.fused1d_tc_work(b, cin, co, l, k, n, "bf16x3")[0]
        assert nbytes == costs.fused1d_work(b, cin, co, l, k, n)[0] + plane * (
            cin * (1 + reads) + 2 * co)
    for mode in ("bf16x3", "bf16"):
        fp32 = costs.fused1d_work(b, cin, cout, l, k, n)
        ms, by, counts = costs.mode_bound(fp32, costs.fused1d_tc_work(b, cin, cout, l, k, n,
                                                                     mode))
        assert (ms, by) == costs.bound(*fp32) and counts == (*fp32, 0)
