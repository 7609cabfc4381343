"""The port's fused 1D path against the JAX package's.

On the CPU the port's wrapper runs the kernel's plain version
(``_fused_forward_reference``), and the JAX wrapper runs its Pallas kernel in
interpret mode with the bf16x3-exact split. Both are held with
``helpers._assert_close_scaled``, the error model of that precision. The
CUDA kernel itself is tested on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_conv_tpu.kernels import fused1d as jax_fused1d
from fft_conv_tpu_torch import fft_conv
from fft_conv_tpu_torch.kernels import fused1d

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Cin, Cout, L, K, groups, stride, dilation, padding, padding_mode); every
# case has several overlap-save blocks and a remainder block. FFT sizes
# (choose_fft_size): 4096, 4096, 2048, 2048, then 2048, 4096 and 8192 with
# groups, and 8192 at V1 = 1 (K = N - 127)
PARITY = [
    (2, 4, 4, 5000, 300, 1, 1, 1, 0, "constant"),
    (2, 4, 6, 5000, 300, 2, 2, 1, 3, "reflect"),
    (1, 3, 3, 3000, 100, 3, 1, 2, 5, "circular"),
    (2, 2, 4, 4100, 256, 1, 3, 1, 7, "replicate"),
    (2, 4, 6, 6000, 150, 2, 1, 1, 0, "constant"),
    (2, 4, 4, 9000, 1000, 2, 1, 1, 0, "constant"),
    (1, 4, 2, 12000, 3000, 2, 1, 1, 0, "constant"),
    (1, 2, 2, 9000, 8192 - 127, 1, 1, 1, 0, "constant"),
]


@pytest.mark.parametrize("b,cin,cout,l,k,groups,stride,dilation,padding,mode", PARITY)
def test_plain_version_matches_jax_fused(b, cin, cout, l, k, groups, stride, dilation,
                                         padding, mode):
    x, w, bias = _arrays(l + k, (b, cin, l), (cout, cin // groups, k), (cout,))
    kw = dict(padding=padding, padding_mode=mode, stride=stride, dilation=dilation,
              groups=groups)
    y_jax = jax_fused1d.fft_conv1d_fused(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(bias), **kw)
    before = fused1d.launches
    y = fused1d.fft_conv1d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), **kw)
    assert fused1d.launches == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_factored_stages_equal_the_dense_factors_in_float64(n):
    """Each half of the factored pipeline against the dense one-sided
    factors of ``_factor_consts`` in float64: the forward (column pairs,
    their split into one-sided spectra, twiddle, row DFT) on real windows,
    and the inverse (row DFT, conjugate twiddle, the c2r of column pairs)
    on arbitrary complex spectra, for several V1."""
    n1 = n // 128
    h = n1 // 2 + 1
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((3, n1, 128)))
    f1r, f1i, f2r, f2i, twr, twi, *_ = (
        torch.from_numpy(m) for m in fused1d._factor_consts(n1, 128, 1, np.float64))
    br, bi = f1r @ a, f1i @ a
    cr, ci = br * twr - bi * twi, br * twi + bi * twr
    dr, di = fused1d._forward_spectrum(a)
    assert dr.dtype == torch.float64 and dr.shape == (3, h, 128)
    assert (dr - (cr @ f2r - ci @ f2i)).abs().max() < 1e-10
    assert (di - (cr @ f2i + ci @ f2r)).abs().max() < 1e-10

    yr, yi = (torch.from_numpy(rng.standard_normal((3, h, 128))) for _ in range(2))
    for v1 in (1, n1 // 2, n1 - 1, n1):
        *_, twr, twi, if1r, if1i, if2r, if2i = (
            torch.from_numpy(m) for m in fused1d._factor_consts(n1, 128, v1, np.float64))
        er, ei = yr @ if2r - yi @ if2i, yr @ if2i + yi @ if2r
        gr, gi = er * twr + ei * twi, ei * twr - er * twi
        out = fused1d._inverse_valid(yr, yi, v1)
        assert out.shape == (3, v1, 128)
        assert (out - (if1r @ gr - if1i @ gi)).abs().max() < 1e-12


@pytest.mark.parametrize(
    "k,l,cin,cout,batch",
    [(256, 32768, 8, 8, 2), (1024, 32768, 8, 8, 2), (3840, 32768, 8, 8, 2),
     (300, 5000, 4, 4, 2), (1, 1000, 3, 5, 1), (8000, 9000, 2, 2, 1),
     (8100, 9000, 2, 2, 1), (128, 2**20, 128, 128, 1)],
)
def test_choose_fft_size_matches_jax(k, l, cin, cout, batch):
    assert fused1d.choose_fft_size(k, l, cin, cout, batch=batch) == \
        jax_fused1d.choose_fft_size(k, l, cin, cout, batch=batch)


def test_choose_fft_size_budgets():
    # the bench shapes pick what the cost model picks
    assert fused1d.choose_fft_size(256, 32768, 8, 8, batch=2) == 2048
    assert fused1d.choose_fft_size(1024, 32768, 8, 8, batch=2) == 4096
    assert fused1d.choose_fft_size(3840, 32768, 8, 8, batch=2) == 8192
    # one-sided spectra past the L2 budget: no fused configuration
    assert fused1d.choose_fft_size(128, 2**20, 128, 128) is None
    assert not fused1d.cell_fits(2048, 1, 128, 128)
    # one block of a huge batch past the scratch budget
    assert not fused1d.cell_fits(2048, 4096, 8, 8)
    assert fused1d.cell_fits(2048, 2, 8, 8)


@pytest.mark.parametrize("n", [2048, 4096, 8192])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_version_is_exact_in_float64(n, groups):
    """The blocked one-sided pipeline in float64 against the composed path:
    agreement to float64 rounding shows the blocking, the one-sided rows and
    the valid-row crop are exact, at each FFT size."""
    k = {2048: 200, 4096: 1000, 8192: 3000}[n]
    x, w = _arrays(n + groups, (2, 4, 3 * n), (2, 4 // groups, k))
    xt = torch.from_numpy(x).double()
    wt = torch.from_numpy(w).double()
    y = fused1d._fused_forward_reference(xt, wt, n, groups)
    y_ref = fft_conv(xt, wt, groups=groups, impl="xla")
    assert y.dtype == torch.float64 and y.shape == y_ref.shape
    assert (y - y_ref).abs().max() < 1e-9


def test_fused_gradients_match_composed():
    x, w = _arrays(3, (2, 4, 4000), (4, 2, 150))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (fused1d.fft_conv1d_fused(xt, wt, padding=8, groups=2) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (fft_conv(xt, wt, padding=8, groups=2, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_fused_validation():
    x = torch.zeros(1, 4, 500)
    with pytest.raises(ValueError, match="expects"):
        fused1d.fft_conv1d_fused(x[0], torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match="groups"):
        fused1d.fft_conv1d_fused(x, torch.zeros(2, 3, 3), groups=2)
    with pytest.raises(ValueError, match="divisible"):
        fused1d.fft_conv1d_fused(x, torch.zeros(3, 2, 3), groups=2)
    with pytest.raises(ValueError, match="greater than"):
        fused1d.fft_conv1d_fused(x, torch.zeros(2, 4, 501))
    with pytest.raises(ValueError, match="no fused FFT configuration"):
        fused1d.fft_conv1d_fused(torch.zeros(1, 1, 9000), torch.zeros(1, 1, 8100))


def test_kernel_wrapper_takes_only_cuda_tensors():
    x = torch.zeros(1, 2, 4096)
    spectra = fused1d.kernel_spectra_one_sided(torch.zeros(2, 2, 100), 2048)
    with pytest.raises(ValueError, match="CUDA"):
        fused1d._launch_fused1d(x, spectra, 2048, 1, 100)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused1d._fused_forward(torch.zeros(1, 2, 4096, device="meta"),
                               torch.zeros(2, 2, 100, device="meta"), 2048)

