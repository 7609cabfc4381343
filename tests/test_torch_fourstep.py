"""The port's four-step factorization and the fused kernel's host-side
constants against the JAX package's, at the three fused FFT sizes.

Off-by-one mistakes in the one-sided rows, the pair-doubling weights or the
valid rows of the inverse stage do not show at every N, so every size runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_conv_tpu.kernels import fourstep as jax_fourstep
from fft_conv_tpu.kernels import fused1d as jax_fused1d
from fft_conv_tpu_torch.kernels import fourstep, fused1d

SIZES = [2048, 4096, 8192]


def _rel_err(a, b):
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("n", SIZES)
def test_kernel_spectrum_matches_jax(n):
    n1, n2 = fused1d.fused_split(n)
    rng = np.random.default_rng(n)
    k = {2048: 256, 4096: 1024, 8192: 3840}[n]
    w = rng.standard_normal((3, 2, k)).astype(np.float32)
    kr_j, ki_j = jax_fourstep.kernel_spectrum(jnp.asarray(w), n, n1, n2)
    kr_t, ki_t = fourstep.kernel_spectrum(torch.from_numpy(w), n, n1, n2)
    assert kr_t.shape == kr_j.shape == (3, n1, 2, n2)
    assert _rel_err(kr_t.numpy(), kr_j) < 1e-5
    assert _rel_err(ki_t.numpy(), ki_j) < 1e-5
    # the one-sided rows the kernel reads are the leading rows of the layout
    h = n1 // 2 + 1
    kr_h, ki_h = fourstep.kernel_spectrum(torch.from_numpy(w), n, n1, n2, rows=h)
    assert torch.equal(kr_h, kr_t[:, :h]) and torch.equal(ki_h, ki_t[:, :h])
    ks = fused1d.kernel_spectra_one_sided(torch.from_numpy(w), n)
    assert ks.dtype == torch.complex64 and ks.shape == (3, h, 2, n2)
    assert torch.equal(ks.real, kr_h) and torch.equal(ks.imag, ki_h)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [1, 129, 1000])
def test_factor_consts_match_jax(n, k):
    n1, n2 = fused1d.fused_split(n)
    v1 = (n - k + 1) // n2
    ours = fused1d._factor_consts(n1, n2, v1)
    theirs = jax_fused1d._factor_consts(n1, n2, v1)
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == np.float32
        assert _rel_err(a, b) < 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_one_sided_pipeline_is_exact(n):
    """Forward one-sided four-step, inverse with the pair-doubled weights:
    a real block round-trips on its first V1 rows (float64 constants)."""
    n1, n2 = fused1d.fused_split(n)
    h = n1 // 2 + 1
    v1 = n1 - 1
    f1r, f1i, f2r, f2i, twr, twi, if1r, if1i, if2r, if2i = (
        torch.from_numpy(m) for m in fused1d._factor_consts(n1, n2, v1, np.float64)
    )
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n1, n2)))
    br, bi = f1r @ x, f1i @ x
    cr, ci = br * twr - bi * twi, br * twi + bi * twr
    dr, di = cr @ f2r - ci @ f2i, cr @ f2i + ci @ f2r
    assert dr.shape == (h, n2)
    er, ei = dr @ if2r - di @ if2i, dr @ if2i + di @ if2r
    gr, gi = er * twr + ei * twi, ei * twr - er * twi
    back = if1r @ gr - if1i @ gi
    assert back.shape == (v1, n2)
    assert (back - x[:v1]).abs().max() < 1e-10


@pytest.mark.parametrize("n1,n2", [(16, 128), (64, 64), (128, 128)])
def test_four_step_fft_matches_numpy(n1, n2):
    n = n1 * n2
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    d = fourstep.four_step_fft(torch.from_numpy(x), n1, n2).numpy()
    x_ref = np.fft.fft(x)
    rec = np.empty(n, complex)
    k1g, k2g = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    rec[(k1g + n1 * k2g).ravel()] = d.ravel()  # X[k1 + n1*k2] = d[k1, k2]
    assert np.abs(rec - x_ref).max() / np.abs(x_ref).max() < 1e-5
    dr, di = fourstep.four_step_fft_real(torch.from_numpy(x), n1, n2)
    assert _rel_err(dr.numpy(), d.real) < 1e-5 and _rel_err(di.numpy(), d.imag) < 1e-5


def test_four_step_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    d = fourstep.four_step_fft(torch.from_numpy(x), 32, 128)
    d_jax = np.asarray(jax_fourstep.four_step_fft(jnp.asarray(x), 32, 128))
    assert _rel_err(d.numpy(), d_jax) < 1e-5
    back = fourstep.four_step_ifft(d, 32, 128).numpy()
    assert np.abs(back - x).max() < 1e-4


def test_split_factors_match_jax():
    for n in (1024, 2048, 8192, 16384):
        assert fourstep.split_factors(n) == jax_fourstep.split_factors(n)
    with pytest.raises(ValueError):
        fourstep.split_factors(1000)
