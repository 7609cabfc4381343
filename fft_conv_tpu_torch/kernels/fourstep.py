"""Four-step (Bailey/Monarch) FFT factorization: FFT-as-matmuls.

A length-N = N1*N2 DFT factors into two dense products with an elementwise
twiddle between:

    row-major A[j1, j2] = x[j1*N2 + j2]
    B = F_N1 @ A                (contract j1 -> k1)
    C = B  * tw,  tw[k1, j2] = exp(-2*pi*i * k1*j2 / N)
    D = C @ F_N2                (contract j2 -> k2)
    X[k1 + N1*k2] = D[k1, k2]   (scrambled order)

Convolution never needs the natural order: multiply two identically
scrambled spectra bin-wise and run the inverse pipeline (conjugate matrices
and twiddle, 1/N1 and 1/N2 scaling). This module provides the matrices and a
torch implementation, used to precompute the kernel spectra of the fused 1D
kernel (``fused1d.py``) and as its test oracle. It is the port's copy of
``fft_conv_tpu/kernels/fourstep.py``.
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def fft_factor_matrices(n1: int, n2: int) -> Tuple[np.ndarray, ...]:
    """(f1, f2, tw) complex128 numpy DFT factors for N = n1*n2."""
    n = n1 * n2
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    f1 = np.exp(-2j * np.pi * np.outer(j1, j1) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(j2, j2) / n2)
    tw = np.exp(-2j * np.pi * np.outer(j1, j2) / n)
    return f1, f2, tw


def split_factors(n: int) -> Tuple[int, int]:
    """N -> (N1, N2), the most-square power-of-two split (N1 >= N2)."""
    if n & (n - 1):
        raise ValueError(f"four-step FFT size must be a power of two, got {n}")
    log = n.bit_length() - 1
    n1 = 1 << ((log + 1) // 2)
    return n1, n // n1


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype in (torch.float64, torch.complex128) else torch.complex64


def _as(m: np.ndarray, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(m).to(device=like.device, dtype=dtype)


@lru_cache(maxsize=None)
def _real_factors(n1: int, n2: int, rows: int, dtype: torch.dtype, device: torch.device):
    """(f1r, f1i, f2r, f2i, twr, twi) for ``four_step_fft_real``, made once
    per device so that repeated calls copy nothing from the host."""
    f1, f2, tw = fft_factor_matrices(n1, n2)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(m)).to(device=device, dtype=dtype)
        for m in (f1[:rows].real, f1[:rows].imag, f2.real, f2.imag,
                  tw[:rows].real, tw[:rows].imag)
    )


def four_step_fft(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Scrambled-order DFT of the last axis (length n1*n2), complex in/out.

    Returns shape (..., n1, n2) with X[k1 + n1*k2] = out[..., k1, k2].
    """
    cdt = _complex_dtype(x.dtype)
    f1, f2, tw = (_as(m, x, cdt) for m in fft_factor_matrices(n1, n2))
    a = x.to(cdt).reshape(*x.shape[:-1], n1, n2)
    return ((f1 @ a) * tw) @ f2


def four_step_ifft(d: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Inverse of four_step_fft: (..., n1, n2) scrambled -> (..., n1*n2)."""
    f1, f2, tw = fft_factor_matrices(n1, n2)
    cdt = _complex_dtype(d.dtype)
    f1c = _as(np.conj(f1) / n1, d, cdt)
    f2c = _as(np.conj(f2) / n2, d, cdt)
    twc = _as(np.conj(tw), d, cdt)
    a = f1c @ ((d.to(cdt) @ f2c) * twc)
    return a.reshape(*d.shape[:-2], n1 * n2)


def four_step_fft_real(
    x: torch.Tensor, n1: int, n2: int, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scrambled DFT of a REAL last axis in split re/im real arithmetic.

    Returns (re, im), each (..., rows, n2): the first ``rows`` k1 rows of
    the scrambled spectrum (all n1 by default; every k1 row depends only on
    its own row of F_N1). Computes in float64 for a float64 input and in
    float32 otherwise.
    """
    rows = n1 if rows is None else rows
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    f1r, f1i, f2r, f2i, twr, twi = _real_factors(n1, n2, rows, dt, x.device)

    a = x.to(dt).reshape(*x.shape[:-1], n1, n2)
    br = f1r @ a
    bi = f1i @ a
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    return cr @ f2r - ci @ f2i, cr @ f2i + ci @ f2r


def kernel_spectrum(
    kernel: torch.Tensor, n: int, n1: int, n2: int, rows: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conjugated scrambled spectrum of a conv kernel, laid out for the
    fused MAC.

    kernel: (Cout, Cin, K) real -> (kr, ki) each (Cout, rows, Cin, n2),
    ``rows`` defaulting to n1 (the JAX package's layout). Conjugation makes
    the bin-wise product a cross-correlation, matching torch's conv
    convention (reference functional.py:71 ``.conj()``).

    The transform runs in float64 (it is a small product over the weights
    only, and float64 keeps it exact to float32 rounding whatever TF32
    setting the caller chose); the result is float64 for a float64 kernel
    and float32 otherwise.
    """
    cout, cin, k = kernel.shape
    out_dtype = torch.float64 if kernel.dtype == torch.float64 else torch.float32
    padded = torch.nn.functional.pad(kernel.to(torch.float64), (0, n - k))
    dr, di = four_step_fft_real(padded, n1, n2, rows)  # (Co, Ci, rows, n2)
    dr = dr.permute(0, 2, 1, 3).to(out_dtype).contiguous()
    di = (-di).permute(0, 2, 1, 3).to(out_dtype).contiguous()
    return dr, di
