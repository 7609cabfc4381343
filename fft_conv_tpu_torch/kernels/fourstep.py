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


def mixed_split(n: int, most: int = 16) -> Optional[Tuple[int, int]]:
    """N -> (A, B), N = A·B with 2 <= A, B <= ``most`` and B even: the most
    square such split (A >= B on a tie), or None when N has none. For the
    powers of two 16 to 256 it is ``split_factors``'s."""
    best = None
    for b in range(2, most + 1, 2):
        a = n // b
        if a * b == n and 2 <= a <= most:
            key = (abs(a - b), -a)
            if best is None or key < best[0]:
                best = (key, (a, b))
    return None if best is None else best[1]


def padded_split(n: int, most: int = 16) -> Tuple[int, Tuple[int, int]]:
    """(M, (A, B)): the least even length M >= N that has a ``mixed_split``,
    and that split. A DFT of N samples zero-padded to M then runs as A- and
    B-point DFTs. Raises ValueError past ``most``², where none exists."""
    if n > most * most:
        raise ValueError(f"no split with factors <= {most} reaches length {n}")
    m = n + n % 2
    while mixed_split(m, most) is None:
        m += 2
    return m, mixed_split(m, most)


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


@lru_cache(maxsize=None)
def _factor_tensors(n1: int, n2: int, dtype: torch.dtype, device: torch.device):
    """(f1, f2, tw) of ``fft_factor_matrices(n1, n2)`` (built in float64)
    as (re, im) pairs of ``dtype`` tensors on ``device``: f1 (n1, n1), f2
    (n2, n2) and the twiddle (n1, n2), made once per device."""
    out = []
    for m in fft_factor_matrices(n1, n2):
        out += [torch.from_numpy(np.ascontiguousarray(part)).to(device, dtype)
                for part in (m.real, m.imag)]
    return tuple(out)


def dft_last(xr: torch.Tensor, xi: Optional[torch.Tensor], split: Tuple[int, int],
             inverse: bool, dot=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled DFT (inverse: conjugated) of the last axis, length T = A·B
    with ``split`` = (A, B), through the four-step factors: the A-point DFT
    f1 over j1 of x[j1 * B + j2], the twiddle, the B-point DFT f2 over j2,
    and the result read back in natural bin order (X[m1 + A * m2] =
    D[m1, m2]), as the fused kernels run it. ``xi`` None is a real input.
    ``dot(a, b)`` forms each real product of the two DFT steps (None: the
    plain ``a @ b``; the fused 1D kernel's bf16 modes pass their rounding
    products). Returns (re, im) in the dtype of ``xr``."""
    t = xr.shape[-1]
    a, b = split
    if a * b != t:
        raise ValueError(f"split {split} does not factor length {t}")
    f1r, f1i, f2r, f2i, twr, twi = _factor_tensors(a, b, xr.dtype, xr.device)
    if inverse:
        f1i, f2i, twi = -f1i, -f2i, -twi
    mm = torch.matmul if dot is None else dot
    lead = xr.shape[:-1]
    ar = xr.reshape(*lead, a, b)
    br, bi = mm(f1r, ar), mm(f1i, ar)
    if xi is not None:
        ai = xi.reshape(*lead, a, b)
        br, bi = br - mm(f1i, ai), bi + mm(f1r, ai)
    cr, ci = br * twr - bi * twi, br * twi + bi * twr
    dr, di = mm(cr, f2r) - mm(ci, f2i), mm(cr, f2i) + mm(ci, f2r)
    return (dr.transpose(-1, -2).reshape(*lead, t), di.transpose(-1, -2).reshape(*lead, t))


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
