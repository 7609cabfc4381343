"""Dense DFT matrices, the port's own numpy copy of the matrix functions in
``fft_conv_tpu/ops/spectral.py``.

The fused 2D kernel B5 (``kernels/fused2d.py``, the "v3" schedule) runs
its transforms as dense matrix products over tile axes of 128 to 384
samples, so it needs the one-sided real DFT, its Hermitian inverse and the
square complex DFT as split re/im matrices; the 2D kernel spectra are
computed with them, and B2's factored transforms are tested against them. They are float32 by default, as in the JAX package;
``dtype=np.float64`` gives the same matrices in float64 for an oracle.

The DFT-matmul convolution path of that module, and the overlap-save
tiling of ``fft_conv_tpu/ops/tiled.py``, are not ported yet.
"""

from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def _rfft_mats(n: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(Fr, Fi) with shape (n, n//2+1): X[k] = sum_t x[t] e^{-2pi i tk/n}."""
    t = np.arange(n)[:, None]
    k = np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * t * k / n
    return (
        np.ascontiguousarray(np.cos(ang), dtype),
        np.ascontiguousarray(np.sin(ang), dtype),
    )


@lru_cache(maxsize=None)
def _irfft_mats(n: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(Cr, Ci) with shape (n//2+1, n): y = Xr @ Cr + Xi @ Ci.

    Hermitian expansion of the one-sided spectrum: interior bins weighted 2,
    DC and (even-n) Nyquist weighted 1; imaginary parts of DC/Nyquist are
    ignored (rows zeroed), matching irfft semantics.
    """
    nb = n // 2 + 1
    k = np.arange(nb)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    w = np.full((nb, 1), 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cr = w * np.cos(ang) / n
    ci = -w * np.sin(ang) / n
    ci[0] = 0.0
    if n % 2 == 0:
        ci[-1] = 0.0
    return (
        np.ascontiguousarray(cr, dtype),
        np.ascontiguousarray(ci, dtype),
    )


@lru_cache(maxsize=None)
def _dft_mats(n: int, inverse: bool, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Square complex DFT matrix (split), inverse includes the 1/n."""
    j = np.arange(n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(j, j) / n
    scale = (1.0 / n) if inverse else 1.0
    return (
        np.ascontiguousarray(np.cos(ang) * scale, dtype),
        np.ascontiguousarray(np.sin(ang) * scale, dtype),
    )
