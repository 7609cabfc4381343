"""DFT as matrix products: the port of ``fft_conv_tpu/ops/spectral.py``.

The one-sided real DFT, its Hermitian inverse and the square complex DFT
as split re/im numpy matrices: the fused 2D and 3D kernels' spectra are
computed with them, B3's and B4's dense H and D stages take theirs from
here, and the factored transforms of B2 and B5 are tested against them.
They are float32 by default, as in the JAX package; ``dtype=np.float64``
gives the same matrices in float64 for an oracle.

On them sit the split re/im float32 N-d transforms of the overlap-save
tiling (``ops/tiled.py``), with the JAX package's pipeline and bin order
(no complex dtypes):

    rfft on the first spatial axis (rectangular real -> half-spectrum
    products), a full complex DFT per remaining axis (square products),
    each contraction appending its bins last; the inverse DFTs, then the
    inverse rfft (Hermitian-weighted products)

The products are cuBLAS matrix products on the card, run in FP32 whatever
the global TF32 settings say (``_fp32_products``), forward and backward.
Each matrix is built once per device and kept there; a row slice (the
implicit zero padding of a short input) is a view.

Not carried from the JAX module: its whole-signal DFT-matmul convolution
(``freq_domain_conv_matmul``, the plans' tier 2) and the gate that picks
it (``use_matmul_dft``, true only on a TPU), the four-step axis branch
nothing there calls, and ``set_spectral_precision``, whose other mode is
the TPU's bf16x3 pass. ROADMAP.md (section C) gives the reasons.
"""

import contextlib
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

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


_BUILDERS = {"rfft": _rfft_mats, "irfft": _irfft_mats, "dft": _dft_mats}


@lru_cache(maxsize=None)
def _device_mats(kind: str, device: torch.device, *args) -> Tuple[torch.Tensor, ...]:
    """The float32 matrices of ``_BUILDERS[kind](*args)`` on ``device``, built
    and copied there once: a call then copies nothing from the host, so it
    can be captured in a CUDA graph once it has run eagerly."""
    return tuple(torch.from_numpy(m).to(device) for m in _BUILDERS[kind](*args))


@contextlib.contextmanager
def _fp32_products():
    """cuBLAS float32 products in full FP32 inside the block, whatever the
    global setting, and the caller's setting as it was after it: the JAX
    package's ``HIGHEST``.

    The setting is changed through the API the caller used, since torch
    raises where its legacy and newer flags disagree: the legacy precision
    string (``torch.get_float32_matmul_precision``: "highest", "high" or
    "medium") where it can be read, else the newer per-backend
    ``torch.backends.cuda.matmul.fp32_precision``, which is also saved and
    restored where torch has it (a value it inherits comes back set
    explicitly, to the same effect). The flags are process-wide: float32
    matmuls that another thread runs during the block run in FP32 too.
    """
    m = torch.backends.cuda.matmul
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set the newer flag
        legacy = None
    newer = m.fp32_precision if hasattr(m, "fp32_precision") else None
    if legacy is not None:
        torch.set_float32_matmul_precision("highest")
    else:
        m.fp32_precision = "ieee"
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if newer is not None:
            m.fp32_precision = newer


class _Contract(torch.autograd.Function):
    """Axis ``pos`` of x contracted with dim 0 of a constant matrix, the
    bins appended last. The forward runs inside its caller's
    ``_fp32_products`` (``rfftn_matmul``, ``irfftn_matmul``); the backward,
    which autograd runs later, enters its own."""

    @staticmethod
    def forward(ctx, x, mat, pos):
        ctx.save_for_backward(mat)
        ctx.pos = pos
        return torch.tensordot(x, mat, dims=([pos], [0]))

    @staticmethod
    def backward(ctx, g):
        (mat,) = ctx.saved_tensors
        with _fp32_products():
            gx = torch.tensordot(g, mat, dims=([g.ndim - 1], [1]))
        return gx.movedim(-1, ctx.pos), None, None


def _contract_append(x: torch.Tensor, mat: torch.Tensor, pos: int) -> torch.Tensor:
    """Contract position ``pos`` of x with dim 0 of mat; bins APPEND last.

    The rotation primitive of the pipeline: each step removes the axis it
    contracts and appends the result axis, so after n steps the bin axes
    sit in natural order with no explicit transpose.
    """
    return _Contract.apply(x, mat, pos)


def _cmul_contract_append(xr, xi, mr, mi, pos):
    yr = _contract_append(xr, mr, pos) - _contract_append(xi, mi, pos)
    yi = _contract_append(xr, mi, pos) + _contract_append(xi, mr, pos)
    return yr, yi


def rfftn_matmul(x: torch.Tensor, fft_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split re/im one-sided N-d DFT over the trailing len(fft_shape) axes.

    Rotation pipeline: every step contracts the CURRENT first spatial
    position and appends its bins last, so after n steps the bin axes sit
    in natural order. The one-sided (real) transform is the first step:
    it must act while the data is still real. The matrices are row-sliced
    to each axis's actual length (implicit zero padding), which cuts a
    small kernel's products by S/K per axis. Bin order and placement are
    internal: only this module needs to agree with itself.
    """
    n = len(fft_shape)
    x = x.float()
    first = x.ndim - n
    in_lens = [x.shape[first + i] for i in range(n)]
    fr, fi = (m[: in_lens[0]] for m in _device_mats("rfft", x.device, fft_shape[0]))
    with _fp32_products():
        xr = _contract_append(x, fr, first)
        xi = _contract_append(x, fi, first)
        for i in range(1, n):
            # the axis to transform has rotated to position ``first``
            mr, mi = _device_mats("dft", x.device, fft_shape[i], False)
            if in_lens[i] < fft_shape[i]:
                mr, mi = mr[: in_lens[i]], mi[: in_lens[i]]
            xr, xi = _cmul_contract_append(xr, xi, mr, mi, first)
    return xr, xi


def irfftn_matmul(xr: torch.Tensor, xi: torch.Tensor, fft_shape) -> torch.Tensor:
    """Inverse of rfftn_matmul: real output of shape (..., *fft_shape).

    Mirrors the rotation: full-DFT bins invert first (each sits at position
    first+1 when its turn comes), the one-sided axis inverts last, then one
    movedim restores the spatial order (none needed for 1D).
    """
    n = len(fft_shape)
    first = xr.ndim - n
    with _fp32_products():
        for i in range(1, n):
            mr, mi = _device_mats("dft", xr.device, fft_shape[i], True)
            xr, xi = _cmul_contract_append(xr, xi, mr, mi, first + 1)
        cr, ci = _device_mats("irfft", xr.device, fft_shape[0])
        out = _contract_append(xr, cr, first) + _contract_append(xi, ci, first)
    if n > 1:
        out = out.movedim(-1, first)
    return out
