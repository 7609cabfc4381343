"""Fused 2D FFT convolution: host side of the CUDA kernel ``csrc/fused2d.cu``.

The port's counterpart of ``fft_conv_tpu/kernels/fused2d.py``. The padded
image is cut into overlap-save tiles of T1 x T2 samples that overlap by K1-1
rows and K2-1 columns; each tile yields V1 x V2 valid outputs of the
cross-correlation. Per tile the kernel runs the one-sided H DFT (NB1 =
T1/2+1 rows), the full W DFT, a per-bin grouped complex MAC over the group's
input channels against the conjugated kernel spectra, the inverse W DFT and
the H irfft on the V1 valid rows.

Two schedules of that one function, chosen by ``set_fused2d_kernel`` (or
the ``FFTCONV_2D_KERNEL`` environment variable, read at import) as in the
JAX package: "v2" (the default) runs kernel B2, which computes every DFT
axis as a factored (four-step) transform T = A * B, short DFTs with a
twiddle between them, in natural bin order; "v3" runs kernel B5
(``csrc/fused2d.cu``, ``fused2d_v3_forward``), the same factored transforms
on the v3 schedule: H first in the forward (columns packed in pairs), and
an H-first inverse folded into one T1-point transform per W column pair
(``_v3_inverse``), then the W c2r on row pairs.

On a CUDA tensor ``_fused2d_forward`` launches the chosen kernel; on a CPU
tensor it runs its plain version (``_fused2d_forward_reference`` or
``_fused2d_forward_reference_v3``), the same tiled pipeline written with
torch ops (the counterpart of the JAX package's Pallas interpret mode).
There is no other route: a CUDA tensor launches the kernel or raises.

Gradients: ``_Fused2dCore`` is a ``torch.autograd.Function`` whose backward
is the composed path, shared with the 1D kernel (``fused1d._fused_bwd``).

``fft_conv_transpose2d_fused`` runs the forward on the zero-stuffed signal.
``plan_fft_conv2d`` bakes the kernel spectra once for serving; its calls
follow the schedule chosen at call time, as the JAX package's do.

Not ported from the JAX module: the TPU's precision, MAC-mode and prefetch
switches.
"""

import ctypes
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from . import costs
from ..ops import functional as F
from ..ops.spectral import _dft_mats, _irfft_mats, _rfft_mats
from ..utils.device import Device, check_planned_signal, resolve_device
from ..utils.shapes import to_ntuple
from . import _build
from .fourstep import dft_last, fft_factor_matrices
from .fused1d import _fused_bwd, _spectra_or

_T2_CANDIDATES = (128, 256)

# The JAX package bounds its TPU cell by two VMEM budgets (resident spectra
# of 8 MiB, and an x/out cell that grows with image width). This kernel
# holds neither: a block keeps one NB1 x T2 complex matrix and a staged panel
# in shared memory, a size fixed by the tile plan alone. Its own limits are:
#   * the one-sided kernel spectra (Cout, Cin/g, NB1, T2) complex, which
#     every (tile, batch) block of phase 2 re-reads: kept in a third of the
#     card's 50 MB L2, as for the 1D kernel;
_SPECTRA_BUDGET = 16 * 2**20
#   * the shared memory of one block (csrc/fused2d.cu: smem_bytes, which
#     holds the whole NB1 x T2 complex plane), at most what a Hopper block
#     can use. It rules out T2 = 256 with T1 > 128 and T1 > 384;
_SMEM_LIMIT = 232448
#   * the scratch D that phase 1 hands to phase 2, (tiles, B, Cin, NB1, T2)
#     complex. The wrapper runs the tiles in ranges that keep D under this
#     budget, so one tile of the whole batch must fit.
_SCRATCH_BUDGET = 256 * 2**20
# CUDA's limit on gridDim.y, which carries the tiles of one launch.
_MAX_TILES_PER_LAUNCH = 65535

# Launches of the CUDA kernel pairs (phase 1 + phase 2) since import or the
# last reset: ``launches`` counts B2, ``launches_v3`` counts B5. The plain
# versions on CPU tensors do not count.
launches = 0
launches_v3 = 0

# The tile-kernel schedule: "v2" (B2) or "v3" (B5). _fused2d_forward reads it
# at call time, as the JAX package's does.
_KERNEL2D_VERSION = os.environ.get("FFTCONV_2D_KERNEL", "v2")


def set_fused2d_kernel(version: str) -> None:
    """Selects the 2D tile-kernel schedule: "v2" (kernel B2) or "v3"
    (kernel B5). Both compute the same function under the same tile plan."""
    global _KERNEL2D_VERSION
    if version not in ("v2", "v3"):
        raise ValueError(f"unknown fused2d kernel version: {version!r}")
    _KERNEL2D_VERSION = version


# B2's four-step split T = A * B of each DFT length it takes (A-point DFTs
# first, then the twiddle, then B-point DFTs), as csrc/fused2d.cu's split_a
# and split_b.
_SPLITS = {128: (16, 8), 256: (16, 16), 384: (24, 16)}


def _smem_bytes(nb1: int, t2: int) -> int:
    """Shared memory of one block of either phase of B2, as csrc/fused2d.cu
    computes it (``smem_bytes``): the NB1 x T2 complex plane, the staging
    of G columns of the H transforms (G = 32, or 8 at T1 = 384), one T1
    column for the packed DC/Nyquist column, and the factors (the roots of
    both short DFTs and the twiddle of each axis), all complex64. Past
    T1 = 384 the plane alone, already more than a block holds. The
    library's ``fused2d_smem_bytes`` exports the kernel's own figure; a card
    test holds the two equal."""
    t1 = 2 * (nb1 - 1)
    if t1 > 384:
        return 8 * nb1 * t2
    g = 8 if t1 == 384 else 32
    fac = sum(_SPLITS[t1]) + t1 + sum(_SPLITS[t2]) + t2
    return 8 * (nb1 * t2 + g * t1 + t1 + fac)


def _smem_bytes_v3(nb1: int, t2: int) -> int:
    """Shared memory of one block of B5 (either phase), as csrc/fused2d.cu's
    ``smem_bytes(t1, t2, false)`` computes it: B2's (``_smem_bytes``)
    without the packed DC/Nyquist column, which B5 does not use. The
    library's ``fused2d_v3_smem_bytes`` exports the kernel's own figure; a
    card test holds the two equal."""
    t1 = 2 * (nb1 - 1)
    return _smem_bytes(nb1, t2) - (8 * t1 if t1 <= 384 else 0)


def tile_plan_2d(k1: int, k2: int, cin_g: int, cout: int):
    """(T1, V1, NB1, T2, V2) or None when no fused configuration fits.

    The JAX package's choice, kept so that the plain version can be held to
    its kernel tile for tile: T1 is the smallest multiple of 128 with
    T1 >= 128 + K1 - 1 (128 for K1 <= 65), V1 = T1-K1+1 rounded down to a
    multiple of 8, and T2 the first of {128, 256} leaving V2 = T2-K2+1 >= 32.
    The budgets are this kernel's (see ``_SPECTRA_BUDGET``, ``_SMEM_LIMIT``).
    B5's shared memory (``_smem_bytes_v3``) fits exactly where B2's does, so
    one plan serves both schedules and the switch never changes routing (a
    test holds the two gates equal).
    """
    t1 = 128 if k1 <= 65 else -(-(128 + k1 - 1) // 128) * 128
    if t1 < k1 + 8:
        return None
    v1 = (t1 - k1 + 1) // 8 * 8
    nb1 = t1 // 2 + 1
    for t2 in _T2_CANDIDATES:
        v2 = t2 - k2 + 1
        if v2 < 32:
            continue
        if cout * nb1 * cin_g * t2 * 8 > _SPECTRA_BUDGET:
            return None  # larger T2 only costs more
        if _smem_bytes(nb1, t2) > _SMEM_LIMIT:
            return None
        return t1, v1, nb1, t2, v2
    return None


def _scratch_bytes_per_tile(nb1: int, t2: int, batch: int, cin_total: int) -> int:
    return batch * cin_total * nb1 * t2 * 8


def fused2d_fits(
    k1: int, k2: int, cin_g: int, cout: int, padded_hw, cin_total=None, batch: int = 1
) -> bool:
    """True when the kernel has a tile plan for this shape and one tile of
    the whole batch fits ``_SCRATCH_BUDGET``. The routing gate for
    ``impl="auto"``: check it with the PADDED spatial shape and the dilated
    kernel. ``cin_total`` is the full channel count (defaults to ``cin_g``)."""
    plan = tile_plan_2d(k1, k2, cin_g, cout)
    if plan is None:
        return False
    _, _, nb1, t2, _ = plan
    hp, wp = padded_hw
    if k1 > hp or k2 > wp:
        return False
    cin = cin_total if cin_total is not None else cin_g
    return _scratch_bytes_per_tile(nb1, t2, batch, cin) <= _SCRATCH_BUDGET


@lru_cache(maxsize=None)
def _mats_2d(t1: int, nb1: int, t2: int, v1: int, dtype=np.float32):
    """Split factor matrices: H one-sided forward (NB1, T1), W full DFT
    (T2, T2) forward and inverse, H irfft valid rows (V1, NB1), as ``dtype``
    numpy arrays (float32 for the kernel, float64 for an oracle)."""
    fr, fi = _rfft_mats(t1, np.float64)            # (T1, NB1)
    wr, wi = _dft_mats(t2, False, np.float64)
    ur, ui = _dft_mats(t2, True, np.float64)
    cr, ci = _irfft_mats(t1, np.float64)           # (NB1, T1)
    out = (fr.T, fi.T, wr, wi, ur, ui, cr.T[:v1], ci.T[:v1])
    return tuple(np.ascontiguousarray(m, dtype) for m in out)


@lru_cache(maxsize=None)
def _torch_mats(t1: int, nb1: int, t2: int, v1: int, dtype: torch.dtype,
                device: torch.device):
    """``_mats_2d`` as torch tensors of ``dtype`` on ``device``, made once per
    device so that repeated calls copy nothing from the host."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return tuple(torch.from_numpy(m).to(device) for m in _mats_2d(t1, nb1, t2, v1, npdt))


@lru_cache(maxsize=None)
def _device_factors(t1: int, t2: int, device: torch.device) -> torch.Tensor:
    """B2's factors as one complex64 vector on ``device``, in the order
    csrc/fused2d.cu stages them: for H then W, the A roots of unity (row 1
    of f1), the B roots (row 1 of f2) and the (A, B) twiddle, row-major.
    The kernel reads f1[m, j] as root[(m * j) % A]."""
    parts = []
    for t in (t1, t2):
        f1, f2, tw = fft_factor_matrices(*_SPLITS[t])
        parts += [f1[1], f2[1], tw.reshape(-1)]
    return torch.from_numpy(np.concatenate(parts).astype(np.complex64)).to(device)


def _dft_last(xr: torch.Tensor, xi: Optional[torch.Tensor], inverse: bool):
    """Unscaled DFT (inverse: conjugated) of the last axis, length T, through
    the four-step factors of ``_SPLITS[T]`` (``fourstep.dft_last``): bins in
    natural order. ``xi`` None is a real input. Returns (re, im) in the
    dtype of ``xr``."""
    return dft_last(xr, xi, _SPLITS[xr.shape[-1]], inverse)


def _h_forward(a: torch.Tensor):
    """One-sided H DFT of real windows (..., T1, T2): (re, im) of the NB1 =
    T1/2+1 first bins, (..., NB1, T2)."""
    nb1 = a.shape[-2] // 2 + 1
    hr, hi = _dft_last(a.transpose(-1, -2), None, False)
    return hr[..., :nb1].transpose(-1, -2), hi[..., :nb1].transpose(-1, -2)


def _w_inverse(yr: torch.Tensor, yi: torch.Tensor):
    """Inverse W DFT of the rows (..., R, T2) complex, 1/T2 included."""
    t2 = yr.shape[-1]
    er, ei = _dft_last(yr, yi, True)
    return er / t2, ei / t2


def _h_irfft(er: torch.Tensor, ei: torch.Tensor, v1: int) -> torch.Tensor:
    """The H irfft of one-sided columns (..., NB1, T2) on the V1 first rows:
    bins weighted 1 (DC, Nyquist) or 2 (the rest), zero-extended to T1 =
    2 (NB1 - 1), the inverse DFT, its real part, 1/T1. The imaginary parts
    of DC and Nyquist drop out with the real part, as irfft drops them."""
    nb1 = er.shape[-2]
    t1 = 2 * (nb1 - 1)
    w = torch.full((nb1, 1), 2.0, dtype=er.dtype, device=er.device)
    w[0] = w[-1] = 1.0
    zr = TF.pad((er * w).transpose(-1, -2), (0, t1 - nb1))
    zi = TF.pad((ei * w).transpose(-1, -2), (0, t1 - nb1))
    out, _ = _dft_last(zr, zi, True)
    return out[..., :v1].transpose(-1, -2) / t1


@lru_cache(maxsize=None)
def _mats_2d_v3(t1: int, nb1: int, t2: int, v1: int, dtype=np.float32):
    """The JAX package's dense v3 factors without its NB1P row padding
    (which only keeps the TPU's 8-row sublanes aligned and multiplies
    zeros), as ``dtype`` numpy arrays:
      f2 (2·NB1, T1)     [fr; fi], the one-sided H DFT on stacked rows
      wr, wi (T2, T2)    the W DFT
      ur, ui (T2, T2)    the inverse W DFT (1/T2 folded in)
      cz1 (V1, 2·NB1)    [ cr | ci]: Re of the H inverse on [yr; yi]
      cz2 (V1, 2·NB1)    [-ci | cr]: Im of the H inverse on [yr; yi]
    so that the valid rows of a tile are Re((C̄ Y) U) = cz1·Y·ur - cz2·Y·ui.
    On no path: the oracle of the float64 tests of ``_v3_forward`` and
    ``_v3_inverse``, which B5 and its plain version run instead."""
    fr, fi, wr, wi, ur, ui, cr, ci = _mats_2d(t1, nb1, t2, v1, np.float64)
    out = (np.concatenate([fr, fi]), wr, wi, ur, ui,
           np.concatenate([cr, ci], axis=1), np.concatenate([-ci, cr], axis=1))
    return tuple(np.ascontiguousarray(m, dtype) for m in out)


def _v3_forward(a: torch.Tensor):
    """B5's tile spectra of real windows (..., T1, T2), H first: columns q
    and q + T2/2 packed as one complex column Z, its T1-point DFT, bins k
    and -k split into the two columns' one-sided spectra (X_q = (Z[k] +
    conj Z[-k]) / 2, X_q+T2/2 = (Z[k] - conj Z[-k]) / 2i), then the W DFT
    of the NB1 rows. Returns (dr, di) (..., NB1, T2): B2's D."""
    t1, t2 = a.shape[-2:]
    nb1, n2 = t1 // 2 + 1, t2 // 2
    zr, zi = _dft_last(a[..., :n2].transpose(-1, -2), a[..., n2:].transpose(-1, -2), False)
    neg = -torch.arange(nb1, device=a.device) % t1
    ar, ai, br, bi = zr[..., :nb1], zi[..., :nb1], zr[..., neg], zi[..., neg]
    hr = torch.cat([ar + br, ai + bi], dim=-2) / 2  # (..., T2, NB1): columns q, then q + T2/2
    hi = torch.cat([ai - bi, br - ar], dim=-2) / 2
    return _dft_last(hr.transpose(-1, -2), hi.transpose(-1, -2), False)


def _v3_inverse(yr: torch.Tensor, yi: torch.Tensor, v1: int) -> torch.Tensor:
    """B5's inverse of the tile spectra (..., NB1, T2): the V1 valid rows
    (..., V1, T2) of the tile, real. H first and folded: the output is
    Re(IDFT_W(z)) for z = C Y (C the one-sided H inverse), which needs only
    the W-Hermitian half h[n, l] = (z[n, l] + conj z[n, -l]) / 2 for l in
    [0, T2/2], and T1·h[., l] is the T1-point inverse DFT of S with S[k] =
    Y[k, l], S[-k] = conj Y[k, -l] (0 < k < T1/2) and the mean of the two
    at k = 0 and T1/2. The real columns 0 and T2/2 share one transform as
    S_0 + i S_T2/2. Then the W c2r of the rows of h: rows 2p and 2p + 1 as
    one complex inverse of their Hermitian extensions."""
    nb1, t2 = yr.shape[-2:]
    t1, n1, n2 = 2 * (nb1 - 1), nb1 - 1, t2 // 2
    cols = torch.arange(n2 + 1, device=yr.device)
    ar, ai = yr[..., cols], yi[..., cols]  # (..., NB1, T2/2 + 1): columns l
    br, bi = yr[..., -cols % t2], yi[..., -cols % t2]  # columns -l
    mr, mi = (ar + br) / 2, (ai - bi) / 2  # S at k = 0 and T1/2
    sr = torch.cat([mr[..., :1, :], ar[..., 1:n1, :], mr[..., n1:, :],
                    br[..., 1:n1, :].flip(-2)], dim=-2)  # (..., T1, T2/2 + 1)
    si = torch.cat([mi[..., :1, :], ai[..., 1:n1, :], mi[..., n1:, :],
                    -bi[..., 1:n1, :].flip(-2)], dim=-2)
    pr = torch.cat([sr[..., :1] - si[..., n2:], sr[..., 1:n2]], dim=-1)  # (..., T1, T2/2)
    pi = torch.cat([si[..., :1] + sr[..., n2:], si[..., 1:n2]], dim=-1)
    hr, hi = _dft_last(pr.transpose(-1, -2), pi.transpose(-1, -2), True)  # (..., T2/2, T1)
    hr, hi = hr[..., :v1] / t1, hi[..., :v1] / t1
    zero = torch.zeros_like(hr[..., :1, :])
    hr = torch.cat([hr, hi[..., :1, :]], dim=-2).transpose(-1, -2)  # (..., V1, T2/2 + 1)
    hi = torch.cat([zero, hi[..., 1:, :], zero], dim=-2).transpose(-1, -2)
    if v1 % 2:
        hr, hi = TF.pad(hr, (0, 0, 0, 1)), TF.pad(hi, (0, 0, 0, 1))
    er = torch.cat([hr, hr[..., 1:n2].flip(-1)], dim=-1)  # Hermitian extensions (..., ·, T2)
    ei = torch.cat([hi, -hi[..., 1:n2].flip(-1)], dim=-1)
    outr, outi = _dft_last(er[..., 0::2, :] - ei[..., 1::2, :],
                           ei[..., 0::2, :] + er[..., 1::2, :], True)
    out = torch.stack([outr, outi], dim=-2).flatten(-3, -2)
    return out[..., :v1, :] / t2


def kernel_spectra_2d(kernel: torch.Tensor, t1: int, nb1: int, t2: int) -> torch.Tensor:
    """Conjugated spectra of the (Cout, Cin/g, K1, K2) kernel on the tile
    grid, (Cout, Cin/g, NB1, T2) complex on the kernel's device: the kernel's
    input, and the port of the JAX package's ``_kernel_spectra_2d``.

    The two small transforms run in float64 (over the weights only, and
    exact to float32 rounding whatever TF32 setting the caller chose); the
    result is complex128 for a float64 kernel and complex64 otherwise. They
    are the only torch products on the CUDA route, outside the kernel, as the
    JAX package computes them in XLA outside Pallas."""
    _, _, k1, k2 = kernel.shape
    fr, fi, wr, wi = _torch_mats(t1, nb1, t2, 1, torch.float64, kernel.device)[:4]
    k = kernel.detach().to(torch.float64)
    ar = fr[:, :k1] @ k  # (Cout, Cin/g, NB1, K2)
    ai = fi[:, :k1] @ k
    br = ar @ wr[:k2] - ai @ wi[:k2]
    bi = ar @ wi[:k2] + ai @ wr[:k2]
    out = torch.complex(br, -bi)
    return out if kernel.dtype == torch.float64 else out.to(torch.complex64)


def _tiling(plan, hp: int, wp: int, k1: int, k2: int) -> Tuple[int, int, int, int]:
    """(OH, OW, nt1, nt2): the valid output size and the tile counts."""
    _, v1, _, _, v2 = plan
    oh, ow = hp - k1 + 1, wp - k2 + 1
    return oh, ow, -(-oh // v1), -(-ow // v2)


def _reference_tiles(x_padded: torch.Tensor, kernel: torch.Tensor):
    """The shared head of the plain versions: (plan, working dtype, the
    (B, Cin, nt1, nt2, T1, T2) windows of the zero-extended signal)."""
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    _, _, hp, wp = x_padded.shape
    cout, cpg, k1, k2 = kernel.shape
    plan = tile_plan_2d(k1, k2, cpg, cout)
    if plan is None:
        raise ValueError("no fused 2D configuration fits this shape")
    t1, v1, _, t2, v2 = plan
    _, _, nt1, nt2 = _tiling(plan, hp, wp, k1, k2)
    need_h, need_w = (nt1 - 1) * v1 + t1, (nt2 - 1) * v2 + t2
    x = TF.pad(x_padded.to(dt), (0, need_w - wp, 0, need_h - hp))
    return plan, dt, x.unfold(2, t1, v1).unfold(3, t2, v2)


def _reference_mac(dr, di, kernel, groups, plan, dt, spectra=None):
    """Per-bin complex MAC over each out-channel's group of in-channels:
    (yr, yi) of shape (B, Cout, nt1, nt2, NB1, T2) from the tile spectra
    (B, Cin, nt1, nt2, NB1, T2), against a plan's baked ``spectra`` or,
    when there are none, ``kernel_spectra_2d``."""
    t1, _, nb1, t2, _ = plan
    b, _, nt1, nt2 = dr.shape[:4]
    cout, cpg = kernel.shape[:2]
    ks = _spectra_or(spectra, dt, lambda: kernel_spectra_2d(kernel.to(dt), t1, nb1, t2))
    kr = ks.real.reshape(groups, cout // groups, cpg, nb1, t2)
    ki = ks.imag.reshape(groups, cout // groups, cpg, nb1, t2)
    dr = dr.reshape(b, groups, cpg, nt1, nt2, nb1, t2)
    di = di.reshape(b, groups, cpg, nt1, nt2, nb1, t2)
    mac = "bgcijkz,gockz->bgoijkz"
    yr = torch.einsum(mac, dr, kr) - torch.einsum(mac, di, ki)
    yi = torch.einsum(mac, dr, ki) + torch.einsum(mac, di, kr)
    return yr.reshape(b, cout, nt1, nt2, nb1, t2), yi.reshape(b, cout, nt1, nt2, nb1, t2)


def _reference_stitch(out, x_padded, kernel, plan):
    """(B, Cout, nt1, nt2, V1, T2) tile outputs -> the valid correlation
    (B, Cout, OH, OW): the V2 valid columns of each tile, side by side."""
    _, v1, _, _, v2 = plan
    b, cout, nt1, nt2 = out.shape[:4]
    oh, ow, _, _ = _tiling(plan, *x_padded.shape[2:], *kernel.shape[2:])
    out = out[..., :v2].permute(0, 1, 2, 4, 3, 5)
    return out.reshape(b, cout, nt1 * v1, nt2 * v2)[:, :, :oh, :ow]


def _fused2d_forward_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B2's plain PyTorch version: the same tiled pipeline with each DFT
    axis factored as the kernel factors it (``_dft_last``: the same factors,
    twiddles and natural bin order), in split re/im arithmetic, float64 for
    a float64 signal and float32 otherwise. The kernel runs the short DFTs
    as butterflies and packs real rows and columns in pairs; this version
    applies the factors as dense products.

    ``x_padded`` (B, Cin, Hp, Wp) already padded, ``kernel`` (Cout, Cin/g,
    K1, K2) already dilated; returns the valid correlation (B, Cout, OH, OW).
    ``spectra``: a plan's baked ``kernel_spectra_2d``, or None to compute
    them.
    """
    plan, dt, a = _reference_tiles(x_padded, kernel)
    v1 = plan[1]
    dr, di = _dft_last(*_h_forward(a), False)  # W DFT: (B, Cin, nt1, nt2, NB1, T2)
    yr, yi = _reference_mac(dr, di, kernel, groups, plan, dt, spectra)
    out = _h_irfft(*_w_inverse(yr, yi), v1)  # (B, Cout, nt1, nt2, V1, T2)
    return _reference_stitch(out, x_padded, kernel, plan)


def _fused2d_forward_reference_v3(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """B5's plain PyTorch version: the v3 schedule with B5's factors, float64
    for a float64 signal and float32 otherwise. The H-first forward on
    packed column pairs, then W (``_v3_forward``); B2's MAC; the folded
    H-first inverse and the W c2r on row pairs (``_v3_inverse``), every DFT
    through ``_dft_last`` in split re/im arithmetic. Arguments and result as
    ``_fused2d_forward_reference``."""
    plan, dt, a = _reference_tiles(x_padded, kernel)
    yr, yi = _reference_mac(*_v3_forward(a), kernel, groups, plan, dt, spectra)
    return _reference_stitch(_v3_inverse(yr, yi, plan[1]), x_padded, kernel, plan)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused2d")
    if lib.fused2d_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused2d_forward.argtypes = [p] * 5 + [i] * 15 + [p]
        lib.fused2d_forward.restype = i
        lib.fused2d_error_string.argtypes = [i]
        lib.fused2d_error_string.restype = ctypes.c_char_p
        lib.fused2d_smem_bytes.argtypes = [i, i]
        lib.fused2d_smem_bytes.restype = ctypes.c_longlong
        lib.fused2d_v3_forward.argtypes = [p] * 5 + [i] * 15 + [p]
        lib.fused2d_v3_forward.restype = i
        lib.fused2d_v3_smem_bytes.argtypes = [i, i]
        lib.fused2d_v3_smem_bytes.restype = ctypes.c_longlong
    return lib


def _planes(spectra: torch.Tensor) -> torch.Tensor:
    """Complex spectra (Cout, Cin/g, NB1, T2) as B5's split planes (Cout,
    Cin/g, 2, NB1, T2): a copy, no transform."""
    return torch.stack([spectra.real, spectra.imag], dim=2).contiguous()


def kernel_spectra_2d_planes(kernel: torch.Tensor, t1: int, nb1: int, t2: int) -> torch.Tensor:
    """B5's input: ``kernel_spectra_2d`` as split planes (Cout, Cin/g, 2,
    NB1, T2) of the real and imaginary parts, float32 (float64 for a
    float64 kernel)."""
    return _planes(kernel_spectra_2d(kernel, t1, nb1, t2))


def _check_launch(x_padded, spectra, plan, groups, k, v3):
    """The checks both launchers share: B2 takes complex64 spectra (Cout,
    Cin/g, NB1, T2), B5 float32 planes (Cout, Cin/g, 2, NB1, T2). Returns
    the contiguous signal and spectra, (OH, OW), the tiles across W, the
    tile count and the tiles per launch."""
    what = "fused2d_v3" if v3 else "fused2d"
    dtype = torch.float32 if v3 else torch.complex64
    if not (x_padded.is_cuda and spectra.device == x_padded.device):
        raise ValueError(f"{what} kernel: signal and spectra must be on one CUDA device")
    if x_padded.dtype != torch.float32 or spectra.dtype != dtype:
        raise ValueError(f"{what} kernel takes a float32 signal and {dtype} spectra")
    x_padded = x_padded.contiguous()
    spectra = spectra.contiguous()
    b, cin, hp, wp = x_padded.shape
    cout, cpg = spectra.shape[:2]
    _, _, nb1, t2, _ = plan
    tail = ((2,) if v3 else ()) + (nb1, t2)
    if spectra.shape[2:] != tail or cpg * groups != cin or cout % groups:
        raise ValueError(f"{what} kernel: spectra {tuple(spectra.shape)} do not fit "
                         f"the plan {plan}, Cin={cin}, groups={groups}")
    oh, ow, nt1, nt2 = _tiling(plan, hp, wp, *k)
    if oh < 1 or ow < 1:
        raise ValueError(f"{what} kernel: the kernel is larger than the signal")
    ntiles = nt1 * nt2
    # tiles per launch: as many as the scratch budget holds (the routing gate,
    # fused2d_fits, has checked that one tile does)
    per_tile = _scratch_bytes_per_tile(nb1, t2, b, cin)
    chunk = max(1, min(ntiles, _SCRATCH_BUDGET // per_tile, _MAX_TILES_PER_LAUNCH))
    return x_padded, spectra, oh, ow, nt2, ntiles, chunk


def _launch_fused2d(
    x_padded: torch.Tensor, spectra: torch.Tensor, plan, groups: int, k: Tuple[int, int]
) -> torch.Tensor:
    """Runs the CUDA kernel pair on ``x_padded`` (B, Cin, Hp, Wp) float32
    with the conjugated spectra (Cout, Cin/g, NB1, T2) complex64 of a
    (K1, K2) kernel, both on one CUDA device, under the tile plan ``plan``.
    Returns the valid correlation (B, Cout, OH, OW)."""
    global launches
    x_padded, spectra, oh, ow, nt2, ntiles, chunk = _check_launch(
        x_padded, spectra, plan, groups, k, v3=False)
    b, cin, hp, wp = x_padded.shape
    cout = spectra.shape[0]
    t1, v1, nb1, t2, v2 = plan

    lib = _library()
    fac = _device_factors(t1, t2, x_padded.device)
    out = torch.empty((b, cout, oh, ow), device=x_padded.device, dtype=torch.float32)
    d = torch.empty((chunk, b, cin, nb1, t2), device=x_padded.device, dtype=torch.complex64)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    with torch.cuda.device(x_padded.device):
        for tile0 in range(0, ntiles, chunk):
            err = lib.fused2d_forward(
                x_padded.data_ptr(), spectra.data_ptr(), fac.data_ptr(), d.data_ptr(),
                out.data_ptr(),
                b, cin, cout, groups, hp, wp, t1, t2, v1, v2, nt2,
                tile0, min(chunk, ntiles - tile0), oh, ow, stream,
            )
            if err != 0:
                msg = lib.fused2d_error_string(err).decode()
                raise RuntimeError(f"fused2d kernel launch failed: {msg} (cudaError {err})")
            launches += 1
    return out


def _launch_fused2d_v3(
    x_padded: torch.Tensor, spectra: torch.Tensor, plan, groups: int, k: Tuple[int, int]
) -> torch.Tensor:
    """Runs kernel B5 (phase 1 + phase 2) on ``x_padded`` (B, Cin, Hp, Wp)
    float32 with the split-plane spectra (Cout, Cin/g, 2, NB1, T2) float32
    of a (K1, K2) kernel (``kernel_spectra_2d_planes``), both on one CUDA
    device, under the tile plan ``plan``. Returns the valid correlation
    (B, Cout, OH, OW)."""
    global launches_v3
    x_padded, spectra, oh, ow, nt2, ntiles, chunk = _check_launch(
        x_padded, spectra, plan, groups, k, v3=True)
    b, cin, hp, wp = x_padded.shape
    cout = spectra.shape[0]
    t1, v1, nb1, t2, v2 = plan

    lib = _library()
    fac = _device_factors(t1, t2, x_padded.device)
    out = torch.empty((b, cout, oh, ow), device=x_padded.device, dtype=torch.float32)
    # the stacked tile spectra [dr; di], as many bytes as B2's complex D
    d = torch.empty((chunk, b, cin, 2, nb1, t2), device=x_padded.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    with torch.cuda.device(x_padded.device):
        for tile0 in range(0, ntiles, chunk):
            err = lib.fused2d_v3_forward(
                x_padded.data_ptr(), spectra.data_ptr(), fac.data_ptr(), d.data_ptr(),
                out.data_ptr(),
                b, cin, cout, groups, hp, wp, t1, t2, v1, v2, nt2,
                tile0, min(chunk, ntiles - tile0), oh, ow, stream,
            )
            if err != 0:
                msg = lib.fused2d_error_string(err).decode()
                raise RuntimeError(f"fused2d_v3 kernel launch failed: {msg} (cudaError {err})")
            launches_v3 += 1
    return out


def _fused2d_forward(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
):
    """Valid correlation of ``x_padded`` with ``kernel`` under the schedule
    that ``set_fused2d_kernel`` chose, read at call time: the CUDA kernel
    (B2 or B5) for a CUDA tensor, its plain version for a CPU one.
    ``spectra``: a plan's baked ``kernel_spectra_2d`` (B5 takes them as
    planes, ``_planes``), or None to compute them. They are computed here,
    ahead of the call's record for a running cost analysis
    (``costs.record``), so that the analysis counts their transforms as the
    aten ops they are, on the CPU as on the card; the record holds the
    kernel's own count, whichever of the two runs."""
    if x_padded.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused2d runs on CUDA or CPU tensors, got {x_padded.device}")
    v3 = _KERNEL2D_VERSION == "v3"
    b, cin, hp, wp = x_padded.shape
    cout, cpg, k1, k2 = kernel.shape
    plan = tile_plan_2d(k1, k2, cpg, cout)
    if plan is None:
        raise ValueError("no fused 2D configuration fits this shape")
    if spectra is None:
        t1, _, nb1, t2, _ = plan
        spectra = kernel_spectra_2d(kernel, t1, nb1, t2)
    record = costs.IDLE
    if costs.active():
        shape = (b, cin, cout, hp, wp, (k1, k2), plan, groups)
        kernel_flops = costs.fused2d_v3_kernel_flops if v3 else costs.fused2d_kernel_flops
        record = costs.record("B5" if v3 else "B2", kernel_flops(*shape),
                              costs.fused2d_work(*shape)[0])
    with record:
        if x_padded.is_cuda:
            if v3:
                return _launch_fused2d_v3(x_padded.float(), _planes(spectra), plan, groups,
                                          (k1, k2))
            return _launch_fused2d(x_padded.float(), spectra, plan, groups, (k1, k2))
        reference = _fused2d_forward_reference_v3 if v3 else _fused2d_forward_reference
        return reference(x_padded.float(), kernel.float(), groups, spectra)


class _Fused2dCore(torch.autograd.Function):
    """The fused 2D correlation with the composed path as its backward;
    ``spectra`` are a plan's baked kernel spectra (None: computed per call)."""

    @staticmethod
    def forward(ctx, x_padded, kernel, groups, spectra=None):
        ctx.save_for_backward(x_padded, kernel)
        ctx.groups = groups
        return _fused2d_forward(x_padded, kernel, groups, spectra)

    @staticmethod
    def backward(ctx, g):
        x_padded, kernel = ctx.saved_tensors
        dx, dw = _fused_bwd(
            x_padded, kernel, g.contiguous(), ctx.groups,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1],
        )
        return dx, dw, None, None


def fft_conv2d_fused(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    padding_mode: str = "constant",
    stride=1,
    dilation=1,
    groups: int = 1,
) -> torch.Tensor:
    """Fused 2D FFT convolution, ``ops.fft_conv`` semantics.

    Padding modes, stride, dilation and groups are wrapper transforms
    around the unit-stride kernel, as in the 1D function. Raises ValueError
    when no fused configuration fits; unlike the JAX function it does not
    fall back (``fft_conv`` with ``impl="auto"`` calls
    ``fft_conv2d_fused_if_fits`` and takes the composed path instead).
    """
    out = fft_conv2d_fused_if_fits(
        signal, kernel, bias, padding, padding_mode, stride, dilation, groups
    )
    if out is None:
        raise ValueError(
            "no fused 2D FFT configuration fits this shape (no tile plan, or "
            "the spectra, the shared memory or the scratch exceed the "
            "kernel's budgets); use fft_conv(impl='xla')"
        )
    return out


def fft_conv2d_fused_if_fits(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    padding_mode: str = "constant",
    stride=1,
    dilation=1,
    groups: int = 1,
) -> Optional[torch.Tensor]:
    """``fft_conv2d_fused``, or None when ``fused2d_fits`` does not hold for
    the padded signal and the dilated kernel. The one place where that gate
    is checked, for both the fused function and ``fft_conv(impl="auto")``."""
    if signal.ndim != 4 or kernel.ndim != 4:
        raise ValueError(
            "fft_conv2d_fused expects (B, Cin, H, W) and (Cout, Cin/g, K1, K2)"
        )
    padding_ = to_ntuple(padding, 2)
    stride_ = to_ntuple(stride, 2)
    kernel = F._dilate_kernel(kernel, to_ntuple(dilation, 2))
    x = F._pad_signal(signal, padding_, padding_mode)
    b, cin, hp, wp = x.shape
    cout, cpg, k1, k2 = kernel.shape
    if cpg * groups != cin:
        raise ValueError(
            f"kernel Cin/groups {cpg} x groups {groups} != signal Cin {cin}"
        )
    if cout % groups:
        raise ValueError(f"out_channels {cout} not divisible by groups {groups}")
    if k1 > hp or k2 > wp:
        raise ValueError("Kernel size can't be greater than actual input size")
    if not fused2d_fits(k1, k2, cpg, cout, (hp, wp), cin_total=cin, batch=b):
        return None
    out = _Fused2dCore.apply(x.float(), kernel.float(), groups)
    if stride_ != (1, 1):
        out = out[:, :, ::stride_[0], ::stride_[1]]
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.to(signal.dtype)


def plan_fft_conv2d(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    padding_mode: str = "constant",
    *,
    signal_hw,
    device: Device = None,
):
    """Serving plan: the kernel's tile spectra are computed once, on
    ``device`` (the card unless ``device="cpu"``), and the returned
    ``fn(signal) -> out`` only transforms the signal, whose spatial shape
    must be ``signal_hw``. The port of the JAX package's ``plan_fft_conv2d``:
    groups=1, stride=1, dilation=1; raises ValueError where
    ``fused2d_fits`` does not hold. Each call runs the schedule that
    ``set_fused2d_kernel`` names at that time (B2, or B5 on the same
    spectra as planes). The signal's gradient flows through the composed
    path; the baked kernel is a constant."""
    if kernel.ndim != 4:
        raise ValueError("plan_fft_conv2d expects (Cout, Cin, K1, K2)")
    dev = resolve_device(device, "plans are built")
    padding_ = to_ntuple(padding, 2)
    h, w = (int(s) for s in signal_hw)
    cout, cin, k1, k2 = kernel.shape
    hp, wp = h + 2 * padding_[0], w + 2 * padding_[1]
    if not fused2d_fits(k1, k2, cin, cout, (hp, wp)):
        raise ValueError(
            "no fused 2D configuration fits this shape (no tile plan, or the "
            "kernel is larger than the padded signal)"
        )
    t1, _, nb1, t2, _ = tile_plan_2d(k1, k2, cin, cout)
    kernel = kernel.detach().to(dev, torch.float32)
    bias = None if bias is None else bias.detach().to(dev, torch.float32)
    spectra = kernel_spectra_2d(kernel, t1, nb1, t2)

    def planned(signal: torch.Tensor) -> torch.Tensor:
        check_planned_signal(signal, (h, w), dev)
        x = F._pad_signal(signal, padding_, padding_mode)
        out = _Fused2dCore.apply(x.float(), kernel, 1, spectra)
        if bias is not None:
            out = out + bias.reshape(1, -1, 1, 1)
        return out.to(signal.dtype)

    return planned


def fft_conv_transpose2d_fused(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    stride=1,
    dilation=1,
    groups: int = 1,
    output_padding=0,
) -> torch.Tensor:
    """Fused 2D transposed convolution, ``ops.fft_conv_transpose`` semantics:
    ``fft_conv2d_fused`` (B2, or B5 under "v3") on the zero-stuffed signal
    (``F._fused_transpose``), the port of the JAX package's
    ``fft_conv_transpose2d_fused``. Raises ValueError where no fused
    configuration fits the stuffed signal."""
    out = fft_conv_transpose2d_fused_if_fits(
        signal, kernel, bias, padding, stride, dilation, groups, output_padding
    )
    if out is None:
        raise ValueError(
            "no fused 2D FFT configuration fits this shape (no tile plan for the "
            "stuffed signal of the transposed conv, or the spectra, the shared "
            "memory or the scratch exceed the kernel's budgets); use "
            "fft_conv_transpose(impl='xla')"
        )
    return out


def fft_conv_transpose2d_fused_if_fits(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    stride=1,
    dilation=1,
    groups: int = 1,
    output_padding=0,
) -> Optional[torch.Tensor]:
    """``fft_conv_transpose2d_fused``, or None when
    ``fft_conv2d_fused_if_fits`` finds no fit for the stuffed signal; the
    gate of ``fft_conv_transpose(impl="auto")``."""
    if signal.ndim != 4 or kernel.ndim != 4:
        raise ValueError(
            "fft_conv_transpose2d_fused expects (B, Cin, H, W) and (Cin, Cout/g, K1, K2)"
        )
    return F._fused_transpose(
        signal, kernel, bias, to_ntuple(padding, 2), to_ntuple(stride, 2),
        to_ntuple(dilation, 2), groups, to_ntuple(output_padding, 2),
        lambda x, w, g: fft_conv2d_fused_if_fits(x, w, groups=g),
    )
