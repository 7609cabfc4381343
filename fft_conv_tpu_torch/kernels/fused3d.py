"""Fused 3D FFT convolution: host side of the CUDA kernels ``csrc/fused3d.cu``.

The port's counterpart of ``fft_conv_tpu/kernels/fused3d.py``, with both of
its plans. Either way the whole padded volume is transformed along H and W
per d-slab: a one-sided H DFT at the full H (NBH = H/2+1 rows) and a
64-point W DFT (W zero-padded to 64, or cut into overlap-save blocks of 64
columns when W is wider), factored 64 = 8·8 as a four-step transform
(``_w_factors``). For H = 16, 32, 64 and 128 (``_H_SPLITS``) the H DFT and
its inverse are factored too and run on slab pairs: two d-slabs packed as one
complex column, one H-point DFT, bins k and H - k split into the two slabs'
rows (``_h_forward_pairs``), and a c2r of two slabs at once
(``_h_inverse_pairs``); every other H keeps the dense products. Along D:

* 'v4' (kernel B3, the JAX package's plan for KD <= 9): a DFT-16 per block
  of 16 samples on a hop of 8 (zeros past D). The MAC over each group's
  input channels against the conjugated kernel spectra is then a pointwise
  product, and the inverse DFT-16 keeps the 8 valid d of each block.
* 'tap' (kernel B4, for KD > 9 and wherever the v4 plan does not fit): D
  stays in the tap domain. For every (h-bin, w-bin) the MAC is the
  correlation Y[o, d] = sum_c sum_t S[c, d + t] K[o, c, t] over the KD taps,
  against the conjugated per-tap 2D kernel spectra.

The inverse W DFT and the H irfft then keep the valid columns and rows.

The x-pack switch (``set_fused3d_xpack``, read at call time as the JAX
package reads it) names how a 'v4' plan's kernel reads the signal. Under
"pk" kernel B6 (``fused3d_pack``) first packs it into the JAX package's
x layout (B', H, Cin·PP, 128), the d-pairs of each channel side by side in
128 lanes, and B3 reads that; under the other names B3 reads (B, Cin, D,
H, W) directly. A 'tap' plan always reads directly.

On a CUDA tensor ``_fused3d_forward`` launches the plan's kernels; on a CPU
tensor it runs their plain versions (``_pack3d_reference``,
``_fused3d_forward_reference``, ``_fused3d_tap_reference``), the same
pipeline written with torch ops (the counterpart of the JAX package's
Pallas interpret mode). There is no other route: a CUDA tensor launches the
kernel or raises.

Gradients: ``_Fused3dCore`` is a ``torch.autograd.Function`` whose backward
is the composed path, shared with the 1D and 2D kernels
(``fused1d._fused_bwd``). ``fft_conv_transpose3d_fused`` runs a transposed
convolution through the same forward on a zero-stuffed signal.
``plan_fft_conv3d`` bakes the kernel spectra once for serving.

Not ported from the JAX module: the TPU's precision, MAC, staging and
inline-spectra switches: the port's kernels compute in FP32 with one
schedule each.
"""

import ctypes
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
from .fourstep import dft_last, fft_factor_matrices, split_factors
from .fused1d import _fused_bwd, _spectra_or

# W transform length and its four-step split 64 = 8 * 8 (the kernels factor
# the W DFT so), and the D blocks: 16 samples on a hop of 8
_TW = 64
_W_SPLIT = (8, 8)
# The H lengths whose DFT the kernels factor, with their four-step splits
# (csrc/fused3d.cu: HSplit): the powers of two 16 to 128, slab pairs through
# one complex transform each; every other H keeps the dense products
_H_SPLITS = {h: split_factors(h) for h in (16, 32, 64, 128)}
_DB = 16
_DHOP = 8

# The JAX package bounds its TPU cell by VMEM budgets (resident spectra of
# 24 MiB, a whole-volume cell of 96 MiB for v4 and 80 MiB for tap). These
# kernels keep no volume in shared memory: their blocks hold a few d-slabs
# of NBH x 64 complex values. Their own limits are:
#   * the conjugated kernel spectra, which the MAC re-reads: v4's (Cout,
#     Cin/g, 16, NBH, 64) complex once per (batch, D-block), tap's (Cout,
#     Cin/g, KD, NBH, 64) once per (batch, chunk of 8 valid d). Kept within
#     half of the card's 50 MB L2. The 1D/2D budget of 16 MiB would not do:
#     the v4 spectra of the library's 3D benchmark row (64^3, K=8, 8 -> 8
#     channels) are 17.3 MB, and they must fuse;
_SPECTRA_BUDGET = 24 * 2**20
#   * the shared memory of one block of the H/W phases, which both plans run
#     (csrc/fused3d.cu: Cfg<SB>::smem): SB d-slabs of NBH x 64 complex,
#     SB in {4, 2, 1}, at most what a Hopper block can use, so NBH <= 454
#     (H <= 907);
_SMEM_LIMIT = 232448
#   * the scratch that the kernels hand on, per (batch, W-block) item: the
#     H/W spectra T (Cin, D, NBH, 64), for v4 the block spectra S (Cin, NBD,
#     16, NBH, 64), and the MAC's output Z (Cout, OD, NBH, 64), complex. The
#     wrappers run the items in ranges under this budget, so one item must
#     fit.
_SCRATCH_BUDGET = 256 * 2**20

# Launches since import or the last reset, one per range of items: of B3's
# chain of four kernels (v4 plans) and of B4's chain of three (tap plans);
# and of B6, one per call of a 'v4' plan under "pk". The plain versions on
# CPU tensors do not count.
launches = 0
launches_tap = 0
launches_pack = 0

# How a 'v4' plan reads the signal; _fused3d_forward reads it at call time.
# "pk" runs B6 ahead of B3. "h", "h2", "d2" and "d0" name the JAX package's
# TPU HBM layouts, which have no kernel here: under them B3 reads (B, Cin, D,
# H, W) directly. The default is the JAX package's.
_XPACK3D = "h2"


def set_fused3d_xpack(mode: str) -> None:
    """Selects how a 'v4' plan's kernel reads the signal: "pk" packs it with
    kernel B6 and runs B3 on the packed layout; "h", "h2", "d2" and "d0"
    (the JAX package's TPU layouts) keep B3's direct read. Both compute the
    same function."""
    global _XPACK3D
    if mode not in ("h", "d2", "d0", "h2", "pk"):
        raise ValueError(f"unknown fused 3D x-pack mode: {mode!r}")
    _XPACK3D = mode


def _tap_counts(kd: int) -> Tuple[int, int]:
    """(ME, MR): even-tap count and R-tap count (0 when KD has no odd taps),
    as the JAX package's tap kernel splits the D taps."""
    me = (kd + 1) // 2
    mo = kd // 2
    return me, (mo + 1) if mo else 0


def _slabs_per_block(nbh: int) -> Optional[int]:
    """SB, the d-slabs one block of the H/W phases holds: the most of
    {4, 2, 1} whose shared memory fits, as csrc/fused3d.cu picks it."""
    for sb in (4, 2, 1):
        if sb * nbh * _TW * 8 <= _SMEM_LIMIT:
            return sb
    return None


def _smem_bytes(nbh: int) -> int:
    """Dynamic shared memory of one block of the H/W phases, as
    csrc/fused3d.cu computes it (``fused3d_smem_bytes`` exports the kernel's
    own figure; a card test holds the two equal), or -1 when none fits."""
    sb = _slabs_per_block(nbh)
    return -1 if sb is None else sb * nbh * _TW * 8


def _scratch_bytes_per_item(cin: int, cout: int, d: int, nbh: int, nbd: int, od: int) -> int:
    return (cin * d + cin * nbd * _DB + cout * od) * nbh * _TW * 8


def _tap_scratch_bytes_per_item(cin: int, cout: int, d: int, nbh: int, od: int) -> int:
    return (cin * d + cout * od) * nbh * _TW * 8


@lru_cache(maxsize=None)
def plan_3d(cin: int, cout: int, d: int, h: int, w: int,
            kd: int, kh: int, kw: int, groups: int = 1):
    """Mode-tagged plan, or None when nothing fits: the JAX package's
    ``plan_3d`` with this port's budgets.

    ('v4', nbh, nbhp, pp, nbd, vdp) runs kernel B3 (KD <= 9);
    ('tap', nbh, vdp, pages) runs kernel B4, for larger KD and wherever the
    v4 plan does not fit. Eligibility: W fits one 64-point transform (see
    ``plan_3d_blocked`` for wider W). ``cin`` is the TOTAL in-channel
    count."""
    if w > _TW or kd > d or kh > h or kw > w:
        return None
    if cin % groups or cout % groups:
        return None
    v4 = _plan_v4(cin, cout, d, h, w, kd, kh, kw, groups)
    if v4 is not None:
        return v4
    return _plan_tap(cin, cout, d, h, w, kd, kh, kw, groups)


def plan_3d_blocked(cin: int, cout: int, d: int, h: int, w: int,
                    kd: int, kh: int, kw: int, groups: int = 1):
    """(plan, nwb, hop): the W-overlap-save extension of ``plan_3d``.

    W <= 64 runs as one block (nwb = 1, hop = the valid width). Wider W is
    cut into nwb overlapping width-64 blocks on a 64-kw+1 hop, the last one
    clamped to end at the input's edge."""
    if w <= _TW:
        plan = plan_3d(cin, cout, d, h, w, kd, kh, kw, groups)
        return None if plan is None else (plan, 1, w - kw + 1)
    if kw > _TW:
        return None
    hop = _TW - kw + 1
    nwb = -(-(w - kw + 1) // hop)
    plan = plan_3d(cin, cout, d, h, _TW, kd, kh, kw, groups)
    return None if plan is None else (plan, nwb, hop)


def _plan_v4(cin: int, cout: int, d: int, h: int, w: int,
             kd: int, kh: int, kw: int, groups: int = 1):
    """The JAX package's overlap-save-D geometry (nbhp, pp and vdp are its
    TPU layout's, kept so the plans compare equal) under kernel B3's
    budgets: spectra in L2, shared memory, scratch per item."""
    if kd > 9:
        return None  # a 16-sample block leaves 8 valid d only for kd <= 9
    nbh = h // 2 + 1
    nbhp = -(-nbh // 8) * 8
    vd = d - kd + 1
    nbd = -(-vd // 8)
    pp = -(-(4 * (nbd - 1) + 8) // 8) * 8
    vdp = -(-(4 * nbd) // 8) * 8
    if _DB * (cin // groups) * cout * nbh * _TW * 8 > _SPECTRA_BUDGET:
        return None
    if _slabs_per_block(nbh) is None:
        return None
    if _scratch_bytes_per_item(cin, cout, d, nbh, nbd, vd) > _SCRATCH_BUDGET:
        return None
    return ("v4", nbh, nbhp, pp, nbd, vdp)


def _plan_tap(cin: int, cout: int, d: int, h: int, w: int,
              kd: int, kh: int, kw: int, groups: int = 1):
    """The JAX package's tap geometry (vdp and pages are its TPU d-pair
    layout's, kept so the plans compare equal) under kernel B4's budgets:
    spectra in L2, shared memory, scratch per item."""
    nbh = h // 2 + 1
    vd = d - kd + 1
    if kd * (cin // groups) * cout * nbh * _TW * 8 > _SPECTRA_BUDGET:
        return None
    if _slabs_per_block(nbh) is None:
        return None
    if _tap_scratch_bytes_per_item(cin, cout, d, nbh, vd) > _SCRATCH_BUDGET:
        return None
    me, mr = _tap_counts(kd)
    vdp = -(-(-(-vd // 2)) // 8) * 8
    maxoff = max(me - 1, mr - 1 if mr else 0)
    wrows = -(-(8 + maxoff) // 8) * 8
    return ("tap", nbh, vdp, vdp - 8 + wrows)


def _w_starts(w: int, nwb: int, hop: int):
    """The first input column of each W block: the last block is clamped to
    end at the input's edge."""
    return [min(i * hop, max(w - _TW, 0)) for i in range(nwb)]


def _w_blocks(w: int, ow: int, nwb: int, hop: int):
    """[(start, lo, hi)] per W block: input columns [start, start + 64),
    stored output columns start + [lo, hi). The clamped last block's first
    lo columns repeat its neighbour's."""
    return [(start, i * hop - start, min(hop, ow - start))
            for i, start in enumerate(_w_starts(w, nwb, hop))]


@lru_cache(maxsize=None)
def _mats_3d(h: int, vh: int, dtype=np.float32):
    """Split factor matrices as ``dtype`` numpy arrays (float32 for the
    kernel, float64 for an oracle): H one-sided forward (NBH, H), W DFT-64
    forward and inverse (64, 64), D DFT-16 forward (16, 16), the inverse
    DFT-16 rows of the 8 valid d (8, 16) with its 1/16, and the H irfft
    valid rows (VH, NBH)."""
    fr, fi = _rfft_mats(h, np.float64)               # (H, NBH)
    wr, wi = _dft_mats(_TW, False, np.float64)
    ur, ui = _dft_mats(_TW, True, np.float64)
    dr, di = _dft_mats(_DB, False, np.float64)
    er, ei = _dft_mats(_DB, True, np.float64)
    cr, ci = _irfft_mats(h, np.float64)              # (NBH, H)
    out = (fr.T, fi.T, wr, wi, ur, ui, dr, di, er[:_DHOP], ei[:_DHOP], cr.T[:vh], ci.T[:vh])
    return tuple(np.ascontiguousarray(m, dtype) for m in out)


@lru_cache(maxsize=None)
def _torch_mats(h: int, vh: int, dtype: torch.dtype, device: torch.device):
    """``_mats_3d`` without its dense W DFT-64 pairs (the kernels and their
    plain versions factor W: ``_w_factors``, ``fourstep.dft_last``) as torch
    tensors of ``dtype`` on ``device``, made once per device so that repeated
    calls copy nothing from the host: (fr, fi, dr, di, er, ei, cr, ci)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    m = _mats_3d(h, vh, npdt)
    return tuple(torch.from_numpy(m[i]).to(device) for i in (0, 1, 6, 7, 8, 9, 10, 11))


@lru_cache(maxsize=None)
def _factor_vector(split: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """The factors of a four-step split (A, B) as one complex64 vector of
    A + B + A·B on ``device``, from ``fourstep.fft_factor_matrices`` (built
    in float64), in the order csrc/fused3d.cu reads them: the A roots of
    unity of step 1 (row 1 of f1), the B of step 2 (row 1 of f2) and the
    (A, B) twiddle tw[m1, j2] = exp(-2 pi i m1 j2 / (A·B)), row-major. The
    kernel reads f1[m, j] as root[(m * j) % A]; its inverse conjugates all
    three."""
    f1, f2, tw = fft_factor_matrices(*split)
    parts = np.concatenate([f1[1], f2[1], tw.reshape(-1)]).astype(np.complex64)
    return torch.from_numpy(parts).to(device)


def _w_factors(device: torch.device) -> torch.Tensor:
    """The factors of the W DFT-64 (``_W_SPLIT``), a complex64 vector of 80:
    ``_factor_vector``."""
    return _factor_vector(_W_SPLIT, device)


def _h_path(h: int) -> str:
    """Which H/W kernels an H runs: "factored" (``_H_SPLITS``) or "dense"."""
    return "factored" if h in _H_SPLITS else "dense"


@lru_cache(maxsize=None)
def _device_mats(h: int, vh: int, device: torch.device):
    """The kernel's factors as interleaved complex64 tensors on ``device``,
    in the order of the entry points' arguments: F_H (NBH, H), the W factors
    (``_w_factors``, one slot that the forward and the inverse both read),
    the H factors (``_factor_vector`` of ``_H_SPLITS[h]``, read alike), the
    DFT-16 (16, 16), its inverse rows (8, 16) and the irfft rows (VH, NBH)
    as (cr, ci) pairs. For an H in ``_H_SPLITS`` F_H and the irfft rows are
    None (the factored kernels take the H factors), for any other H the H
    factors are."""
    m = _torch_mats(h, vh, torch.float32, device)
    df, ei = (torch.complex(m[i], m[i + 1]) for i in (2, 4))
    if h in _H_SPLITS:
        return None, _w_factors(device), _factor_vector(_H_SPLITS[h], device), df, ei, None
    fh, ch = (torch.complex(m[i], m[i + 1]) for i in (0, 6))
    return fh, _w_factors(device), None, df, ei, ch


@lru_cache(maxsize=None)
def _spectra_mats(h: int, kd: int, kh: int, kw: int, device: torch.device):
    """complex128 factors of the kernel spectra on ``device``: the one-sided
    H DFT on the KH taps (NBH, KH), the W DFT-64 on the KW taps (KW, 64) and
    the DFT-16 on the KD taps (16, KD)."""
    m = _mats_3d(h, 1, np.float64)
    fr, fi, wr, wi, dr, di = (torch.from_numpy(m[i]).to(device) for i in (0, 1, 2, 3, 6, 7))
    return (torch.complex(fr[:, :kh], fi[:, :kh]), torch.complex(wr[:kw], wi[:kw]),
            torch.complex(dr[:kd], di[:kd]).T.contiguous())


def _hw_spectra(kernel: torch.Tensor, h: int) -> torch.Tensor:
    """The per-tap 2D spectra of the (Cout, Cin/g, KD, KH, KW) kernel at the
    NBH one-sided H bins and the 64 W bins, (Cout, Cin/g, KD, NBH, 64)
    complex128, not conjugated."""
    _, _, kd, kh, kw = kernel.shape
    fh, fw, _ = _spectra_mats(h, kd, kh, kw, kernel.device)
    return (fh @ kernel.detach().to(torch.complex128)) @ fw


def kernel_spectra_3d(kernel: torch.Tensor, h: int) -> torch.Tensor:
    """Conjugated spectra of the (Cout, Cin/g, KD, KH, KW) kernel at the 16
    D-bins, the NBH one-sided H bins and the 64 W bins: (Cout, Cin/g, 16,
    NBH, 64) complex on the kernel's device, kernel B3's input. The port of
    the JAX package's ``_kernel_spectra_v4``, without its TPU lane packing.

    The three small transforms run in complex128 (over the weights only, and
    exact to float32 rounding whatever TF32 setting the caller chose); the
    result is complex128 for a float64 kernel and complex64 otherwise."""
    cout, cpg, kd, kh, kw = kernel.shape
    fd = _spectra_mats(h, kd, kh, kw, kernel.device)[2]
    b = _hw_spectra(kernel, h)                      # (Cout, Cin/g, KD, NBH, 64)
    out = torch.conj_physical(fd @ b.flatten(3)).reshape(cout, cpg, _DB, b.shape[3], _TW)
    return out if kernel.dtype == torch.float64 else out.to(torch.complex64)


def kernel_spectra_tap(kernel: torch.Tensor, h: int) -> torch.Tensor:
    """Conjugated per-tap 2D spectra of the (Cout, Cin/g, KD, KH, KW) kernel
    at the NBH one-sided H bins and the 64 W bins: (Cout, Cin/g, KD, NBH, 64)
    complex on the kernel's device, kernel B4's input. The port of the JAX
    package's ``_kernel_spectra_3d``, without its TPU packing (even taps and
    half-shifted "R" taps in 128 lanes).

    The H and W transforms run in complex128 over the weights only; the
    result is complex128 for a float64 kernel and complex64 otherwise."""
    out = torch.conj_physical(_hw_spectra(kernel, h))
    return out if kernel.dtype == torch.float64 else out.to(torch.complex64)


def _plan_for(x_shape, kernel_shape, groups: int, mode: Optional[str] = None):
    """(plan, nwb, hop) for a padded signal and a dilated kernel; raises
    ValueError where no plan fits, or where the plan is not of ``mode``
    ('v4' runs B3, 'tap' runs B4) when one is named."""
    _, cin, d, h, w = x_shape
    cout, cpg, kd, kh, kw = kernel_shape
    blocked = plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    if blocked is None:
        raise ValueError("no fused 3D configuration fits this shape")
    if mode is not None and blocked[0][0] != mode:
        raise ValueError(f"this shape plans '{blocked[0][0]}', not '{mode}'")
    return blocked


def _stack_w_blocks(x: torch.Tensor, starts) -> torch.Tensor:
    """(B, Cin, D, H, W) -> (B * nwb, Cin, D, H, <= 64): the W blocks that
    start at ``starts`` stacked into the batch."""
    if len(starts) == 1:
        return x
    b, cin, d, h, _ = x.shape
    x = torch.stack([x[..., s:s + _TW] for s in starts], dim=1)
    return x.reshape(b * len(starts), cin, d, h, _TW)


def _pack3d_reference(x_padded: torch.Tensor, pp: int, nwb: int, hop: int) -> torch.Tensor:
    """Kernel B6's plain PyTorch version: (B, Cin, D, H, W) -> xp (B * nwb,
    H, Cin·PP, 128), xp[b·nwb + j, h, c·PP + p, 64·s + w] = x[b, c, 2p + s,
    h, start_j + w], zeros past D and past W: the W blocks stacked, D padded
    to 2·PP and W to 64, and the d-pairs of each channel put side by side in
    the lanes, H outermost (the JAX package's pad, stack and
    ``_pack3d_call``)."""
    b, cin, d, h, w = x_padded.shape
    x = _stack_w_blocks(x_padded, _w_starts(w, nwb, hop))
    x = TF.pad(x, (0, _TW - x.shape[-1], 0, 0, 0, 2 * pp - d))
    x = x.reshape(b * nwb, cin, pp, 2, h, _TW).permute(0, 4, 1, 2, 3, 5)
    return x.reshape(b * nwb, h, cin * pp, 2 * _TW)


def _h_forward_pairs(x: torch.Tensor):
    """The factored H/W kernel's one-sided H DFT of real slabs ``x`` (...,
    D, H, C), H in ``_H_SPLITS``: slabs 2p and 2p+1 (zeros past D) packed as
    one complex column x_2p + i x_2p+1, its H-point DFT through the split
    ``_H_SPLITS[H]`` (``fourstep.dft_last``), and bins k and H - k split into
    the two slabs' rows k <= H/2. Returns (re, im), each (..., D, H/2+1, C)."""
    d, h = x.shape[-3], x.shape[-2]
    x = TF.pad(x, (0, 0, 0, 0, 0, d % 2)).transpose(-1, -2)   # (..., 2P, C, H)
    zr, zi = dft_last(x[..., 0::2, :, :], x[..., 1::2, :, :], _H_SPLITS[h], False)
    k = torch.arange(h // 2 + 1, device=x.device)
    m = (h - k) % h
    pr, pi, qr, qi = zr[..., k], zi[..., k], zr[..., m], zi[..., m]
    # X_2p = (Z[k] + conj Z[-k]) / 2, X_2p+1 = (Z[k] - conj Z[-k]) / 2i
    re = torch.stack([pr + qr, pi + qi], dim=-3).flatten(-4, -3) / 2
    im = torch.stack([pi - qi, qr - pr], dim=-3).flatten(-4, -3) / 2
    return re[..., :d, :, :].transpose(-1, -2), im[..., :d, :, :].transpose(-1, -2)


def _h_inverse_pairs(er: torch.Tensor, ei: torch.Tensor, h: int, oh: int) -> torch.Tensor:
    """The factored H/W kernel's H irfft of one-sided slabs (..., OD, H/2+1,
    C), H in ``_H_SPLITS``, onto the rows [0, oh): slabs 2p and 2p+1 (zeros
    past OD) at once, as one conjugated H-point DFT of E_2p + i E_2p+1, each
    Hermitian-extended (E[H - k] = conj E[k], DC and Nyquist taken real as
    the dense irfft weights them), whose real and imaginary parts are the
    two slabs' rows; 1/H applied. Returns (..., OD, oh, C)."""
    od = er.shape[-3]
    pad = (0, 0, 0, 0, 0, od % 2)
    er, ei = TF.pad(er, pad).transpose(-1, -2), TF.pad(ei, pad).transpose(-1, -2)
    k = torch.arange(h, device=er.device)
    kk = torch.minimum(k, h - k)
    ar, ai = er[..., 0::2, :, kk], ei[..., 0::2, :, kk]   # (..., P, C, H)
    br, bi = er[..., 1::2, :, kk], ei[..., 1::2, :, kk]
    real = (k == 0) | (k == h // 2)
    low = k < h // 2
    vr = torch.where(real, ar, torch.where(low, ar - bi, ar + bi))
    vi = torch.where(real, br, torch.where(low, ai + br, br - ai))
    outr, outi = dft_last(vr, vi, _H_SPLITS[h], True)  # (..., P, C, H)
    out = torch.stack([outr[..., :oh], outi[..., :oh]], dim=-3).flatten(-4, -3)
    return out[..., :od, :, :].transpose(-1, -2) / h


def _hw_forward_reference(x: torch.Tensor, fr, fi, packed=None):
    """(re, im) of the one-sided H DFT (``_h_forward_pairs`` for H in
    ``_H_SPLITS``, else the dense product with ``fr``, ``fi``) and then the W
    DFT-64 (factored 8 x 8, ``fourstep.dft_last``, bins in natural order) of
    every d-slab of the stacked blocks (W zero-padded to 64): (B', Cin, D,
    NBH, 64).

    ``x`` is the stacked blocks (B', Cin, D, H, <= 64); with ``packed`` =
    (Cin, D) it is B6's layout (B', H, Cin·PP, 128) instead, read slab by
    slab as B3 reads it: slab d of channel c is row c·PP + d // 2, lanes
    64·(d % 2) + [0, 64)."""
    if packed is None:
        x = TF.pad(x, (0, _TW - x.shape[-1]))
    else:
        cin, d = packed
        bb, h, rows, _ = x.shape
        x = x.reshape(bb, h, cin, rows // cin, 2, _TW).permute(0, 2, 3, 4, 1, 5)
        x = x.reshape(bb, cin, 2 * (rows // cin), h, _TW)[:, :, :d].contiguous()
    if x.shape[-2] in _H_SPLITS:
        ar, ai = _h_forward_pairs(x)
    else:
        ar, ai = fr @ x, fi @ x
    return dft_last(ar, ai, _W_SPLIT, False)


def _hw_inverse_reference(zr, zi, cr, ci, blocks, h: int, ow: int) -> torch.Tensor:
    """The inverse W DFT (factored 8 x 8, 1/64 included) and the H irfft
    (``_h_inverse_pairs`` for H in ``_H_SPLITS``, else the dense product
    with ``cr``, ``ci``) on the valid rows of the MAC's output (B', Cout, OD,
    NBH, 64), and the stored columns of each W block put side by side: (B,
    Cout, OD, OH, OW)."""
    e_r, e_i = dft_last(zr, zi, _W_SPLIT, True)
    e_r, e_i = e_r / _TW, e_i / _TW
    if h in _H_SPLITS:                              # (B', Cout, OD, OH, 64)
        out = _h_inverse_pairs(e_r, e_i, h, cr.shape[0])
    else:
        out = cr @ e_r + ci @ e_i
    if len(blocks) == 1:
        return out[..., :ow]
    out = out.reshape(-1, len(blocks), *out.shape[1:])
    return torch.cat([out[:, i, ..., lo:hi] for i, (_, lo, hi) in enumerate(blocks)], dim=-1)


def _fused3d_forward_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None, packed: bool = False,
) -> torch.Tensor:
    """Kernel B3's plain PyTorch version: the same blocked pipeline in split
    re/im arithmetic, float64 for a float64 signal and float32 otherwise.

    ``x_padded`` (B, Cin, D, H, W) already padded, ``kernel`` (Cout, Cin/g,
    KD, KH, KW) already dilated, and a 'v4' plan; returns the valid
    correlation (B, Cout, OD, OH, OW). W wider than 64 runs as stacked
    overlap-save blocks. ``spectra``: the baked ``kernel_spectra_3d``, or
    None to compute them. ``packed``: pack the signal first
    (``_pack3d_reference``, B6) and read the packed layout, as B3 does
    under "pk".
    """
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    b, cin, d, h, w = x_padded.shape
    cout, cpg, kd, kh, kw = kernel.shape
    plan, nwb, hop = _plan_for(x_padded.shape, kernel.shape, groups, "v4")
    nbh, nbd = plan[1], plan[4]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    blocks = _w_blocks(w, ow, nwb, hop)
    fr, fi, dr, di, er, ei, cr, ci = _torch_mats(h, oh, dt, x_padded.device)

    # one-sided H DFT, then the W DFT-64, per d-slab; D to the NBD + 1
    # chunks of 8 slabs that the blocks read (zeros past D)
    if packed:
        xp = _pack3d_reference(x_padded.to(dt), plan[3], nwb, hop)
        tr, ti = _hw_forward_reference(xp, fr, fi, packed=(cin, d))
    else:
        x = _stack_w_blocks(x_padded.to(dt), [s for s, _, _ in blocks])
        tr, ti = _hw_forward_reference(x, fr, fi)
    dpad = (0, 0, 0, 0, 0, _DHOP * (nbd + 1) - d)
    tr, ti = TF.pad(tr, dpad), TF.pad(ti, dpad)
    # D: blocks of 16 slabs on a hop of 8, a DFT-16 each
    tr = tr.unfold(2, _DB, _DHOP)                   # (B', Cin, NBD, NBH, 64, 16)
    ti = ti.unfold(2, _DB, _DHOP)
    sr = (tr @ dr - ti @ di).permute(0, 1, 2, 5, 3, 4)  # (B', Cin, NBD, 16, NBH, 64)
    si = (tr @ di + ti @ dr).permute(0, 1, 2, 5, 3, 4)

    # pointwise complex MAC over each out-channel's group of in-channels
    ks = _spectra_or(spectra, dt, lambda: kernel_spectra_3d(kernel.to(dt), h))
    kr = ks.real.reshape(groups, cout // groups, cpg, _DB, nbh, _TW)
    ki = ks.imag.reshape(groups, cout // groups, cpg, _DB, nbh, _TW)
    bb = b * nwb
    sr = sr.reshape(bb, groups, cpg, nbd, _DB, nbh, _TW)
    si = si.reshape(bb, groups, cpg, nbd, _DB, nbh, _TW)
    mac = "bgcjfnz,gocfnz->bgojfnz"
    yr = torch.einsum(mac, sr, kr) - torch.einsum(mac, si, ki)
    yi = torch.einsum(mac, sr, ki) + torch.einsum(mac, si, kr)

    # inverse DFT-16 on the 8 valid d of each block
    inv = "qf,bgojfnz->bgojqnz"
    zr = torch.einsum(inv, er, yr) - torch.einsum(inv, ei, yi)
    zi = torch.einsum(inv, er, yi) + torch.einsum(inv, ei, yr)
    zr = zr.reshape(bb, cout, nbd * _DHOP, nbh, _TW)[:, :, :od]
    zi = zi.reshape(bb, cout, nbd * _DHOP, nbh, _TW)[:, :, :od]
    return _hw_inverse_reference(zr, zi, cr, ci, blocks, h, ow)


def _fused3d_tap_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B4's plain PyTorch version: the same pipeline in split re/im
    arithmetic, float64 for a float64 signal and float32 otherwise.

    ``x_padded`` (B, Cin, D, H, W) already padded, ``kernel`` (Cout, Cin/g,
    KD, KH, KW) already dilated, and a 'tap' plan; returns the valid
    correlation (B, Cout, OD, OH, OW). W wider than 64 runs as stacked
    overlap-save blocks. ``spectra``: the baked ``kernel_spectra_tap``, or
    None to compute them.
    """
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    b, cin, d, h, w = x_padded.shape
    cout, cpg, kd, kh, kw = kernel.shape
    plan, nwb, hop = _plan_for(x_padded.shape, kernel.shape, groups, "tap")
    nbh = plan[1]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    blocks = _w_blocks(w, ow, nwb, hop)
    fr, fi, _, _, _, _, cr, ci = _torch_mats(h, oh, dt, x_padded.device)

    # one-sided H DFT, then the W DFT-64, per d-slab
    x = _stack_w_blocks(x_padded.to(dt), [s for s, _, _ in blocks])
    tr, ti = _hw_forward_reference(x, fr, fi)
    # D stays in the tap domain: the KD slabs from each valid d on
    bb = b * nwb
    tr = tr.reshape(bb, groups, cpg, d, nbh, _TW).unfold(3, kd, 1)  # (B', g, Cin/g, OD, NBH, 64, KD)
    ti = ti.reshape(bb, groups, cpg, d, nbh, _TW).unfold(3, kd, 1)

    # correlation over the taps and the group's in-channels, per (h, w) bin
    ks = _spectra_or(spectra, dt, lambda: kernel_spectra_tap(kernel.to(dt), h))
    kr = ks.real.reshape(groups, cout // groups, cpg, kd, nbh, _TW)
    ki = ks.imag.reshape(groups, cout // groups, cpg, kd, nbh, _TW)
    mac = "bgcdnzt,goctnz->bgodnz"
    yr = torch.einsum(mac, tr, kr) - torch.einsum(mac, ti, ki)
    yi = torch.einsum(mac, tr, ki) + torch.einsum(mac, ti, kr)
    yr = yr.reshape(bb, cout, od, nbh, _TW)
    yi = yi.reshape(bb, cout, od, nbh, _TW)
    return _hw_inverse_reference(yr, yi, cr, ci, blocks, h, ow)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused3d")
    if lib.fused3d_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused3d_forward.argtypes = [p] * 12 + [i] * 15 + [p]
        lib.fused3d_forward.restype = i
        lib.fused3d_pack.argtypes = [p] * 2 + [i] * 8 + [p]
        lib.fused3d_pack.restype = i
        lib.fused3d_tap_forward.argtypes = [p] * 9 + [i] * 14 + [p]
        lib.fused3d_tap_forward.restype = i
        lib.fused3d_error_string.argtypes = [i]
        lib.fused3d_error_string.restype = ctypes.c_char_p
        lib.fused3d_smem_bytes.argtypes = [i]
        lib.fused3d_smem_bytes.restype = ctypes.c_longlong
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for the entry points, None (NULL) for an
    argument the kernels that run do not read."""
    return None if t is None else t.data_ptr()


def _check_launch_inputs(x_padded: torch.Tensor, spectra: torch.Tensor, what: str) -> None:
    if not (x_padded.is_cuda and spectra.device == x_padded.device):
        raise ValueError(f"{what} kernel: signal and spectra must be on one CUDA device")
    if x_padded.dtype != torch.float32 or spectra.dtype != torch.complex64:
        raise ValueError(f"{what} kernel takes a float32 signal and complex64 spectra")


def _raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fused3d_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


def _launch_pack3d(
    x_padded: torch.Tensor, pp: int, nwb: int, hop: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Runs kernel B6 on ``x_padded`` (B, Cin, D, H, W) float32 on a CUDA
    device: returns xp (B * nwb, H, Cin·PP, 128) float32, the layout of
    ``_pack3d_reference``, written into ``out`` when one is given."""
    global launches_pack
    if not x_padded.is_cuda or x_padded.dtype != torch.float32:
        raise ValueError("fused3d pack kernel takes a float32 signal on a CUDA device")
    x_padded = x_padded.contiguous()
    b, cin, d, h, w = x_padded.shape
    shape = (b * nwb, h, cin * pp, 2 * _TW)
    if out is None:
        out = torch.empty(shape, device=x_padded.device, dtype=torch.float32)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != x_padded.device or not out.is_contiguous()):
        raise ValueError(f"fused3d pack kernel: out must be a contiguous float32 {shape} "
                         f"on {x_padded.device}")
    lib = _library()
    with torch.cuda.device(x_padded.device):
        err = lib.fused3d_pack(
            x_padded.data_ptr(), out.data_ptr(), b, cin, d, h, w, pp, nwb, hop,
            torch.cuda.current_stream(x_padded.device).cuda_stream,
        )
    _raise_on_error(lib, err, "fused3d pack")
    launches_pack += 1
    return out


def _launch_fused3d(
    x_padded: torch.Tensor, spectra: torch.Tensor, groups: int, k: Tuple[int, int, int],
    packed: bool = False,
) -> torch.Tensor:
    """Runs kernel B3's chain on ``x_padded`` (B, Cin, D, H, W) float32 with
    the conjugated spectra (Cout, Cin/g, 16, NBH, 64) complex64 of a (KD, KH,
    KW) kernel whose plan is 'v4', both on one CUDA device. Returns the valid
    correlation (B, Cout, OD, OH, OW). ``packed``: pack the signal with
    kernel B6 first and let B3 read the packed layout ("pk")."""
    global launches
    _check_launch_inputs(x_padded, spectra, "fused3d")
    x_padded = x_padded.contiguous()
    spectra = spectra.contiguous()
    b, cin, d, h, w = x_padded.shape
    cout, cpg = spectra.shape[:2]
    plan, nwb, hop = _plan_for(x_padded.shape, (cout, cpg) + tuple(k), groups, "v4")
    nbh, nbd = plan[1], plan[4]
    if spectra.shape[2:] != (_DB, nbh, _TW) or cpg * groups != cin:
        raise ValueError(f"fused3d kernel: spectra {tuple(spectra.shape)} do not fit "
                         f"H={h}, Cin={cin}, groups={groups}")
    kd, kh, kw = k
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    items = b * nwb
    # (batch, W-block) items per launch: as many as the scratch budget holds
    # (the plan has checked that one does)
    per_item = _scratch_bytes_per_item(cin, cout, d, nbh, nbd, od)
    chunk = max(1, min(items, _SCRATCH_BUDGET // per_item))

    lib = _library()
    pp = plan[3] if packed else 0
    x = _launch_pack3d(x_padded, pp, nwb, hop) if packed else x_padded
    mats = _device_mats(h, oh, x_padded.device)
    dev, c64 = x_padded.device, torch.complex64
    out = torch.empty((b, cout, od, oh, ow), device=dev, dtype=torch.float32)
    t = torch.empty((chunk, cin, d, nbh, _TW), device=dev, dtype=c64)
    s = torch.empty((chunk, cin, nbd, _DB, nbh, _TW), device=dev, dtype=c64)
    z = torch.empty((chunk, cout, od, nbh, _TW), device=dev, dtype=c64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for item0 in range(0, items, chunk):
            err = lib.fused3d_forward(
                x.data_ptr(), spectra.data_ptr(), *(_ptr(m) for m in mats),
                t.data_ptr(), s.data_ptr(), z.data_ptr(), out.data_ptr(),
                cin, cout, groups, d, h, w, od, oh, ow, nbd, nwb, hop,
                item0, min(chunk, items - item0), pp, stream,
            )
            _raise_on_error(lib, err, "fused3d")
            launches += 1
    return out


def _launch_fused3d_tap(
    x_padded: torch.Tensor, spectra: torch.Tensor, groups: int, k: Tuple[int, int, int]
) -> torch.Tensor:
    """Runs kernel B4's chain on ``x_padded`` (B, Cin, D, H, W) float32 with
    the conjugated per-tap spectra (Cout, Cin/g, KD, NBH, 64) complex64 of a
    (KD, KH, KW) kernel whose plan is 'tap', both on one CUDA device.
    Returns the valid correlation (B, Cout, OD, OH, OW)."""
    global launches_tap
    _check_launch_inputs(x_padded, spectra, "fused3d tap")
    x_padded = x_padded.contiguous()
    spectra = spectra.contiguous()
    b, cin, d, h, w = x_padded.shape
    cout, cpg = spectra.shape[:2]
    kd, kh, kw = k
    plan, nwb, hop = _plan_for(x_padded.shape, (cout, cpg) + tuple(k), groups, "tap")
    nbh = plan[1]
    if spectra.shape[2:] != (kd, nbh, _TW) or cpg * groups != cin:
        raise ValueError(f"fused3d tap kernel: spectra {tuple(spectra.shape)} do not fit "
                         f"KD={kd}, H={h}, Cin={cin}, groups={groups}")
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    items = b * nwb
    per_item = _tap_scratch_bytes_per_item(cin, cout, d, nbh, od)
    chunk = max(1, min(items, _SCRATCH_BUDGET // per_item))

    lib = _library()
    fh, wfac, hfac, _, _, ch = _device_mats(h, oh, x_padded.device)
    dev, c64 = x_padded.device, torch.complex64
    out = torch.empty((b, cout, od, oh, ow), device=dev, dtype=torch.float32)
    t = torch.empty((chunk, cin, d, nbh, _TW), device=dev, dtype=c64)
    z = torch.empty((chunk, cout, od, nbh, _TW), device=dev, dtype=c64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for item0 in range(0, items, chunk):
            err = lib.fused3d_tap_forward(
                x_padded.data_ptr(), spectra.data_ptr(), _ptr(fh), _ptr(wfac), _ptr(hfac),
                _ptr(ch), t.data_ptr(), z.data_ptr(), out.data_ptr(),
                cin, cout, groups, d, h, w, kd, od, oh, ow, nwb, hop,
                item0, min(chunk, items - item0), stream,
            )
            _raise_on_error(lib, err, "fused3d tap")
            launches_tap += 1
    return out


def _fused3d_forward(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
):
    """Valid correlation of ``x_padded`` with ``kernel`` through the plan's
    kernels (B3 for 'v4', after B6 under "pk"; B4 for 'tap') on a CUDA
    tensor, through their plain versions on a CPU one. ``spectra``: the
    plan's baked kernel spectra (``kernel_spectra_3d`` for 'v4',
    ``kernel_spectra_tap`` for 'tap'), or None to compute them. They are
    computed here, ahead of the call's records for a running cost analysis
    (``costs.record``), so that the analysis counts their transforms as the
    aten ops they are, on the CPU as on the card; the records hold the
    kernels' own counts (B6's too under "pk"), whichever of the kernels and
    plain versions run."""
    if x_padded.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused3d runs on CUDA or CPU tensors, got {x_padded.device}")
    plan, nwb, _ = _plan_for(x_padded.shape, kernel.shape, groups)
    tap = plan[0] == "tap"
    packed = not tap and _XPACK3D == "pk"
    b, cin, d, h, w = x_padded.shape
    k = tuple(kernel.shape[2:])
    if spectra is None:
        spectra = kernel_spectra_tap(kernel, h) if tap else kernel_spectra_3d(kernel, h)
    record = pack = costs.IDLE
    if costs.active():
        shape = (b, cin, kernel.shape[0], d, h, w, k, groups)
        if tap:
            record = costs.record("B4", costs.fused3d_tap_kernel_flops(*shape),
                                  costs.fused3d_tap_work(*shape)[0])
        else:
            record = costs.record("B3", costs.fused3d_kernel_flops(*shape),
                                  costs.fused3d_work(*shape)[0])
        if packed:
            pack = costs.record("B6", 0, costs.pack3d_bytes(b, cin, d, h, w, plan[3], nwb))
    with record, pack:
        if x_padded.is_cuda:
            if tap:
                return _launch_fused3d_tap(x_padded.float(), spectra, groups, k)
            return _launch_fused3d(x_padded.float(), spectra, groups, k, packed)
        if tap:
            return _fused3d_tap_reference(x_padded.float(), kernel.float(), groups, spectra)
        return _fused3d_forward_reference(x_padded.float(), kernel.float(), groups, spectra,
                                          packed)


class _Fused3dCore(torch.autograd.Function):
    """The fused 3D correlation with the composed path as its backward;
    ``spectra`` are a plan's baked kernel spectra (None: computed per call)."""

    @staticmethod
    def forward(ctx, x_padded, kernel, groups, spectra=None):
        ctx.save_for_backward(x_padded, kernel)
        ctx.groups = groups
        return _fused3d_forward(x_padded, kernel, groups, spectra)

    @staticmethod
    def backward(ctx, g):
        x_padded, kernel = ctx.saved_tensors
        dx, dw = _fused_bwd(
            x_padded, kernel, g.contiguous(), ctx.groups,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1],
        )
        return dx, dw, None, None


def fft_conv3d_fused(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    padding_mode: str = "constant",
    stride=1,
    dilation=1,
    groups: int = 1,
) -> torch.Tensor:
    """Fused 3D FFT convolution, ``ops.fft_conv`` semantics.

    Padding modes, stride, dilation and groups are wrapper transforms
    around the unit-stride kernel, as in the 1D and 2D functions; W wider
    than 64 runs as overlap-save W blocks. A 'v4' plan runs kernel B3, a
    'tap' plan kernel B4. Raises ValueError when no fused configuration
    fits (unlike the JAX function it does not fall back).
    """
    out = fft_conv3d_fused_if_fits(
        signal, kernel, bias, padding, padding_mode, stride, dilation, groups
    )
    if out is None:
        raise ValueError(
            "no fused 3D FFT configuration fits this shape (W blocks wider "
            "than 64, or the spectra, the shared memory or the scratch exceed "
            "the kernels' budgets); use fft_conv(impl='xla')"
        )
    return out


def fft_conv3d_fused_if_fits(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    padding_mode: str = "constant",
    stride=1,
    dilation=1,
    groups: int = 1,
    w_blocks: bool = True,
) -> Optional[torch.Tensor]:
    """``fft_conv3d_fused``, or None when ``plan_3d_blocked`` finds no plan
    for the padded signal and the dilated kernel, or when the plan cuts W
    into blocks and ``w_blocks`` is False (``fft_conv(impl="auto")`` fuses
    single-block plans only, as the JAX package does). The one place where
    the gate is checked, for both the fused function and
    ``fft_conv(impl="auto")``."""
    if signal.ndim != 5 or kernel.ndim != 5:
        raise ValueError(
            "fft_conv3d_fused expects (B, Cin, D, H, W) and (Cout, Cin/g, KD, KH, KW)"
        )
    padding_ = to_ntuple(padding, 3)
    stride_ = to_ntuple(stride, 3)
    kernel = F._dilate_kernel(kernel, to_ntuple(dilation, 3))
    x = F._pad_signal(signal, padding_, padding_mode)
    b, cin, d, h, w = x.shape
    cout, cpg, kd, kh, kw = kernel.shape
    if cpg * groups != cin:
        raise ValueError(
            f"kernel Cin/groups {cpg} x groups {groups} != signal Cin {cin}"
        )
    if cout % groups:
        raise ValueError(f"out_channels {cout} not divisible by groups {groups}")
    if kd > d or kh > h or kw > w:
        raise ValueError("Kernel size can't be greater than actual input size")
    blocked = plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    if blocked is None or (blocked[1] > 1 and not w_blocks):
        return None
    out = _Fused3dCore.apply(x.float(), kernel.float(), groups)
    if stride_ != (1, 1, 1):
        out = out[:, :, ::stride_[0], ::stride_[1], ::stride_[2]]
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out.to(signal.dtype)


def fft_conv_transpose3d_fused(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    stride=1,
    dilation=1,
    groups: int = 1,
    output_padding=0,
) -> torch.Tensor:
    """Fused 3D transposed convolution, ``ops.fft_conv_transpose`` semantics.

    ``fft_conv3d_fused`` on the zero-stuffed signal
    (``F._fused_transpose``). Its volume is wider than 64 at usual shapes
    (78^3 at 64^3, K=8), so the W blocks carry it. Raises ValueError where
    no fused plan fits.
    """
    if signal.ndim != 5 or kernel.ndim != 5:
        raise ValueError(
            "fft_conv_transpose3d_fused expects (B, Cin, D, H, W) and "
            "(Cin, Cout/g, KD, KH, KW)"
        )
    return F._fused_transpose(
        signal, kernel, bias, to_ntuple(padding, 3), to_ntuple(stride, 3),
        to_ntuple(dilation, 3), groups, to_ntuple(output_padding, 3),
        lambda x, w, g: fft_conv3d_fused(x, w, groups=g),
    )


def plan_fft_conv3d(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    padding_mode: str = "constant",
    *,
    signal_dhw,
    device: Device = None,
):
    """Serving plan: the kernel's spectra for the plan's kernel (B3's for
    'v4', B4's for 'tap') are computed once, on ``device`` (the card unless
    ``device="cpu"``), and the returned ``fn(signal) -> out`` only
    transforms the signal, whose spatial shape must be ``signal_dhw``. The
    port of the JAX package's ``plan_fft_conv3d``: groups=1, stride=1,
    dilation=1; W wider than 64 runs in W blocks, which share the spectra.
    Raises ValueError where no fused plan fits. The signal's gradient flows
    through the composed path; the baked kernel is a constant."""
    if kernel.ndim != 5:
        raise ValueError("plan_fft_conv3d expects (Cout, Cin, KD, KH, KW)")
    dev = resolve_device(device, "plans are built")
    padding_ = to_ntuple(padding, 3)
    d, h, w = (int(s) for s in signal_dhw)
    cout, cin, kd, kh, kw = kernel.shape
    dp, hp, wp = d + 2 * padding_[0], h + 2 * padding_[1], w + 2 * padding_[2]
    if kd > dp or kh > hp or kw > wp:
        raise ValueError("Kernel size can't be greater than actual input size")
    blocked = plan_3d_blocked(cin, cout, dp, hp, wp, kd, kh, kw)
    if blocked is None:
        raise ValueError("no fused 3D configuration fits this shape")
    kernel = kernel.detach().to(dev, torch.float32)
    bias = None if bias is None else bias.detach().to(dev, torch.float32)
    spectra_of = kernel_spectra_3d if blocked[0][0] == "v4" else kernel_spectra_tap
    spectra = spectra_of(kernel, hp)

    def planned(signal: torch.Tensor) -> torch.Tensor:
        check_planned_signal(signal, (d, h, w), dev)
        x = F._pad_signal(signal, padding_, padding_mode)
        out = _Fused3dCore.apply(x.float(), kernel, 1, spectra)
        if bias is not None:
            out = out + bias.reshape(1, -1, 1, 1, 1)
        return out.to(signal.dtype)

    return planned
