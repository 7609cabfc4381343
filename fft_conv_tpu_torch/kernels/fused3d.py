"""Fused 3D FFT convolution: host side of the CUDA kernels ``csrc/fused3d.cu``.

The port's counterpart of ``fft_conv_tpu/kernels/fused3d.py``, with both of
its plans. Either way the whole padded volume is transformed along H and W
per d-slab: a one-sided H DFT and a 64-point W DFT (W zero-padded to 64, or
cut into overlap-save blocks of 64 columns when W is wider), factored 64 =
8·8 as a four-step transform (``_w_factors``).

The H transforms run at a working length Hw (``_h_work``). For every H from
16 to 256 (``_H_FACTORED``) Hw is the least even length >= H that splits as
Hw = HA·HB with both factors at most 16 and HB even
(``fourstep.padded_split``): H itself where it splits (48 = 8·6, 78 = 13·6,
the powers of two as before), else a few rows more (82 -> 84 = 7·12, 200 ->
208 = 13·16; at most 1/8 of H, at H = 33). The signal's rows H to Hw - 1 are
zeros, and the H-circular correlation at Hw equals the linear one on the
valid rows h <= H - KH, since no stored row wraps; the spectra, T and Z
then hold Hw/2+1 one-sided bins. The H DFT and its inverse run factored on
slab pairs: two d-slabs packed as one complex column, one Hw-point DFT, bins
k and Hw - k split into the two slabs' rows (``_h_forward_pairs``), and a
c2r of two slabs at once (``_h_inverse_pairs``). Outside that range (H <
16, 256 < H <= 906) Hw = H and the H transforms are dense products. Along
D:

* 'v4' (kernel B3, the JAX package's plan for KD <= 9): a DFT-16 per block
  of 16 samples on a hop of 8 (zeros past D), factored 16 = 4·4
  (``_D_SPLIT``). The MAC over each group's input channels against the
  conjugated kernel spectra is then a pointwise product, and the inverse
  DFT-16, factored alike, keeps the 8 valid d of each block.
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

The inline switch (``set_fused3d_inline``, off by default as in the JAX
package) makes an unplanned 'v4' call compute its kernel spectra from the
raw taps with kernel B7 (``fused3d_spectra_v4``: the W DFT-64, the
one-sided H DFT at Hw and the conjugated DFT-16 of the taps, FP32, twiddles
from float64 tables), launched at the head of B3's chain, in place of the
complex128 torch transforms of ``kernel_spectra_3d``; on a CPU tensor its
plain version ``_spectra_v4_reference`` runs. Plans (baked spectra) and
'tap' calls never take it, nor does a shape outside ``_inline_fits_v4``.

The precision switch (``set_fused3d_precision``, read at every 3D call,
on every route: ``auto``, the fused and transposed functions, plans, the
layers, "pk", inline and sharded calls) picks how B3 and B4 form their DFT
products, as the JAX package's switch of that name does. "highest" (the
default here; "bf16x3" in JAX) runs the FP32 kernels above. "bf16x3" and
"bf16" run the tensor-core kernels of ``csrc/fused3d.cu``
(``fused3d_forward_tc``, ``fused3d_tap_forward_tc``): every DFT step a bf16
``mma.sync`` product (three of hi/lo splits, or one) through
``csrc/bf16_mma.cuh``, on the factors of the working length (each H radix r
as an 8- or 16-point step with the r-point DFT in its corner; W 8·8) and,
in B3, the DFT-16 and its inverse onto the 8 valid d as one dense 16-point
step each; the twiddles, the bin splits, the Hermitian extension, the MACs
(B4's tap MAC too) and the scales stay FP32. For H < 16 the H DFT is one
H-point step on slab pairs at Hw = H; an H past 256 raises ValueError under
a bf16 mode, on every fused route (``fft_conv(impl="auto")`` on a CUDA
tensor included, whose gate does not read the mode). On a CPU tensor the plain versions run the tensor-core
kernels' order (``mode=``), each product rounding its operands through
``fused1d._DOTS[mode]``; B7 and B4's tap MAC are FP32 in every mode, as in
the JAX package.

Not ported from the JAX module: the TPU's MAC and staging switches: the
port's kernels run one schedule each.
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
from .fourstep import _factor_tensors, dft_last, fft_factor_matrices, padded_split, split_factors
from .fused1d import PRECISION_MODES, _DOTS, _TC_MODE, _b_fragments, _fused_bwd, _spectra_or

# W transform length and its four-step split 64 = 8 * 8 (the kernels factor
# the W DFT so), and the D blocks: 16 samples on a hop of 8
_TW = 64
_W_SPLIT = (8, 8)
# The signal H whose transforms the kernels factor at a working length
# (``_h_work``), slab pairs through one complex transform each; every other
# H keeps the dense products
_H_FACTORED = (16, 256)
_DB = 16
_DHOP = 8
# The four-step split of the D DFT-16 (csrc/fused3d.cu: kDF)
_D_SPLIT = split_factors(_DB)
# B3's D kernel's most output channels a block (csrc/fused3d.cu: kDOpb; it
# takes the most of 8, 4, 2, 1 within it that divides a group's
# out-channels, ``_opb``) and the tap MAC's valid d a thread (kTapDC)
_D_OPB = 8
_TAP_DC = 8
# the tensor-core D kernel's most output channels a block (csrc/fused3d.cu:
# kDOpbTc)
_D_OPB_TC = 4
# B7's one-sided H bins a block (csrc/fused3d.cu: kSpecNB)
_SPEC_NB = 8

# The JAX package bounds its TPU cell by VMEM budgets (resident spectra of
# 24 MiB, a whole-volume cell of 96 MiB for v4 and 80 MiB for tap). These
# kernels keep no volume in shared memory: their blocks hold a few d-slabs
# of NBH x 64 complex values. Their own limits are:
#   * the conjugated kernel spectra, v4's (Cout, Cin/g, 16, NBH, 64) and
#     tap's (Cout, Cin/g, KD, NBH, 64) complex, which each D kernel block
#     stages in shared memory for its bins and output channels. Kept within
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
#     H/W spectra T (Cin, D, NBH, 64) and the MAC's output Z (Cout, OD, NBH,
#     64), complex. The wrappers run the items in ranges under this budget,
#     so one item must fit. For v4 it also counts the DFT-16 block spectra
#     S (Cin, NBD, 16, NBH, 64), though B3 keeps them in registers: the
#     plans that the JAX-parity tests hold and the item ranges rest on it.
_SCRATCH_BUDGET = 256 * 2**20

# Launches since import or the last reset, one per range of items: of B3's
# chain of three kernels (v4 plans) and of B4's chain of three (tap plans);
# and of B6, one per call of a 'v4' plan under "pk". The plain versions on
# CPU tensors do not count.
launches = 0
launches_tap = 0
launches_pack = 0
# Launches of B7, one per inline call of a 'v4' plan on a CUDA tensor
launches_spectra = 0
# Launches of the tensor-core chains under "bf16x3" and "bf16", one per
# range of items: B3's ('v4' plans) and B4's ('tap' plans). The FP32
# counters above do not move under those modes, nor these under "highest".
launches_tc = 0
launches_tap_tc = 0

# How B3 and B4 form their DFT products (set_fused3d_precision), one of
# PRECISION_MODES: "highest" FP32, "bf16x3" three bf16 products of hi/lo
# splits (lo.lo dropped), "bf16" one. _fused3d_forward reads it at every
# call.
_PRECISION_3D = "highest"
# The largest signal H the tensor-core kernels take (a working length of two
# factors <= 16); past it a bf16 mode raises
_TC_H_MAX = _H_FACTORED[1]


def set_fused3d_precision(mode: str) -> None:
    """Selects how the fused 3D kernels B3 and B4 form their DFT products,
    read at every 3D call: "highest" (FP32, the FP32 kernels), "bf16x3"
    (bf16 tensor-core products of hi/lo splits, three a product, near FP32)
    or "bf16" (one bf16 product, an opt-in serving mode outside the FP32
    bar). Any other name raises ValueError. Independent of the 1D and 2D
    kernels' switches. The port of the JAX package's
    ``set_fused3d_precision`` (``fft_conv_tpu/kernels/fused3d.py:107``),
    whose default is "bf16x3"; this one's is "highest". Under a bf16 mode a
    signal H past 256 raises ValueError (no three-factor H transform yet),
    ``fft_conv(impl="auto")`` on a CUDA tensor included."""
    global _PRECISION_3D
    if mode not in PRECISION_MODES:
        raise ValueError(f"unknown fused precision mode: {mode!r}")
    _PRECISION_3D = mode

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


# Whether an unplanned 'v4' call computes its kernel spectra with kernel B7
# (``_inline_fits_v4`` permitting); _fused3d_forward reads it at call time.
# Off by default, as in the JAX package.
_INLINE3D = False


def set_fused3d_inline(on: bool) -> None:
    """Toggles the in-kernel spectra of 'v4' calls: on, an unplanned 'v4'
    call whose shape passes ``_inline_fits_v4`` computes its kernel spectra
    from the raw taps with kernel B7 (its plain version on a CPU tensor)
    instead of ``kernel_spectra_3d``; plans and 'tap' calls are unchanged.
    Both compute the same function."""
    global _INLINE3D
    _INLINE3D = bool(on)


def _tap_counts(kd: int) -> Tuple[int, int]:
    """(ME, MR): even-tap count and R-tap count (0 when KD has no odd taps),
    as the JAX package's tap kernel splits the D taps."""
    me = (kd + 1) // 2
    mo = kd // 2
    return me, (mo + 1) if mo else 0


def _opb(opg: int, most: int) -> int:
    """The output channels one block of a D kernel takes: the most of 8, 4,
    2, 1, at most ``most``, that divides a group's ``opg`` out-channels
    (csrc/fused3d.cu: launch_opb)."""
    return next(n for n in (8, 4, 2, 1) if n <= most and opg % n == 0)


@lru_cache(maxsize=None)
def _h_work(h: int) -> Tuple[int, Optional[Tuple[int, int]]]:
    """(Hw, split): the working length of the H transforms for a signal of
    H rows and its four-step split (HA, HB), ``fourstep.padded_split`` for
    H in ``_H_FACTORED`` (csrc/fused3d.cu: fused3d_hw_forward_f); (H, None)
    outside it, where the dense kernels run at H."""
    lo, hi = _H_FACTORED
    return padded_split(h) if lo <= h <= hi else (h, None)


def _h_path(h: int) -> str:
    """Which H/W kernels an H runs: "factored" (``_H_FACTORED``) or "dense"."""
    return "dense" if _h_work(h)[1] is None else "factored"


def _nbh_work(h: int) -> int:
    """One-sided H bins of the kernels' spectra, T and Z: Hw/2+1."""
    return _h_work(h)[0] // 2 + 1


def _h_steps(h: int) -> Tuple[int, int]:
    """(HA, HB): the steps of the H DFT on slab pairs for a signal of H rows
    (the factored FP32 kernels' and the tensor-core kernels'), at the
    working length HA·HB = ``_h_work(h)[0]``: the split of ``_h_work`` for H
    from 16 to 256, and (H, 1), one dense H-point step, for H < 16 (the
    tensor-core kernels only). Raises ValueError past 256."""
    if h > _TC_H_MAX:
        raise ValueError(
            f"the fused 3D tensor-core kernels (precision modes 'bf16x3' and 'bf16') take "
            f"H <= {_TC_H_MAX}, got H={h}: a three-factor H transform is not built yet; "
            f"use set_fused3d_precision('highest')")
    split = _h_work(h)[1]
    return (h, 1) if split is None else split


def _dft_steps(xr: torch.Tensor, xi: torch.Tensor, split: Tuple[int, int], inverse: bool,
               dot=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unscaled DFT (inverse: conjugated) of the last axis, length A·B, as
    the tensor-core kernels run it: factored through ``fourstep.dft_last``
    for ``split`` = (A, B), or as one dense A-point product for B = 1. Each
    real product through ``dot`` (None: FP32 ``@``)."""
    if split[1] > 1:
        return dft_last(xr, xi, split, inverse, dot)
    fr, fi = _factor_tensors(split[0], 1, xr.dtype, xr.device)[:2]  # symmetric
    fi = -fi if inverse else fi
    mm = torch.matmul if dot is None else dot
    return mm(xr, fr) - mm(xi, fi), mm(xr, fi) + mm(xi, fr)


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
    """The JAX package's overlap-save-D geometry (nbh, nbhp, pp and vdp are
    its TPU layout's, kept so the plans compare equal) under kernel B3's
    budgets, counted at the Hw/2+1 bins the kernels hold (``_h_work``):
    spectra in L2, shared memory, scratch per item."""
    if kd > 9:
        return None  # a 16-sample block leaves 8 valid d only for kd <= 9
    nbh, nbw = h // 2 + 1, _nbh_work(h)
    nbhp = -(-nbh // 8) * 8
    vd = d - kd + 1
    nbd = -(-vd // 8)
    pp = -(-(4 * (nbd - 1) + 8) // 8) * 8
    vdp = -(-(4 * nbd) // 8) * 8
    if _DB * (cin // groups) * cout * nbw * _TW * 8 > _SPECTRA_BUDGET:
        return None
    if _slabs_per_block(nbw) is None:
        return None
    if _scratch_bytes_per_item(cin, cout, d, nbw, nbd, vd) > _SCRATCH_BUDGET:
        return None
    return ("v4", nbh, nbhp, pp, nbd, vdp)


def _plan_tap(cin: int, cout: int, d: int, h: int, w: int,
              kd: int, kh: int, kw: int, groups: int = 1):
    """The JAX package's tap geometry (vdp and pages are its TPU d-pair
    layout's, kept so the plans compare equal) under kernel B4's budgets,
    counted at the Hw/2+1 bins the kernels hold (``_h_work``): spectra in
    L2, shared memory, scratch per item."""
    nbh, nbw = h // 2 + 1, _nbh_work(h)
    vd = d - kd + 1
    if kd * (cin // groups) * cout * nbw * _TW * 8 > _SPECTRA_BUDGET:
        return None
    if _slabs_per_block(nbw) is None:
        return None
    if _tap_scratch_bytes_per_item(cin, cout, d, nbw, vd) > _SCRATCH_BUDGET:
        return None
    me, mr = _tap_counts(kd)
    vdp = -(-(-(-vd // 2)) // 8) * 8
    maxoff = max(me - 1, mr - 1 if mr else 0)
    wrows = -(-(8 + maxoff) // 8) * 8
    return ("tap", nbh, vdp, vdp - 8 + wrows)


def _spectra_smem_bytes(kd: int, kh: int, kw: int) -> int:
    """Shared memory of one block of kernel B7 (csrc/fused3d.cu:
    spectra_smem): the W roots as a (KW, 64) table, the H roots of the
    block's bins as a (KH, ``_SPEC_NB``) table and its partial spectra, KD x
    ``_SPEC_NB`` one-sided H bins x 64 W bins, complex; and the pair's
    float32 taps."""
    return (kw * _TW + kh * _SPEC_NB + kd * _SPEC_NB * _TW) * 8 + kd * kh * kw * 4


@lru_cache(maxsize=None)
def _inline_fits_v4(cin: int, cout: int, d: int, h: int, w: int,
                    kd: int, kh: int, kw: int, groups: int = 1) -> bool:
    """Whether an inline call may compute its spectra with kernel B7: the
    shape plans 'v4' (``plan_3d_blocked``: B3's budgets, W blocks included)
    and B7's block fits its shared memory (the pair's taps among it, so a
    kernel of more than about 50,000 taps a channel pair is refused). The
    JAX signature, with the port's limits in place of the TPU's VMEM cap:
    B7 writes the spectra that B3 then reads, at the size B3's plan admits,
    so the 64^3 K=8 8 -> 8 row runs inline here, where the JAX gate refuses
    it (133.74M of VMEM > 128M)."""
    blocked = plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    if blocked is None or blocked[0][0] != "v4":
        return False
    return _spectra_smem_bytes(kd, kh, kw) <= _SMEM_LIMIT


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
    kernel's dense H, float64 for the kernel spectra and for an oracle): H
    one-sided forward (NBH, H), W DFT-64 forward and inverse (64, 64), D
    DFT-16 forward (16, 16), the inverse DFT-16 rows of the 8 valid d (8, 16)
    with its 1/16, and the H irfft valid rows (VH, NBH)."""
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
    """``_mats_3d``'s dense H pairs (the kernels and their plain versions
    factor the W DFT-64 and the DFT-16: ``_w_factors``, ``_D_SPLIT``,
    ``fourstep.dft_last``) as torch tensors of ``dtype`` on ``device``, made
    once per device so that repeated calls copy nothing from the host: (fr,
    fi, cr, ci)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    m = _mats_3d(h, vh, npdt)
    return tuple(torch.from_numpy(m[i]).to(device) for i in (0, 1, 10, 11))


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


@lru_cache(maxsize=None)
def _device_mats(h: int, vh: int, device: torch.device):
    """The kernel's factors as interleaved complex64 tensors on ``device``,
    in the order of the entry points' arguments: F_H (NBH, H), the W factors
    (``_w_factors``, one slot that the forward and the inverse both read),
    the H factors (``_factor_vector`` of the split of ``_h_work(h)``, read
    alike), the DFT-16 factors (``_factor_vector`` of ``_D_SPLIT``, read
    alike, B3 only) and the irfft rows (VH, NBH) as (cr, ci) pairs. For an
    H the kernels factor F_H and the irfft rows are None (the factored
    kernels take the H factors), for any other H the H factors are."""
    dfac = _factor_vector(_D_SPLIT, device)
    split = _h_work(h)[1]
    if split is not None:
        return None, _w_factors(device), _factor_vector(split, device), dfac, None
    fr, fi, cr, ci = _torch_mats(h, vh, torch.float32, device)
    return torch.complex(fr, fi), _w_factors(device), None, dfac, torch.complex(cr, ci)


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


@lru_cache(maxsize=None)
def _spectra_roots(hw: int, device: torch.device) -> torch.Tensor:
    """The roots of unity of kernel B7's W and H transforms as one complex64
    vector of 64 + Hw on ``device``, built in float64 and then cast:
    exp(-2 pi i m / N) for m < N, N = 64 (W) and ``hw`` (H), in the order
    csrc/fused3d.cu reads them."""
    parts = [np.exp(-2j * np.pi * np.arange(n) / n) for n in (_TW, hw)]
    return torch.from_numpy(np.concatenate(parts).astype(np.complex64)).to(device)


def _tc_radix(r: int) -> int:
    """The step size R of the tensor-core kernels for an r-point DFT: 8 for
    r <= 8, else 16, the r x r matrix in the corner of the R x R one
    (csrc/bf16_mma.cuh: step_size)."""
    return 8 if r <= 8 else 16


@lru_cache(maxsize=None)
def _tc_fragments_3d(split: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """The tensor-core kernels' DFT matrices for the H split (HA, HB) of a
    call (``_h_steps``) as one int32 tensor on ``device``, in the order
    csrc/fused3d.cu reads them (bf16_mma.cuh: table_words): the HA-point
    DFT, then the HB-point DFT when HB > 1, each zero-padded to its step
    size (``_tc_radix``); then the W 8-point and the D 16-point DFTs; each
    forward and then conjugated, each as its hi and then its lo fragments
    (``fused1d._b_fragments``). Built in float64 (``fft_factor_matrices``)
    and rounded to float32 before the split, as the plain versions round
    them."""
    radices = [split[0]] + ([split[1]] if split[1] > 1 else []) + [_W_SPLIT[0], _DB]
    parts = []
    for r in radices:
        size = _tc_radix(r)
        f = np.zeros((size, size), complex)
        f[:r, :r] = fft_factor_matrices(r, 1)[0]
        for m in (f, np.conj(f)):
            parts += _b_fragments(m)
    return torch.from_numpy(np.concatenate(parts).view(np.int32)).to(device)


def _spectra_v4_reference(kernel: torch.Tensor, hw: int) -> torch.Tensor:
    """Kernel B7's plain PyTorch version: ``kernel_spectra_3d(kernel, hw)``
    computed as B7 computes it, in FP32 from the raw (Cout, Cin/g, KD, KH,
    KW) taps: the W DFT-64 of each (d, h) row of taps and the one-sided H
    DFT at ``hw`` of the KH rows, each a product with the roots of
    ``_spectra_roots`` taken at (bin · tap) mod N; then the DFT-16 of the KD
    taps (zeros past KD), factored 4 x 4 (``_D_SPLIT``,
    ``fourstep.dft_last``), and the conjugate. Returns (Cout, Cin/g, 16,
    hw/2+1, 64) complex64."""
    cout, cpg, kd, kh, kw = kernel.shape
    dev = kernel.device
    roots = _spectra_roots(hw, dev)
    nbh = hw // 2 + 1

    def table(rows: int, cols: int, n: int, rts: torch.Tensor) -> torch.Tensor:
        return rts[torch.outer(torch.arange(rows, device=dev), torch.arange(cols, device=dev)) % n]

    a = kernel.detach().float().to(torch.complex64) @ table(kw, _TW, _TW, roots[:_TW])  # W
    b = table(nbh, kh, hw, roots[_TW:]) @ a                   # H: (Cout, Cin/g, KD, NBH, 64)
    b = TF.pad(b.movedim(2, -1), (0, _DB - kd))               # D last, zeros past KD
    sr, si = dft_last(b.real, b.imag, _D_SPLIT, False)
    return torch.complex(sr, -si).movedim(-1, 2).contiguous()


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


def _h_forward_pairs(x: torch.Tensor, hw: Optional[int] = None, dot=None):
    """The factored H/W kernel's one-sided H DFT of real slabs ``x`` (...,
    D, H, C) at the working length ``hw`` (default ``_h_work(H)``; rows H
    to hw - 1 zeros): slabs 2p and 2p+1 (zeros past D) packed as one complex
    column x_2p + i x_2p+1, its hw-point DFT in the steps ``_h_steps(hw)``
    (``_dft_steps``: an hw below 16, which only the tensor-core kernels
    take, as one dense step), and bins k and hw - k split into the two
    slabs' rows k <= hw/2. ``dot``: a tensor-core mode's product
    (``fused1d._DOTS``). Returns (re, im), each (..., D, hw/2+1, C)."""
    d, h = x.shape[-3], x.shape[-2]
    hw = _h_work(h)[0] if hw is None else hw
    x = TF.pad(x, (0, 0, 0, hw - h, 0, d % 2)).transpose(-1, -2)   # (..., 2P, C, hw)
    zr, zi = _dft_steps(x[..., 0::2, :, :], x[..., 1::2, :, :], _h_steps(hw), False, dot)
    k = torch.arange(hw // 2 + 1, device=x.device)
    m = (hw - k) % hw
    pr, pi, qr, qi = zr[..., k], zi[..., k], zr[..., m], zi[..., m]
    # X_2p = (Z[k] + conj Z[-k]) / 2, X_2p+1 = (Z[k] - conj Z[-k]) / 2i
    re = torch.stack([pr + qr, pi + qi], dim=-3).flatten(-4, -3) / 2
    im = torch.stack([pi - qi, qr - pr], dim=-3).flatten(-4, -3) / 2
    return re[..., :d, :, :].transpose(-1, -2), im[..., :d, :, :].transpose(-1, -2)


def _h_inverse_pairs(er: torch.Tensor, ei: torch.Tensor, hw: int, oh: int,
                     dot=None) -> torch.Tensor:
    """The factored H/W kernel's H irfft at the working length ``hw`` of
    one-sided slabs (..., OD, hw/2+1, C) onto the rows [0, oh): slabs 2p and
    2p+1 (zeros past OD) at once, as one conjugated hw-point DFT (the steps
    ``_h_steps(hw)``) of E_2p + i E_2p+1, each
    Hermitian-extended (E[hw - k] = conj E[k], DC and, for an even hw,
    Nyquist taken real as the dense irfft weights them), whose real and
    imaginary parts are the two slabs' rows; 1/hw applied. ``dot`` as for
    ``_h_forward_pairs``. Returns (..., OD, oh, C)."""
    od = er.shape[-3]
    pad = (0, 0, 0, 0, 0, od % 2)
    er, ei = TF.pad(er, pad).transpose(-1, -2), TF.pad(ei, pad).transpose(-1, -2)
    k = torch.arange(hw, device=er.device)
    kk = torch.minimum(k, hw - k)
    ar, ai = er[..., 0::2, :, kk], ei[..., 0::2, :, kk]   # (..., P, C, hw)
    br, bi = er[..., 1::2, :, kk], ei[..., 1::2, :, kk]
    real = (k == 0) | (2 * k == hw)
    low = 2 * k < hw
    vr = torch.where(real, ar, torch.where(low, ar - bi, ar + bi))
    vi = torch.where(real, br, torch.where(low, ai + br, br - ai))
    outr, outi = _dft_steps(vr, vi, _h_steps(hw), True, dot)  # (..., P, C, hw)
    out = torch.stack([outr[..., :oh], outi[..., :oh]], dim=-3).flatten(-4, -3)
    return out[..., :od, :, :].transpose(-1, -2) / hw


def _hw_forward_reference(x: torch.Tensor, fr, fi, packed=None, dot=None):
    """(re, im) of the one-sided H DFT (``_h_forward_pairs`` at the working
    length for an H the kernels factor, else the dense product with ``fr``,
    ``fi``) and then the W DFT-64 (factored 8 x 8, ``fourstep.dft_last``,
    bins in natural order) of every d-slab of the stacked blocks (W
    zero-padded to 64): (B', Cin, D, Hw/2+1, 64). ``dot``: a tensor-core
    mode's product (``fused1d._DOTS``) for every DFT step, the H DFT then on
    slab pairs at every H (one dense step below 16), as the tensor-core
    kernel runs it.

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
    if dot is not None or _h_path(x.shape[-2]) == "factored":
        ar, ai = _h_forward_pairs(x, dot=dot)
    else:
        ar, ai = fr @ x, fi @ x
    return dft_last(ar, ai, _W_SPLIT, False, dot)


def _hw_inverse_reference(zr, zi, cr, ci, blocks, h: int, ow: int, dot=None) -> torch.Tensor:
    """The inverse W DFT (factored 8 x 8, 1/64 included) and the H irfft
    (``_h_inverse_pairs`` at the working length for an H the kernels
    factor, else the dense product with ``cr``, ``ci``) on the valid rows of
    the MAC's output (B', Cout, OD, Hw/2+1, 64), and the stored columns of
    each W block put side by side: (B, Cout, OD, OH, OW). ``dot`` as for
    ``_hw_forward_reference``."""
    e_r, e_i = dft_last(zr, zi, _W_SPLIT, True, dot)
    e_r, e_i = e_r / _TW, e_i / _TW
    if dot is not None or _h_path(h) == "factored":  # (B', Cout, OD, OH, 64)
        out = _h_inverse_pairs(e_r, e_i, _h_work(h)[0], cr.shape[0], dot)
    else:
        out = cr @ e_r + ci @ e_i
    if len(blocks) == 1:
        return out[..., :ow]
    out = out.reshape(-1, len(blocks), *out.shape[1:])
    return torch.cat([out[:, i, ..., lo:hi] for i, (_, lo, hi) in enumerate(blocks)], dim=-1)


def _tc_split(mode: str, h: int) -> Optional[Tuple[int, int]]:
    """None under "highest", else the H steps of the tensor-core kernels for
    a signal of H rows (``_h_steps``). Raises ValueError for an unknown
    precision mode, and for an H those kernels do not take."""
    if mode not in PRECISION_MODES:
        raise ValueError(f"unknown fused precision mode: {mode!r}")
    return None if mode == "highest" else _h_steps(h)


def _fused3d_forward_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None, packed: bool = False, mode: str = "highest",
) -> torch.Tensor:
    """Kernel B3's plain PyTorch version: the same blocked pipeline in split
    re/im arithmetic, float64 for a float64 signal and float32 otherwise.

    ``x_padded`` (B, Cin, D, H, W) already padded, ``kernel`` (Cout, Cin/g,
    KD, KH, KW) already dilated, and a 'v4' plan; returns the valid
    correlation (B, Cout, OD, OH, OW). W wider than 64 runs as stacked
    overlap-save blocks. ``spectra``: the baked ``kernel_spectra_3d`` at the
    working length ``_h_work(H)``, or None to compute them. ``packed``: pack the signal first
    (``_pack3d_reference``, B6) and read the packed layout, as B3 does
    under "pk". ``mode``: the precision mode whose kernels this stands for;
    under "bf16x3" and "bf16" the tensor-core chain's order (the H DFT on
    slab pairs at every H, the DFT-16 and its inverse as one dense step
    each) with each DFT product rounding its operands to bfloat16
    (``fused1d._DOTS``); the MAC stays FP32.
    """
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    b, cin, d, h, w = x_padded.shape
    cout, cpg, kd, kh, kw = kernel.shape
    dot = _DOTS[mode]
    plan, nwb, hop = _plan_for(x_padded.shape, kernel.shape, groups, "v4")
    nbh, nbd = _nbh_work(h), plan[4]
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    blocks = _w_blocks(w, ow, nwb, hop)
    fr, fi, cr, ci = _torch_mats(h, oh, dt, x_padded.device)

    # one-sided H DFT, then the W DFT-64, per d-slab; D to the NBD + 1
    # chunks of 8 slabs that the blocks read (zeros past D)
    if packed:
        xp = _pack3d_reference(x_padded.to(dt), plan[3], nwb, hop)
        tr, ti = _hw_forward_reference(xp, fr, fi, packed=(cin, d), dot=dot)
    else:
        x = _stack_w_blocks(x_padded.to(dt), [s for s, _, _ in blocks])
        tr, ti = _hw_forward_reference(x, fr, fi, dot=dot)
    dpad = (0, 0, 0, 0, 0, _DHOP * (nbd + 1) - d)
    tr, ti = TF.pad(tr, dpad), TF.pad(ti, dpad)
    # D: blocks of 16 slabs on a hop of 8, a DFT-16 each, factored 4 x 4
    # (one dense step under a tensor-core mode)
    d_split = _D_SPLIT if dot is None else (_DB, 1)
    bb = b * nwb
    tr = tr.unfold(2, _DB, _DHOP).reshape(bb, groups, cpg, nbd, nbh, _TW, _DB)
    ti = ti.unfold(2, _DB, _DHOP).reshape(bb, groups, cpg, nbd, nbh, _TW, _DB)
    sr, si = _dft_steps(tr, ti, d_split, False, dot)

    # pointwise complex MAC over each out-channel's group of in-channels
    ks = _spectra_or(spectra, dt, lambda: kernel_spectra_3d(kernel.to(dt), _h_work(h)[0]))
    kr = ks.real.reshape(groups, cout // groups, cpg, _DB, nbh, _TW)
    ki = ks.imag.reshape(groups, cout // groups, cpg, _DB, nbh, _TW)
    mac = "bgcjnzf,gocfnz->bgojnzf"
    yr = torch.einsum(mac, sr, kr) - torch.einsum(mac, si, ki)
    yi = torch.einsum(mac, sr, ki) + torch.einsum(mac, si, kr)

    # inverse DFT-16, factored alike, kept to the 8 valid d of each block
    zr, zi = (v[..., :_DHOP] / _DB for v in _dft_steps(yr, yi, d_split, True, dot))
    zr = zr.permute(0, 1, 2, 3, 6, 4, 5).reshape(bb, cout, nbd * _DHOP, nbh, _TW)[:, :, :od]
    zi = zi.permute(0, 1, 2, 3, 6, 4, 5).reshape(bb, cout, nbd * _DHOP, nbh, _TW)[:, :, :od]
    return _hw_inverse_reference(zr, zi, cr, ci, blocks, h, ow, dot)


def _fused3d_tap_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None, mode: str = "highest",
) -> torch.Tensor:
    """Kernel B4's plain PyTorch version: the same pipeline in split re/im
    arithmetic, float64 for a float64 signal and float32 otherwise.

    ``x_padded`` (B, Cin, D, H, W) already padded, ``kernel`` (Cout, Cin/g,
    KD, KH, KW) already dilated, and a 'tap' plan; returns the valid
    correlation (B, Cout, OD, OH, OW). W wider than 64 runs as stacked
    overlap-save blocks. ``spectra``: the baked ``kernel_spectra_tap`` at the
    working length ``_h_work(H)``, or None to compute them. ``mode`` as for
    ``_fused3d_forward_reference``: the H/W steps in the tensor-core order
    with rounded products; the tap MAC stays FP32 in every mode.
    """
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    b, cin, d, h, w = x_padded.shape
    cout, cpg, kd, kh, kw = kernel.shape
    dot = _DOTS[mode]
    plan, nwb, hop = _plan_for(x_padded.shape, kernel.shape, groups, "tap")
    nbh = _nbh_work(h)
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    blocks = _w_blocks(w, ow, nwb, hop)
    fr, fi, cr, ci = _torch_mats(h, oh, dt, x_padded.device)

    # one-sided H DFT, then the W DFT-64, per d-slab
    x = _stack_w_blocks(x_padded.to(dt), [s for s, _, _ in blocks])
    tr, ti = _hw_forward_reference(x, fr, fi, dot=dot)
    # D stays in the tap domain: the KD slabs from each valid d on
    bb = b * nwb
    tr = tr.reshape(bb, groups, cpg, d, nbh, _TW).unfold(3, kd, 1)  # (B', g, Cin/g, OD, NBH, 64, KD)
    ti = ti.reshape(bb, groups, cpg, d, nbh, _TW).unfold(3, kd, 1)

    # correlation over the taps and the group's in-channels, per (h, w) bin
    ks = _spectra_or(spectra, dt, lambda: kernel_spectra_tap(kernel.to(dt), _h_work(h)[0]))
    kr = ks.real.reshape(groups, cout // groups, cpg, kd, nbh, _TW)
    ki = ks.imag.reshape(groups, cout // groups, cpg, kd, nbh, _TW)
    mac = "bgcdnzt,goctnz->bgodnz"
    yr = torch.einsum(mac, tr, kr) - torch.einsum(mac, ti, ki)
    yi = torch.einsum(mac, tr, ki) + torch.einsum(mac, ti, kr)
    yr = yr.reshape(bb, cout, od, nbh, _TW)
    yi = yi.reshape(bb, cout, od, nbh, _TW)
    return _hw_inverse_reference(yr, yi, cr, ci, blocks, h, ow, dot)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused3d")
    if lib.fused3d_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused3d_forward.argtypes = [p] * 10 + [i] * 17 + [p]
        lib.fused3d_forward.restype = i
        lib.fused3d_pack.argtypes = [p] * 2 + [i] * 8 + [p]
        lib.fused3d_pack.restype = i
        lib.fused3d_tap_forward.argtypes = [p] * 9 + [i] * 16 + [p]
        lib.fused3d_tap_forward.restype = i
        lib.fused3d_spectra_v4.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.fused3d_spectra_v4.restype = i
        lib.fused3d_forward_tc.argtypes = [p] * 8 + [i] * 18 + [p]
        lib.fused3d_forward_tc.restype = i
        lib.fused3d_tap_forward_tc.argtypes = [p] * 8 + [i] * 17 + [p]
        lib.fused3d_tap_forward_tc.restype = i
        lib.fused3d_error_string.argtypes = [i]
        lib.fused3d_error_string.restype = ctypes.c_char_p
        lib.fused3d_smem_bytes.argtypes = [i]
        lib.fused3d_smem_bytes.restype = ctypes.c_longlong
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for the entry points, None (NULL) for an
    argument the kernels that run do not read."""
    return None if t is None else t.data_ptr()


def _check_launch_inputs(x_padded: torch.Tensor, spectra: torch.Tensor, what: str):
    """The contiguous signal and spectra a chain takes; the spectra 16-byte
    aligned, as the D kernels copy them into shared memory."""
    if not (x_padded.is_cuda and spectra.device == x_padded.device):
        raise ValueError(f"{what} kernel: signal and spectra must be on one CUDA device")
    if x_padded.dtype != torch.float32 or spectra.dtype != torch.complex64:
        raise ValueError(f"{what} kernel takes a float32 signal and complex64 spectra")
    spectra = spectra.contiguous()
    if spectra.data_ptr() % 16:
        spectra = spectra.clone()
    return x_padded.contiguous(), spectra


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


def _launch_spectra_v4(kernel: torch.Tensor, hw: int) -> torch.Tensor:
    """Runs kernel B7 on the (Cout, Cin/g, KD, KH, KW) float32 taps on a
    CUDA device: returns the conjugated spectra (Cout, Cin/g, 16, hw/2+1,
    64) complex64 at the working length ``hw`` (``_h_work(H)``), the input
    of ``_launch_fused3d``, computed on the caller's stream."""
    global launches_spectra
    if not kernel.is_cuda or kernel.dtype != torch.float32:
        raise ValueError("fused3d spectra kernel takes float32 taps on a CUDA device")
    cout, cpg, kd, kh, kw = kernel.shape
    if not (1 <= kd <= 9 and kh <= hw and 1 <= kw <= _TW):
        raise ValueError(f"fused3d spectra kernel: taps {tuple(kernel.shape)} do not fit "
                         f"KD <= 9, KH <= Hw = {hw}, KW <= {_TW}")
    kernel = kernel.detach().contiguous()
    dev = kernel.device
    out = torch.empty((cout, cpg, _DB, hw // 2 + 1, _TW), device=dev, dtype=torch.complex64)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fused3d_spectra_v4(
            kernel.data_ptr(), _spectra_roots(hw, dev).data_ptr(),
            _factor_vector(_D_SPLIT, dev).data_ptr(), out.data_ptr(),
            cout * cpg, kd, kh, kw, hw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, err, "fused3d spectra")
    launches_spectra += 1
    return out


def _launch_fused3d(
    x_padded: torch.Tensor, spectra: torch.Tensor, groups: int, k: Tuple[int, int, int],
    packed: bool = False, mode: str = "highest",
) -> torch.Tensor:
    """Runs kernel B3's chain on ``x_padded`` (B, Cin, D, H, W) float32 with
    the conjugated spectra (Cout, Cin/g, 16, Hw/2+1, 64) complex64
    (``kernel_spectra_3d`` at Hw, ``_h_work(H)``) of a (KD, KH, KW) kernel
    whose plan is 'v4', both on one CUDA device. Returns the valid
    correlation (B, Cout, OD, OH, OW). ``packed``: pack the signal with
    kernel B6 first and let B3 read the packed layout ("pk"). ``mode``: the
    FP32 chain under "highest" (``launches``), the tensor-core chain under
    "bf16x3" and "bf16" (``launches_tc``); an H the tensor-core chain does
    not take raises ValueError, as does an unknown mode."""
    tc = _tc_split(mode, x_padded.shape[3])
    x_padded, spectra = _check_launch_inputs(x_padded, spectra, "fused3d")
    b, cin, d, h, w = x_padded.shape
    cout, cpg = spectra.shape[:2]
    plan, nwb, hop = _plan_for(x_padded.shape, (cout, cpg) + tuple(k), groups, "v4")
    (hw, split), nbd = _h_work(h), plan[4]
    nbh = hw // 2 + 1
    if spectra.shape[2:] != (_DB, nbh, _TW) or cpg * groups != cin:
        raise ValueError(f"fused3d kernel: spectra {tuple(spectra.shape)} do not fit "
                         f"H={h} (spectra at Hw={hw}), Cin={cin}, groups={groups}")
    kd, kh, kw = k
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    items = b * nwb
    # (batch, W-block) items per launch: as many as the scratch budget holds
    # (the plan has checked that one does; the budget still counts S)
    per_item = _scratch_bytes_per_item(cin, cout, d, nbh, nbd, od)
    chunk = max(1, min(items, _SCRATCH_BUDGET // per_item))

    lib = _library()
    pp = plan[3] if packed else 0
    x = _launch_pack3d(x_padded, pp, nwb, hop) if packed else x_padded
    mats = _device_mats(h, oh, x_padded.device)
    dev, c64 = x_padded.device, torch.complex64
    out = torch.empty((b, cout, od, oh, ow), device=dev, dtype=torch.float32)
    t = torch.empty((chunk, cin, d, nbh, _TW), device=dev, dtype=c64)
    z = torch.empty((chunk, cout, od, nbh, _TW), device=dev, dtype=c64)
    shape = (cin, cout, groups, d, h, w, od, oh, ow, nbd, nwb, hop)
    if tc is None:
        entry, counter, tail = lib.fused3d_forward, "launches", (pp, *(split or (0, 0)))
        head = (x.data_ptr(), spectra.data_ptr(), *(_ptr(m) for m in mats))
    else:
        entry, counter, tail = lib.fused3d_forward_tc, "launches_tc", (pp, *tc, _TC_MODE[mode])
        head = (x.data_ptr(), spectra.data_ptr(), _tc_fragments_3d(tc, dev).data_ptr(),
                mats[1].data_ptr(), _ptr(mats[2]))
    head += (t.data_ptr(), z.data_ptr(), out.data_ptr(), *shape)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for item0 in range(0, items, chunk):
            err = entry(*head, item0, min(chunk, items - item0), *tail, stream)
            _raise_on_error(lib, err, "fused3d")
            globals()[counter] += 1
    return out


def _launch_fused3d_tap(
    x_padded: torch.Tensor, spectra: torch.Tensor, groups: int, k: Tuple[int, int, int],
    mode: str = "highest",
) -> torch.Tensor:
    """Runs kernel B4's chain on ``x_padded`` (B, Cin, D, H, W) float32 with
    the conjugated per-tap spectra (Cout, Cin/g, KD, Hw/2+1, 64) complex64
    (``kernel_spectra_tap`` at Hw, ``_h_work(H)``) of a (KD, KH, KW) kernel
    whose plan is 'tap', both on one CUDA device. Returns the valid
    correlation (B, Cout, OD, OH, OW). ``mode`` as for ``_launch_fused3d``
    (``launches_tap`` or ``launches_tap_tc``)."""
    tc = _tc_split(mode, x_padded.shape[3])
    x_padded, spectra = _check_launch_inputs(x_padded, spectra, "fused3d tap")
    b, cin, d, h, w = x_padded.shape
    cout, cpg = spectra.shape[:2]
    kd, kh, kw = k
    plan, nwb, hop = _plan_for(x_padded.shape, (cout, cpg) + tuple(k), groups, "tap")
    hw, split = _h_work(h)
    nbh = hw // 2 + 1
    if spectra.shape[2:] != (kd, nbh, _TW) or cpg * groups != cin:
        raise ValueError(f"fused3d tap kernel: spectra {tuple(spectra.shape)} do not fit "
                         f"KD={kd}, H={h} (spectra at Hw={hw}), Cin={cin}, groups={groups}")
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    items = b * nwb
    per_item = _tap_scratch_bytes_per_item(cin, cout, d, nbh, od)
    chunk = max(1, min(items, _SCRATCH_BUDGET // per_item))

    lib = _library()
    fh, wfac, hfac, _, ch = _device_mats(h, oh, x_padded.device)
    dev, c64 = x_padded.device, torch.complex64
    out = torch.empty((b, cout, od, oh, ow), device=dev, dtype=torch.float32)
    t = torch.empty((chunk, cin, d, nbh, _TW), device=dev, dtype=c64)
    z = torch.empty((chunk, cout, od, nbh, _TW), device=dev, dtype=c64)
    shape = (cin, cout, groups, d, h, w, kd, od, oh, ow, nwb, hop)
    if tc is None:
        entry, counter, tail = lib.fused3d_tap_forward, "launches_tap", split or (0, 0)
        head = (x_padded.data_ptr(), spectra.data_ptr(), _ptr(fh), _ptr(wfac), _ptr(hfac),
                _ptr(ch))
    else:
        entry, counter, tail = lib.fused3d_tap_forward_tc, "launches_tap_tc", (*tc, _TC_MODE[mode])
        head = (x_padded.data_ptr(), spectra.data_ptr(), _tc_fragments_3d(tc, dev).data_ptr(),
                wfac.data_ptr(), _ptr(hfac))
    head += (t.data_ptr(), z.data_ptr(), out.data_ptr(), *shape)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for item0 in range(0, items, chunk):
            err = entry(*head, item0, min(chunk, items - item0), *tail, stream)
            _raise_on_error(lib, err, "fused3d tap")
            globals()[counter] += 1
    return out


def _fused3d_forward(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
):
    """Valid correlation of ``x_padded`` with ``kernel`` through the plan's
    kernels (B3 for 'v4', after B6 under "pk"; B4 for 'tap') on a CUDA
    tensor, through their plain versions on a CPU one. ``spectra``: the
    plan's baked kernel spectra (``kernel_spectra_3d`` for 'v4',
    ``kernel_spectra_tap`` for 'tap', at the working length ``_h_work(H)``),
    or None to compute them. They are
    computed here, ahead of the call's records for a running cost analysis
    (``costs.record``), so that the analysis counts their transforms as the
    aten ops they are, on the CPU as on the card; the records hold the
    kernels' own counts (B6's too under "pk"), whichever of the kernels and
    plain versions run. Under ``set_fused3d_inline(True)`` an unplanned 'v4'
    call that passes ``_inline_fits_v4`` computes them with kernel B7 (its
    plain version on the CPU) under B7's own record instead. The precision
    mode (``set_fused3d_precision``) is read here, once a call: under a
    bf16 mode the tensor-core chains (or their plain versions of that mode)
    run, recorded as "B3_<mode>" / "B4_<mode>", and an H past 256 raises
    ValueError on both devices."""
    if x_padded.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused3d runs on CUDA or CPU tensors, got {x_padded.device}")
    mode = _PRECISION_3D
    _tc_split(mode, x_padded.shape[3])
    plan, nwb, _ = _plan_for(x_padded.shape, kernel.shape, groups)
    tap = plan[0] == "tap"
    packed = not tap and _XPACK3D == "pk"
    b, cin, d, h, w = x_padded.shape
    k = tuple(kernel.shape[2:])
    cout = kernel.shape[0]
    hw = _h_work(h)[0]
    inline = (spectra is None and not tap and _INLINE3D
              and _inline_fits_v4(cin, cout, d, h, w, *k, groups))
    if inline:
        spectra_record = costs.IDLE
        if costs.active():
            spectra_record = costs.record(
                "B7", costs.fused3d_spectra_kernel_flops(cin, cout, h, k, groups),
                costs.fused3d_spectra_work(cin, cout, h, k, groups)[0])
        with spectra_record:
            if x_padded.is_cuda:
                spectra = _launch_spectra_v4(kernel.float(), hw)
            else:
                spectra = _spectra_v4_reference(kernel, hw)
    elif spectra is None:
        spectra = kernel_spectra_tap(kernel, hw) if tap else kernel_spectra_3d(kernel, hw)
    record = pack = costs.IDLE
    if costs.active():
        record = costs.fused3d_record(b, cin, cout, d, h, w, k, groups, mode, tap)
        if packed:
            pack = costs.record("B6", 0, costs.pack3d_bytes(b, cin, d, h, w, plan[3], nwb))
    with record, pack:
        if x_padded.is_cuda:
            if tap:
                return _launch_fused3d_tap(x_padded.float(), spectra, groups, k, mode)
            return _launch_fused3d(x_padded.float(), spectra, groups, k, packed, mode)
        if tap:
            return _fused3d_tap_reference(x_padded.float(), kernel.float(), groups, spectra,
                                          mode)
        return _fused3d_forward_reference(x_padded.float(), kernel.float(), groups, spectra,
                                          packed, mode)


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
    'v4', B4's for 'tap', at the working length ``_h_work``) are computed
    once, on ``device`` (the card unless
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
    spectra = spectra_of(kernel, _h_work(hp)[0])

    def planned(signal: torch.Tensor) -> torch.Tensor:
        check_planned_signal(signal, (d, h, w), dev)
        x = F._pad_signal(signal, padding_, padding_mode)
        out = _Fused3dCore.apply(x.float(), kernel, 1, spectra)
        if bias is not None:
            out = out + bias.reshape(1, -1, 1, 1, 1)
        return out.to(signal.dtype)

    return planned
