"""Fused 3D FFT convolution: host side of the CUDA kernel ``csrc/fused3d.cu``.

The port's counterpart of the "v4" (overlap-save-D) path of
``fft_conv_tpu/kernels/fused3d.py``, the JAX package's plan for KD <= 9. The
whole padded volume is transformed: a one-sided H DFT at the full H
(NBH = H/2+1 rows), a 64-point W DFT (W zero-padded to 64, or cut into
overlap-save blocks of 64 columns when W is wider), and along D a DFT-16 per
block of 16 samples on a hop of 8 (zeros past D). The per-bin complex MAC
over each group's input channels against the conjugated kernel spectra is
then a pointwise product; the inverse DFT-16 keeps the 8 valid d of each
block, and the inverse W DFT and the H irfft keep the valid columns and
rows.

On a CUDA tensor ``_fused3d_forward`` launches the kernel; on a CPU tensor
it runs ``_fused3d_forward_reference``, the same blocked pipeline written
with torch ops (the counterpart of the JAX package's Pallas interpret mode).
There is no other route: a CUDA tensor launches the kernel or raises.

Gradients: ``_Fused3dCore`` is a ``torch.autograd.Function`` whose backward
is the composed path, shared with the 1D and 2D kernels
(``fused1d._fused_bwd``).

Not ported from the JAX module: the "tap" kernel for KD > 9 (a plan of that
mode raises ``NotImplementedError`` naming B4), ``plan_fft_conv3d``,
``fft_conv_transpose3d_fused`` and the TPU's precision, MAC, staging,
inline-spectra and x-pack switches (ROADMAP §A, §B).
"""

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops import functional as F
from ..ops.spectral import _dft_mats, _irfft_mats, _rfft_mats
from ..utils.shapes import to_ntuple
from . import _build
from .fused1d import _fused_bwd

# W transform length, and the D blocks: 16 samples on a hop of 8
_TW = 64
_DB = 16
_DHOP = 8

# The JAX package bounds its TPU cell by VMEM budgets (resident spectra of
# 24 MiB, a whole-volume cell of 96 MiB). This kernel keeps no volume in
# shared memory: its blocks hold a few d-slabs of NBH x 64 complex values.
# Its own limits are:
#   * the conjugated kernel spectra (Cout, Cin/g, 16, NBH, 64) complex, which
#     every (batch, D-block) block of the MAC re-reads: kept within half of
#     the card's 50 MB L2. The 1D/2D budget of 16 MiB would not do: the
#     spectra of the library's 3D benchmark row (64^3, K=8, 8 -> 8 channels)
#     are 17.3 MB, and they must fuse;
_SPECTRA_BUDGET = 24 * 2**20
#   * the shared memory of one block of the H/W phases (csrc/fused3d.cu:
#     Cfg<SB>::smem): SB d-slabs of NBH x 64 complex, SB in {4, 2, 1}, at
#     most what a Hopper block can use, so NBH <= 454 (H <= 907);
_SMEM_LIMIT = 232448
#   * the scratch that the phases hand on, per (batch, W-block) item: the
#     H/W spectra T (Cin, D, NBH, 64), the block spectra S (Cin, NBD, 16,
#     NBH, 64) and the inverse-D output Z (Cout, OD, NBH, 64), complex. The
#     wrapper runs the items in ranges under this budget, so one item must
#     fit.
_SCRATCH_BUDGET = 256 * 2**20
# The "tap" plan (KD > 9) belongs to kernel B4, which is not ported: it keeps
# the JAX package's budgets, so the port raises naming B4 exactly where the
# JAX package runs that kernel.
_TAP_SPECTRA_BUDGET = 24 * 2**20
_TAP_CELL_BUDGET = 80 * 2**20
_TAP_MESSAGE = (
    "the fused 3D 'tap' kernel for this shape (KD > 9, or no overlap-save-D "
    "plan fits) is not ported yet (ROADMAP §B, B4); pass impl='xla' for the "
    "composed path"
)

# Launches of the CUDA kernel chain (four kernels) since import or the last
# reset; the plain version on CPU tensors does not count.
launches = 0


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


@lru_cache(maxsize=None)
def plan_3d(cin: int, cout: int, d: int, h: int, w: int,
            kd: int, kh: int, kw: int, groups: int = 1):
    """Mode-tagged plan, or None when nothing fits: the JAX package's
    ``plan_3d`` with this port's budgets.

    ('v4', nbh, nbhp, pp, nbd, vdp) runs kernel B3 (KD <= 9);
    ('tap', nbh, vdp, pages) is kernel B4's, not ported. Eligibility: W fits
    one 64-point transform (see ``plan_3d_blocked`` for wider W). ``cin`` is
    the TOTAL in-channel count."""
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
    TPU layout's, kept so the plans compare equal) under this kernel's
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
    """The JAX package's tap-kernel plan and budgets, kept as they are until
    kernel B4 is ported."""
    nbh = h // 2 + 1
    me, mr = _tap_counts(kd)
    if cout * (me + mr) * (cin // groups) * nbh * 128 * 8 > _TAP_SPECTRA_BUDGET:
        return None
    vd = d - kd + 1
    vdp = -(-(-(-vd // 2)) // 8) * 8
    maxoff = max(me - 1, mr - 1 if mr else 0)
    wrows = -(-(8 + maxoff) // 8) * 8
    pages = vdp - 8 + wrows
    vh = h - kh + 1
    cell = (
        cin * h * pages * 128
        + 4 * cin * nbh * pages * 128
        + 2 * cout * nbh * vdp * 128
        + cout * vh * vdp * 128
    ) * 4
    if cell > _TAP_CELL_BUDGET:
        return None
    return ("tap", nbh, vdp, pages)


def _w_blocks(w: int, ow: int, nwb: int, hop: int):
    """[(start, lo, hi)] per W block: input columns [start, start + 64),
    stored output columns start + [lo, hi). The last block is clamped to end
    at the input's edge; its first lo columns repeat its neighbour's."""
    out = []
    for i in range(nwb):
        start = min(i * hop, max(w - _TW, 0))
        out.append((start, i * hop - start, min(hop, ow - start)))
    return out


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
    """``_mats_3d`` as torch tensors of ``dtype`` on ``device``, made once per
    device so that repeated calls copy nothing from the host."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return tuple(torch.from_numpy(m).to(device) for m in _mats_3d(h, vh, npdt))


@lru_cache(maxsize=None)
def _device_mats(h: int, vh: int, device: torch.device):
    """The kernel's factor matrices as interleaved complex64 tensors on
    ``device``: F_H (NBH, H), W and its inverse (64, 64), the DFT-16 (16, 16),
    its inverse rows (8, 16) and the irfft rows (VH, NBH) as (cr, ci) pairs."""
    m = _torch_mats(h, vh, torch.float32, device)
    return tuple(torch.complex(m[i], m[i + 1]) for i in range(0, len(m), 2))


@lru_cache(maxsize=None)
def _spectra_mats(h: int, kd: int, kh: int, kw: int, device: torch.device):
    """complex128 factors of the kernel spectra on ``device``: the one-sided
    H DFT on the KH taps (NBH, KH), the W DFT-64 on the KW taps (KW, 64) and
    the DFT-16 on the KD taps (16, KD)."""
    fr, fi, wr, wi, _, _, dr, di = _torch_mats(h, 1, torch.float64, device)[:8]
    return (torch.complex(fr[:, :kh], fi[:, :kh]), torch.complex(wr[:kw], wi[:kw]),
            torch.complex(dr[:kd], di[:kd]).T.contiguous())


def kernel_spectra_3d(kernel: torch.Tensor, h: int) -> torch.Tensor:
    """Conjugated spectra of the (Cout, Cin/g, KD, KH, KW) kernel at the 16
    D-bins, the NBH one-sided H bins and the 64 W bins: (Cout, Cin/g, 16,
    NBH, 64) complex on the kernel's device, the kernel's input. The port of
    the JAX package's ``_kernel_spectra_v4``, without its TPU lane packing.

    The three small transforms run in complex128 (over the weights only, and
    exact to float32 rounding whatever TF32 setting the caller chose); the
    result is complex128 for a float64 kernel and complex64 otherwise."""
    cout, cpg, kd, kh, kw = kernel.shape
    fh, fw, fd = _spectra_mats(h, kd, kh, kw, kernel.device)
    b = (fh @ kernel.detach().to(torch.complex128)) @ fw   # (Cout, Cin/g, KD, NBH, 64)
    out = torch.conj_physical(fd @ b.flatten(3)).reshape(cout, cpg, _DB, fh.shape[0], _TW)
    return out if kernel.dtype == torch.float64 else out.to(torch.complex64)


def _v4_plan(x_shape, kernel_shape, groups: int):
    """(nbh, nbd, nwb, hop) of the v4 plan for a padded signal and a
    dilated kernel; raises where the kernel cannot run."""
    _, cin, d, h, w = x_shape
    cout, cpg, kd, kh, kw = kernel_shape
    blocked = plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)
    if blocked is None:
        raise ValueError("no fused 3D configuration fits this shape")
    plan, nwb, hop = blocked
    if plan[0] == "tap":
        raise NotImplementedError(_TAP_MESSAGE)
    return plan[1], plan[4], nwb, hop


def _fused3d_forward_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the same blocked pipeline in split
    re/im arithmetic, float64 for a float64 signal and float32 otherwise.

    ``x_padded`` (B, Cin, D, H, W) already padded, ``kernel`` (Cout, Cin/g,
    KD, KH, KW) already dilated; returns the valid correlation (B, Cout, OD,
    OH, OW). W wider than 64 runs as stacked overlap-save blocks.
    """
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    b, cin, d, h, w = x_padded.shape
    cout, cpg, kd, kh, kw = kernel.shape
    nbh, nbd, nwb, hop = _v4_plan(x_padded.shape, kernel.shape, groups)
    od, oh, ow = d - kd + 1, h - kh + 1, w - kw + 1
    blocks = _w_blocks(w, ow, nwb, hop)

    x = x_padded.to(dt)
    if nwb > 1:
        x = torch.stack([x[..., s:s + _TW] for s, _, _ in blocks], dim=1)
        x = x.reshape(b * nwb, cin, d, h, _TW)
    # W to 64 columns, D to the NBD + 1 chunks of 8 that the blocks read
    x = TF.pad(x, (0, _TW - x.shape[-1], 0, 0, 0, _DHOP * (nbd + 1) - d))
    fr, fi, wr, wi, ur, ui, dr, di, er, ei, cr, ci = _torch_mats(h, oh, dt, x.device)

    # one-sided H DFT, then the W DFT-64, per d-slab
    hr, hi = fr @ x, fi @ x                         # (B', Cin, Dp, NBH, 64)
    tr = hr @ wr - hi @ wi
    ti = hr @ wi + hi @ wr
    # D: blocks of 16 slabs on a hop of 8, a DFT-16 each
    tr = tr.unfold(2, _DB, _DHOP)                   # (B', Cin, NBD, NBH, 64, 16)
    ti = ti.unfold(2, _DB, _DHOP)
    sr = (tr @ dr - ti @ di).permute(0, 1, 2, 5, 3, 4)  # (B', Cin, NBD, 16, NBH, 64)
    si = (tr @ di + ti @ dr).permute(0, 1, 2, 5, 3, 4)

    # pointwise complex MAC over each out-channel's group of in-channels
    ks = kernel_spectra_3d(kernel.to(dt), h)        # (Cout, Cin/g, 16, NBH, 64)
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

    # inverse W DFT, then the H irfft on the valid rows
    e_r = zr @ ur - zi @ ui
    e_i = zr @ ui + zi @ ur
    out = cr @ e_r + ci @ e_i                       # (B', Cout, OD, OH, 64)
    if nwb == 1:
        return out[..., :ow]
    out = out.reshape(b, nwb, cout, od, oh, _TW)
    return torch.cat([out[:, i, ..., lo:hi] for i, (_, lo, hi) in enumerate(blocks)], dim=-1)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused3d")
    if lib.fused3d_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused3d_forward.argtypes = [p] * 12 + [i] * 14 + [p]
        lib.fused3d_forward.restype = i
        lib.fused3d_error_string.argtypes = [i]
        lib.fused3d_error_string.restype = ctypes.c_char_p
        lib.fused3d_smem_bytes.argtypes = [i]
        lib.fused3d_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch_fused3d(
    x_padded: torch.Tensor, spectra: torch.Tensor, groups: int, k: Tuple[int, int, int]
) -> torch.Tensor:
    """Runs the CUDA kernel chain on ``x_padded`` (B, Cin, D, H, W) float32
    with the conjugated spectra (Cout, Cin/g, 16, NBH, 64) complex64 of a
    (KD, KH, KW) kernel, both on one CUDA device. Returns the valid
    correlation (B, Cout, OD, OH, OW)."""
    global launches
    if not (x_padded.is_cuda and spectra.device == x_padded.device):
        raise ValueError("fused3d kernel: signal and spectra must be on one CUDA device")
    if x_padded.dtype != torch.float32 or spectra.dtype != torch.complex64:
        raise ValueError("fused3d kernel takes a float32 signal and complex64 spectra")
    x_padded = x_padded.contiguous()
    spectra = spectra.contiguous()
    b, cin, d, h, w = x_padded.shape
    cout, cpg = spectra.shape[:2]
    nbh, nbd, nwb, hop = _v4_plan(x_padded.shape, (cout, cpg) + tuple(k), groups)
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
                x_padded.data_ptr(), spectra.data_ptr(), *(m.data_ptr() for m in mats),
                t.data_ptr(), s.data_ptr(), z.data_ptr(), out.data_ptr(),
                cin, cout, groups, d, h, w, od, oh, ow, nbd, nwb, hop,
                item0, min(chunk, items - item0), stream,
            )
            if err != 0:
                msg = lib.fused3d_error_string(err).decode()
                raise RuntimeError(f"fused3d kernel launch failed: {msg} (cudaError {err})")
            launches += 1
    return out


def _fused3d_forward(x_padded: torch.Tensor, kernel: torch.Tensor, groups: int = 1):
    """Valid correlation of ``x_padded`` with ``kernel``: the CUDA kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if x_padded.is_cuda:
        spectra = kernel_spectra_3d(kernel, x_padded.shape[3])
        return _launch_fused3d(x_padded.float(), spectra, groups, tuple(kernel.shape[2:]))
    if x_padded.device.type == "cpu":
        return _fused3d_forward_reference(x_padded.float(), kernel.float(), groups)
    raise ValueError(f"fused3d runs on CUDA or CPU tensors, got {x_padded.device}")


class _Fused3dCore(torch.autograd.Function):
    """The fused 3D correlation with the composed path as its backward."""

    @staticmethod
    def forward(ctx, x_padded, kernel, groups):
        ctx.save_for_backward(x_padded, kernel)
        ctx.groups = groups
        return _fused3d_forward(x_padded, kernel, groups)

    @staticmethod
    def backward(ctx, g):
        x_padded, kernel = ctx.saved_tensors
        dx, dw = _fused_bwd(
            x_padded, kernel, g.contiguous(), ctx.groups,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1],
        )
        return dx, dw, None


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
    than 64 runs as overlap-save W blocks. Raises ValueError when no fused
    configuration fits (unlike the JAX function it does not fall back), and
    NotImplementedError for a shape whose plan is the unported tap kernel.
    """
    out = fft_conv3d_fused_if_fits(
        signal, kernel, bias, padding, padding_mode, stride, dilation, groups
    )
    if out is None:
        raise ValueError(
            "no fused 3D FFT configuration fits this shape (W blocks wider "
            "than 64, or the spectra, the shared memory or the scratch exceed "
            "the kernel's budgets); use fft_conv(impl='xla')"
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
    single-block plans only, as the JAX package does). Any other 'tap' plan
    raises NotImplementedError. The one place where the gate is checked, for
    both the fused function and ``fft_conv(impl="auto")``."""
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
    if blocked[0][0] == "tap":
        raise NotImplementedError(_TAP_MESSAGE)
    out = _Fused3dCore.apply(x.float(), kernel.float(), groups)
    if stride_ != (1, 1, 1):
        out = out[:, :, ::stride_[0], ::stride_[1], ::stride_[2]]
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out.to(signal.dtype)
