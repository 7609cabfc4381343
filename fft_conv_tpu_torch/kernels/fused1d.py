"""Fused 1D FFT convolution: host side of the CUDA kernel ``csrc/fused1d.cu``.

The port's counterpart of ``fft_conv_tpu/kernels/fused1d.py``. Long signals
are processed overlap-save: blocks of FFT size N = N1 * 128 overlap by K-1
samples, and each block yields V = V1 * 128 valid outputs of the
cross-correlation (the first V samples of its circular result). Per block
the kernel runs the one-sided four-step DFT (only rows k1 in [0, N1/2] of the
scrambled spectrum, see ``_factor_consts``), a per-bin complex MAC over the
group's input channels against the conjugated kernel spectra, and the
inverse pipeline, writing only valid outputs. Every DFT of it is factored:
the N1-point column DFTs as ``_COL_SPLITS`` on column pairs packed as one
complex column, the 128-point row DFTs as ``_ROW_SPLIT``
(``fourstep.dft_last``).

``set_fused_precision`` picks how the DFT products are formed, as the JAX
package's switch of that name does: "highest" (the default here) runs the
FP32 kernel pair, "bf16x3" and "bf16" the tensor-core pair of the same
source, whose DFT steps are bf16 products (hi/lo splits, three products or
one), their column DFTs dense or factored 8 · 8 (``_TC_COL_SPLITS``).

On a CUDA tensor ``_fused_forward`` launches the kernel pair of the mode; on
a CPU tensor it runs ``_fused_forward_reference``, the same blocked pipeline
written with torch ops, the mode's roundings included (the counterpart of
the JAX package's Pallas interpret mode). There is no other route: a CUDA
tensor launches the kernel or raises.

Gradients: ``_FusedCore`` is a ``torch.autograd.Function`` whose backward is
two composed-path convolutions (``ops/functional.py``): dx is the transposed
convolution of the output gradient with the kernel, dw the correlation of
the signal with the output gradient, batch acting as the contracted channel.

``plan_fft_conv1d`` bakes the kernel spectra once for serving, as the JAX
package's does; the planned call runs the same forward with them.
"""

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from . import costs
from ..ops import functional as F
from ..utils.device import Device, check_planned_signal, resolve_device
from ..utils.shapes import to_ntuple
from . import _build
from .fourstep import _factor_tensors, dft_last, fft_factor_matrices, kernel_spectrum

_N2 = 128
# The kernel's four-step splits (A, B): N1 = A * B for the column DFTs of
# stage 1 and the c2r, 128 = 16 * 8 for the row DFTs (as B2's T = 128)
_COL_SPLITS = {16: (4, 4), 32: (8, 4), 64: (8, 8)}
_ROW_SPLIT = (16, 8)
# The tensor-core kernels' column DFTs: dense at N1 = 16 and 32 (2 N1 real
# fills each k-step of 16, where a radix-4 step would fill half), 8 · 8 at
# N1 = 64 (both radix-8 steps fill it, at a quarter of the dense products)
_TC_COL_SPLITS = {16: None, 32: None, 64: (8, 8)}
_FFT_SIZES = (2048, 4096, 8192)

# The JAX package bounds its TPU cell by two VMEM budgets (resident spectra
# and the batch-merged cell). This kernel holds neither in shared memory: a
# block keeps one channel's window and one one-sided spectrum, a size fixed
# by N alone. Its own limits are:
#   * the one-sided kernel spectra, which every (block, batch) pair of
#     phase 2 re-reads. They should stay in the card's 50 MB L2, or phase 2
#     turns into repeated HBM reads of the weights; this budget keeps them in
#     a third of it, leaving room for the signal blocks and D.
_SPECTRA_BUDGET = 16 * 2**20
#   * the scratch D that phase 1 hands to phase 2, (blocks, B, Cin, N1/2+1,
#     128) complex. The wrapper runs the overlap-save blocks in ranges that
#     keep D under this budget, so one block of the whole batch must fit.
_SCRATCH_BUDGET = 256 * 2**20
# CUDA's limit on gridDim.y, which carries the blocks of one launch.
_MAX_BLOCKS_PER_LAUNCH = 65535

# Launches of the FP32 kernel pair (phase 1 + phase 2) since import or the
# last reset, and of the tensor-core pair (the modes "bf16x3" and "bf16");
# the plain version on CPU tensors does not count.
launches = 0
launches_tc = 0

# How the DFT products are formed (set_fused_precision): "highest" FP32,
# "bf16x3" three bf16 products of hi/lo splits (lo.lo dropped), "bf16" one.
# The twiddles, the one-sided split, the MAC and 1/N are FP32 in every mode.
PRECISION_MODES = ("highest", "bf16x3", "bf16")
_PRECISION_MODE = "highest"
# the tensor-core kernel's code of each bf16 mode: its products per k-step
_TC_MODE = {"bf16x3": 3, "bf16": 1}


def set_fused_precision(mode: str) -> None:
    """Selects how the fused 1D kernel forms its DFT products, read at
    every call: "highest" (FP32, the FP32 kernel pair), "bf16x3" (bf16
    tensor-core products of hi/lo splits, three a product, near FP32) or
    "bf16" (one bf16 product, an opt-in serving mode outside the FP32 bar).
    Any other name raises ValueError. The 2D and 3D kernels are not
    affected. The port of the JAX package's ``set_fused_precision``
    (``fft_conv_tpu/kernels/fused1d.py:177``), whose default is "bf16x3";
    this one's is "highest"."""
    global _PRECISION_MODE
    if mode not in PRECISION_MODES:
        raise ValueError(f"unknown fused precision mode: {mode!r}")
    _PRECISION_MODE = mode


def fused_split(n: int) -> Tuple[int, int]:
    """(N1, N2) with N2 = 128: one block row is one 128-sample column set,
    the width the kernel's threads cover."""
    if n % _N2:
        raise ValueError(f"fused FFT size must be a multiple of 128, got {n}")
    return n // _N2, _N2


def _spectra_bytes(n: int, cin: int, cout: int) -> int:
    n1, n2 = fused_split(n)
    return cout * cin * (n1 // 2 + 1) * n2 * 8


def _scratch_bytes_per_block(n: int, batch: int, cin_total: int) -> int:
    n1, n2 = fused_split(n)
    return batch * cin_total * (n1 // 2 + 1) * n2 * 8


def cell_fits(n: int, batch: int, cin: int, cout: int, groups: int = 1) -> bool:
    """True when the kernel can run at FFT size ``n``: the one-sided spectra
    of (Cout, Cin/g) fit ``_SPECTRA_BUDGET`` and one overlap-save block of
    the whole batch fits ``_SCRATCH_BUDGET``. ``cin`` is per group, as in
    ``choose_fft_size``."""
    return (
        _spectra_bytes(n, cin, cout) <= _SPECTRA_BUDGET
        and _scratch_bytes_per_block(n, batch, cin * groups) <= _SCRATCH_BUDGET
    )


def choose_fft_size(
    k: int, l_padded: int, cin: int, cout: int, batch: int = 1, groups: int = 1
) -> Optional[int]:
    """Candidate N minimizing the modeled per-output cost, or None.

    Cost per valid output sample ~ (N1 + c) * N/V: stage-1 work grows with
    N1 = N/128 while the overlap redundancy N/V shrinks with N; c ~ 128
    lumps the N-independent stage-2, MAC and inverse work. The model is the
    JAX package's (``fft_conv_tpu/kernels/fused1d.py:87``), kept until the
    card is swept. ``cin`` is per group. Returns None when no candidate
    leaves a full 128-sample block of valid outputs or fits ``cell_fits``
    (the caller then takes the composed path or raises).
    """
    best, best_cost = None, None
    for n in _FFT_SIZES:
        if not cell_fits(n, batch, cin, cout, groups):
            break  # both budgets grow with n
        n1, n2 = fused_split(n)
        v = ((n - k + 1) // n2) * n2 if n >= k else 0
        if v < n2:
            continue
        cost = (n1 + 128.0) * n / v
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
        if n >= 2 * l_padded:
            break
    return best


@lru_cache(maxsize=None)
def _factor_consts(n1: int, n2: int, v1: int, dtype=np.float32):
    """Split re/im DFT factors for the ONE-SIDED four-step pipeline.

    Real input makes the scrambled spectrum conjugate-symmetric in
    four-step coordinates: D[N1-k1, N2-1-k2] = conj(D[k1, k2]) (k1 > 0; row
    0 pairs with itself under the k2 flip). So only k1 in [0, N1/2] is
    computed — H1+1 = N1/2+1 rows, rows 0 and N1/2 self-paired — through
    stage 2, the MAC and inverse stage 1. The symmetry survives the inverse
    pipeline as G[N1-k1] = conj(G[k1]), so inverse stage 2 is exactly
    out = Re(if1[:, :H1+1] . diag(w) @ G) with interior weights 2.

      f1os (H1+1, N1) forward stage-1 rows; tw (H1+1, N2) twiddle rows;
      f2 / if2 (N2, N2); if1w (V1, H1+1) inverse stage 2, valid output
      rows only, pair-doubling folded in.

    Returns (f1r, f1i, f2r, f2i, twr, twi, if1r, if1i, if2r, if2i) as
    ``dtype`` numpy arrays. These dense factors are the JAX package's, kept
    as the float64 oracle of the tests; the kernel and its plain version run
    the factored transforms instead.
    """
    f1, f2, tw = fft_factor_matrices(n1, n2)
    h1 = n1 // 2
    if1 = np.conj(f1) / n1
    if2 = np.conj(f2) / n2
    wts = np.full(h1 + 1, 2.0)
    wts[0] = 1.0
    if n1 % 2 == 0:  # the top row is self-paired only when N1 is even
        wts[h1] = 1.0
    if1w = if1[:v1, :h1 + 1] * wts[None, :]
    out = []
    for m in (f1[:h1 + 1], f2, tw[:h1 + 1], if1w, if2):
        out.append(np.ascontiguousarray(m.real, dtype))
        out.append(np.ascontiguousarray(m.imag, dtype))
    return tuple(out)


def _blocking(n: int, k: int, l_pad: int) -> Tuple[int, int, int]:
    """(V1, valid output length, overlap-save block count) at FFT size n."""
    n1, n2 = fused_split(n)
    v1 = (n - k + 1) // n2
    if v1 < 1:
        raise ValueError(f"FFT size {n} leaves no full block of valid outputs at K={k}")
    v_total = l_pad - k + 1
    return v1, v_total, -(-v_total // (v1 * n2))


def _spectra_or(spectra: Optional[torch.Tensor], dt: torch.dtype, compute) -> torch.Tensor:
    """A plan's baked complex ``spectra`` in the complex type of the working
    dtype ``dt``, or ``compute()`` when there are none."""
    if spectra is None:
        return compute()
    return spectra.to(torch.complex128 if dt == torch.float64 else torch.complex64)


@lru_cache(maxsize=None)
def _twiddle_rows(h: int, dt: torch.dtype, device: torch.device):
    """(re, im) of the four-step twiddle rows tw[k1, j2] = exp(-2 pi i k1 j2
    / N), k1 < h, as ``dt`` tensors on ``device``."""
    tw = fft_factor_matrices(2 * (h - 1), _N2)[2][:h]
    return (torch.from_numpy(np.ascontiguousarray(tw.real)).to(device, dt),
            torch.from_numpy(np.ascontiguousarray(tw.imag)).to(device, dt))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The "bf16x3" product: hi = bf16(x) and lo = bf16(x - hi) of both
    operands, lo.hi + hi.lo + hi.hi summed in the operands' dtype."""
    ah, bh = _bf16(a), _bf16(b)
    return _bf16(a - ah) @ bh + ah @ _bf16(b - bh) + ah @ bh


def _dot1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The "bf16" product: bf16(a) @ bf16(b), summed in the operands' dtype."""
    return _bf16(a) @ _bf16(b)


# the product that forms each DFT step of a mode (None: the FP32 ``@``)
_DOTS = {"highest": None, "bf16x3": _dot3, "bf16": _dot1}


def _column_dft(xr: torch.Tensor, xi: torch.Tensor, inverse: bool,
                dot) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unscaled N1-point DFT (inverse: conjugated) of the last axis of
    xr + i xi as the kernels run it: ``_COL_SPLITS`` in FP32 (``dot`` None);
    under a tensor-core mode each real product through ``dot``, as one dense
    product (the DFT matrix is symmetric) or factored (``_TC_COL_SPLITS``)."""
    n1 = xr.shape[-1]
    split = _COL_SPLITS[n1] if dot is None else _TC_COL_SPLITS[n1]
    if split is not None:
        return dft_last(xr, xi, split, inverse, dot)
    fr, fi = _factor_tensors(n1, 1, xr.dtype, xr.device)[:2]
    if inverse:
        fi = -fi
    return dot(xr, fr) - dot(xi, fi), dot(xr, fi) + dot(xi, fr)


def _forward_spectrum(a: torch.Tensor, dot=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's phase 1 on real windows ``a`` (..., N1, 128): the
    one-sided scrambled spectrum D (..., N1/2+1, 128) as (re, im).

    Stage 1 packs columns c and c + 64 as one complex column, runs its
    N1-point DFT (``_COL_SPLITS``) and splits bins k and -k into the two
    columns' spectra on rows k1 <= N1/2; then the twiddle and stage 2, the
    128-point DFT of each row (``_ROW_SPLIT``). ``dot``: the product of a
    tensor-core mode (``_DOTS``), under which the column DFT is that of the
    tensor-core kernels (``_column_dft``); None is FP32."""
    n1 = a.shape[-2]
    h = n1 // 2 + 1
    zr, zi = _column_dft(a[..., :64].transpose(-1, -2), a[..., 64:].transpose(-1, -2),
                         False, dot)  # (..., 64, N1)
    k = torch.arange(h, device=a.device)
    m = (n1 - k) % n1
    pr, pi, qr, qi = zr[..., k], zi[..., k], zr[..., m], zi[..., m]
    # X_c = (Z[k] + conj Z[-k]) / 2, X_c+64 = (Z[k] - conj Z[-k]) / 2i
    br = torch.cat([pr + qr, pi + qi], dim=-2).transpose(-1, -2) / 2
    bi = torch.cat([pi - qi, qr - pr], dim=-2).transpose(-1, -2) / 2
    twr, twi = _twiddle_rows(h, a.dtype, a.device)
    cr, ci = br * twr - bi * twi, br * twi + bi * twr
    return dft_last(cr, ci, _ROW_SPLIT, False, dot)


def _inverse_valid(yr: torch.Tensor, yi: torch.Tensor, v1: int, dot=None) -> torch.Tensor:
    """The kernel's inverse on one-sided spectra Y (..., N1/2+1, 128): the
    first V1 rows (..., V1, 128) of the real block, 1/N included.

    The conjugated 128-point row DFT and the conjugate twiddle give G; the
    c2r then runs columns c and c + 64 at once, as one conjugated N1-point
    DFT of their Hermitian extensions G[N1 - k] = conj G[k] (bins 0 and
    N1/2 taken real), whose real and imaginary parts are the two columns.
    ``dot`` as in ``_forward_spectrum``."""
    h = yr.shape[-2]
    n1 = 2 * (h - 1)
    er, ei = dft_last(yr, yi, _ROW_SPLIT, True, dot)
    twr, twi = _twiddle_rows(h, yr.dtype, yr.device)
    gr, gi = (er * twr + ei * twi).transpose(-1, -2), (ei * twr - er * twi).transpose(-1, -2)
    k = torch.arange(n1, device=yr.device)
    kk = torch.minimum(k, n1 - k)
    ar, ai, br, bi = gr[..., :64, kk], gi[..., :64, kk], gr[..., 64:, kk], gi[..., 64:, kk]
    real = (k == 0) | (k == n1 // 2)
    low = k < n1 // 2
    vr = torch.where(real, ar, torch.where(low, ar - bi, ar + bi))
    vi = torch.where(real, br, torch.where(low, ai + br, br - ai))
    outr, outi = _column_dft(vr, vi, True, dot)  # (..., 64, N1)
    out = torch.cat([outr[..., :v1], outi[..., :v1]], dim=-2).transpose(-1, -2)
    return out / (n1 * _N2)


def _fused_forward_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, n: int, groups: int = 1,
    spectra: Optional[torch.Tensor] = None, mode: str = "highest",
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the same blocked one-sided
    pipeline with the same factored transforms (``_forward_spectrum``, the
    MAC, ``_inverse_valid``), float64 for a float64 signal and float32
    otherwise.

    ``x_padded`` (B, Cin, L) already padded, ``kernel`` (Cout, Cin/g, K)
    already dilated; returns the valid correlation (B, Cout, L - K + 1).
    ``spectra``: a plan's baked ``kernel_spectra_one_sided``, or None to
    compute them. ``mode``: the precision mode whose kernel pair this
    stands for; under "bf16x3" and "bf16" each DFT product rounds its
    operands to bfloat16 where the tensor-core kernels do (``_DOTS``), the
    column DFTs factored as they run them (``_TC_COL_SPLITS``).
    """
    dt = torch.float64 if x_padded.dtype == torch.float64 else torch.float32
    b, cin, l_pad = x_padded.shape
    cout, cpg, k = kernel.shape
    n1, n2 = fused_split(n)
    h = n1 // 2 + 1
    v1, v_total, nblk = _blocking(n, k, l_pad)
    v = v1 * n2
    need = (nblk - 1) * v + n
    x = TF.pad(x_padded.to(dt), (0, need - l_pad))
    a = x.unfold(2, n, v).reshape(b, cin, nblk, n1, n2)
    dot = _DOTS[mode]
    dr, di = _forward_spectrum(a, dot)  # (B, Cin, nblk, H, N2)

    # per-bin complex MAC over each out-channel's group of in-channels
    if spectra is None:
        kr, ki = kernel_spectrum(kernel.to(dt), n, n1, n2, rows=h)
    else:
        kr, ki = spectra.real.to(dt), spectra.imag.to(dt)
    kr = kr.reshape(groups, cout // groups, h, cpg, n2)
    ki = ki.reshape(groups, cout // groups, h, cpg, n2)
    dr = dr.reshape(b, groups, cpg, nblk, h, n2)
    di = di.reshape(b, groups, cpg, nblk, h, n2)
    mac = "bgcnhk,gohck->bgonhk"
    yr = torch.einsum(mac, dr, kr) - torch.einsum(mac, di, ki)
    yi = torch.einsum(mac, dr, ki) + torch.einsum(mac, di, kr)
    yr = yr.reshape(b, cout, nblk, h, n2)
    yi = yi.reshape(b, cout, nblk, h, n2)

    out = _inverse_valid(yr, yi, v1, dot)  # (B, Cout, nblk, V1, N2)
    return out.reshape(b, cout, nblk * v)[:, :, :v_total]


@lru_cache(maxsize=None)
def _device_consts(n1: int, device: torch.device):
    """The kernel's factors as complex64 tensors on ``device``: (fac, tw).
    ``fac`` is one vector in the order csrc/fused1d.cu reads it: for the
    column split (A, B) = ``_COL_SPLITS[n1]`` and then the row split
    ``_ROW_SPLIT``, the A roots of unity (row 1 of f1), the B roots (row 1
    of f2) and the (A, B) twiddle, row-major. ``tw`` is the (N1/2+1, 128)
    four-step twiddle. All built in float64 (``fft_factor_matrices``)."""
    parts = []
    for split in (_COL_SPLITS[n1], _ROW_SPLIT):
        f1, f2, tw = fft_factor_matrices(*split)
        parts += [f1[1], f2[1], tw.reshape(-1)]
    fac = torch.from_numpy(np.concatenate(parts).astype(np.complex64)).to(device)
    return fac, torch.complex(*_twiddle_rows(n1 // 2 + 1, torch.float32, device))


def _b_fragments(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The complex (R, R) DFT matrix ``m`` (output k, input j) as the B
    operand of csrc/fused1d.cu's ``mma.sync`` m16n8k16 products: the real
    (2R, 2R) matrix B[2j + p, 2k + q] ([[Fr, Fi], [-Fi, Fr]] by (p, q)) in
    float32, split into hi = bf16(B) and lo = bf16(B - hi), each laid out as
    the fragments the lanes read: for k-step s < R/8, n-tile u < R/4 and
    lane l (g = l // 4, t = l % 4) the two words (B[16 s + 2t, 8u + g],
    B[16 s + 2t + 1, 8u + g]) and (the same at rows + 8), the lower index in
    the low 16 bits. Returns (hi, lo) as uint32 vectors of 2 R^2 words."""
    r = m.shape[0]
    fr, fi = m.real.astype(np.float32).T, m.imag.astype(np.float32).T  # [j, k]
    big = np.empty((2 * r, 2 * r), np.float32)
    big[0::2, 0::2], big[1::2, 0::2], big[0::2, 1::2], big[1::2, 1::2] = fr, -fi, fi, fr
    t32 = torch.from_numpy(big)
    hi = t32.to(torch.bfloat16)
    lo = (t32 - hi.float()).to(torch.bfloat16)
    s, u, lane = np.meshgrid(np.arange(r // 8), np.arange(r // 4), np.arange(32), indexing="ij")
    row, col = 16 * s + 2 * (lane % 4), 8 * u + lane // 4
    out = []
    for half in (hi, lo):
        bits = half.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
        words = [bits[row + d, col] | bits[row + d + 1, col] << 16 for d in (0, 8)]
        out.append(np.stack(words, axis=-1).reshape(-1))
    return out[0], out[1]


@lru_cache(maxsize=None)
def _tc_fragments(n1: int, device: torch.device) -> torch.Tensor:
    """The tensor-core kernels' DFT matrices as one int32 tensor on
    ``device``, in the order csrc/fused1d.cu's ``TcPlan`` reads them: the
    dense N1-point DFT where the column DFT is dense (``_TC_COL_SPLITS``),
    then the 16- and 8-point DFTs of the row split ``_ROW_SPLIT`` (the
    8-point one also the factored column DFT's), each forward and then
    conjugated, each as its hi and then its lo fragments (``_b_fragments``).
    Built in float64 (``fft_factor_matrices``) and rounded to float32 before
    the split, as the plain version rounds them."""
    parts = []
    dense = () if _TC_COL_SPLITS[n1] else (n1,)
    for r in (*dense, *_ROW_SPLIT):
        f = fft_factor_matrices(r, 1)[0]
        for m in (f, np.conj(f)):
            parts += _b_fragments(m)
    return torch.from_numpy(np.concatenate(parts).view(np.int32)).to(device)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused1d")
    if lib.fused1d_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused1d_forward.argtypes = [
            p, ll, p, p, p, p, p, i, i, i, i, i, i, i, i, ll, p,
        ]
        lib.fused1d_forward.restype = i
        lib.fused1d_forward_tc.argtypes = [
            p, ll, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ll, p,
        ]
        lib.fused1d_forward_tc.restype = i
        lib.fused1d_error_string.argtypes = [i]
        lib.fused1d_error_string.restype = ctypes.c_char_p
    return lib


def _launch_fused1d(
    x_padded: torch.Tensor, spectra: torch.Tensor, n: int, groups: int, k: int,
    mode: str = "highest",
) -> torch.Tensor:
    """Runs the CUDA kernel pair of ``mode`` on ``x_padded`` (B, Cin, L)
    float32 with the one-sided conjugated spectra (Cout, N1/2+1, Cin/g, 128)
    complex64, both contiguous on one CUDA device: the FP32 pair under
    "highest" (counted in ``launches``), the tensor-core pair under "bf16x3"
    and "bf16" (``launches_tc``). Returns (B, Cout, L - K + 1)."""
    global launches, launches_tc
    if mode not in PRECISION_MODES:
        raise ValueError(f"unknown fused precision mode: {mode!r}")
    if not (x_padded.is_cuda and spectra.device == x_padded.device):
        raise ValueError("fused1d kernel: signal and spectra must be on one CUDA device")
    if x_padded.dtype != torch.float32 or spectra.dtype != torch.complex64:
        raise ValueError("fused1d kernel takes a float32 signal and complex64 spectra")
    x_padded = x_padded.contiguous()
    b, cin, l_pad = x_padded.shape
    cout, h, cpg, n2 = spectra.shape
    n1, _ = fused_split(n)
    if n1 not in _COL_SPLITS:
        raise ValueError(f"fused1d kernel: FFT size {n} is not one of {_FFT_SIZES}")
    if h != n1 // 2 + 1 or n2 != _N2 or cpg * groups != cin or cout % groups:
        raise ValueError(f"fused1d kernel: spectra {tuple(spectra.shape)} do not fit "
                         f"N={n}, Cin={cin}, groups={groups}")
    v1, v_total, nblk = _blocking(n, k, l_pad)
    per_block = _scratch_bytes_per_block(n, b, cin)
    if per_block > _SCRATCH_BUDGET:
        raise ValueError(f"fused1d kernel: one block of the batch needs {per_block} "
                         f"bytes of scratch, over {_SCRATCH_BUDGET}")
    chunk = min(nblk, _SCRATCH_BUDGET // per_block, _MAX_BLOCKS_PER_LAUNCH)

    lib = _library()
    fac, tw = _device_consts(n1, x_padded.device)
    frag = None if mode == "highest" else _tc_fragments(n1, x_padded.device)
    out = torch.empty((b, cout, v_total), device=x_padded.device, dtype=torch.float32)
    d = torch.empty((chunk, b, cin, h, _N2), device=x_padded.device, dtype=torch.complex64)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    with torch.cuda.device(x_padded.device):
        for blk0 in range(0, nblk, chunk):
            pointers = (x_padded.data_ptr(), l_pad, spectra.data_ptr())
            rest = (fac.data_ptr(), tw.data_ptr(), d.data_ptr(), out.data_ptr(), b, cin, cout,
                    groups, n1)
            blocks = (v1, blk0, min(chunk, nblk - blk0), v_total, stream)
            if frag is None:
                err = lib.fused1d_forward(*pointers, *rest, *blocks)
            else:
                err = lib.fused1d_forward_tc(*pointers, frag.data_ptr(), *rest, _TC_MODE[mode],
                                             *blocks)
            if err != 0:
                msg = lib.fused1d_error_string(err).decode()
                raise RuntimeError(f"fused1d kernel launch failed: {msg} (cudaError {err})")
            if frag is None:
                launches += 1
            else:
                launches_tc += 1
    return out


def kernel_spectra_one_sided(kernel: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's input: conjugated scrambled spectra of ``kernel``
    (Cout, Cin/g, K), rows k1 in [0, N1/2], as one interleaved complex64
    tensor (Cout, N1/2+1, Cin/g, 128) on the kernel's device."""
    n1, n2 = fused_split(n)
    kr, ki = kernel_spectrum(kernel.detach(), n, n1, n2, rows=n1 // 2 + 1)
    return torch.complex(kr.float(), ki.float()).contiguous()


def _fused_forward(
    x_padded: torch.Tensor, kernel: torch.Tensor, n: int, groups: int = 1,
    spectra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Valid correlation of ``x_padded`` with ``kernel`` at FFT size ``n``:
    the CUDA kernel pair of the precision mode (read here, at every call)
    for a CUDA tensor, the plain version of that pair for a CPU one.
    ``spectra``: a plan's baked ``kernel_spectra_one_sided``, or None to
    compute them. They are computed here, ahead of the call's record for a
    running cost analysis (``costs.record``), so that the analysis counts
    their FFTs as the aten ops they are, on the CPU as on the card; the
    record holds the kernel's own count, whichever of the two runs."""
    if x_padded.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused1d runs on CUDA or CPU tensors, got {x_padded.device}")
    if spectra is None:
        spectra = kernel_spectra_one_sided(kernel, n)
    b, cin, l_pad = x_padded.shape
    cout, _, k = kernel.shape
    mode = _PRECISION_MODE
    record = costs.IDLE
    if costs.active():
        record = costs.fused1d_record(b, cin, cout, l_pad, k, n, groups, mode)
    with record:
        if x_padded.is_cuda:
            return _launch_fused1d(x_padded.float(), spectra, n, groups, k, mode)
        return _fused_forward_reference(x_padded.float(), kernel.float(), n, groups, spectra,
                                        mode)


def _fused_bwd(x_padded, kernel, g, groups, need_dx=True, need_dw=True):
    """(dx, dw) of the valid correlation through the composed path, for a
    signal of any spatial rank (the 1D and 2D fused kernels share it)."""
    dx = dw = None
    if need_dx:
        # dx is the full convolution of g with w, i.e. conv_transpose; the
        # forward layout (Cout, Cin/g, *K) is conv_transpose's (in=Cout,
        # out/g=Cin/g, *K) layout, groups included
        dx = F.fft_conv_transpose(g, kernel, groups=groups, impl="xla")
    if need_dw:
        # dw[o, i, t] = sum_{b, s} g[b, o, s] x[b, i, s + t]: a correlation
        # with batch as the contracted channel, one per group
        b, cin = x_padded.shape[:2]
        cout = g.shape[1]
        cpg, opg = cin // groups, cout // groups
        xg = x_padded.reshape(b, groups, cpg, *x_padded.shape[2:]).movedim(0, 2)
        gg = g.reshape(b, groups, opg, *g.shape[2:]).movedim(0, 2)
        dw = torch.stack(
            [F.fft_conv(xg[i], gg[i], impl="xla") for i in range(groups)]
        )  # (groups, Cin/g, Cout/g, *K)
        dw = dw.transpose(1, 2).reshape(cout, cpg, *dw.shape[3:])
    return dx, dw


class _FusedCore(torch.autograd.Function):
    """The fused correlation with the composed path as its backward;
    ``spectra`` are a plan's baked kernel spectra (None: computed per call)."""

    @staticmethod
    def forward(ctx, x_padded, kernel, n, groups, spectra=None):
        ctx.save_for_backward(x_padded, kernel)
        ctx.groups = groups
        return _fused_forward(x_padded, kernel, n, groups, spectra)

    @staticmethod
    def backward(ctx, g):
        x_padded, kernel = ctx.saved_tensors
        dx, dw = _fused_bwd(
            x_padded, kernel, g.contiguous(), ctx.groups,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1],
        )
        return dx, dw, None, None, None


def fft_conv1d_fused(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding: int = 0,
    padding_mode: str = "constant",
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Fused 1D FFT convolution, ``ops.fft_conv`` semantics.

    Stride and dilation are wrapper transforms around the unit-stride
    kernel: the kernel is zero-stuffed before its spectrum is taken, and the
    full-resolution output is stride-sliced afterwards. Groups restrict each
    out-channel's MAC to its group's in-channels. Raises ValueError when no
    fused configuration fits (``fft_conv`` with ``impl="auto"`` then takes
    the composed path); unlike the JAX function it does not fall back.
    """
    if signal.ndim != 3 or kernel.ndim != 3:
        raise ValueError("fft_conv1d_fused expects (B, Cin, L) and (Cout, Cin/g, K)")
    padding_ = to_ntuple(padding, 1)
    kernel = F._dilate_kernel(kernel, (dilation,))
    x = F._pad_signal(signal, padding_, padding_mode)
    b, cin, l_pad = x.shape
    cout, cin_k, k = kernel.shape
    if cin_k * groups != cin:
        raise ValueError(
            f"kernel Cin/groups {cin_k} x groups {groups} != signal Cin {cin}"
        )
    if cout % groups:
        raise ValueError(f"out_channels {cout} not divisible by groups {groups}")
    if k > l_pad:
        raise ValueError("Kernel size can't be greater than actual input size")

    n = choose_fft_size(k, l_pad, cin_k, cout, batch=b, groups=groups)
    if n is None:
        raise ValueError(
            "no fused FFT configuration fits this shape (the kernel leaves no "
            "full 128-sample block of valid outputs, or the spectra or the "
            "scratch exceed the kernel's budgets); use fft_conv(impl='xla')"
        )
    out = _FusedCore.apply(x.float(), kernel.float(), n, groups)
    if stride != 1:
        out = out[:, :, ::stride]
    if bias is not None:
        out = out + bias.reshape(1, -1, 1)
    return out.to(signal.dtype)


def plan_fft_conv1d(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding: int = 0,
    signal_length: Optional[int] = None,
    cache_spectrum: bool = True,
    max_batch: int = 1,
    device: Device = None,
):
    """Returns ``fn(signal) -> out`` with the kernel baked in, on ``device``
    (the card unless ``device="cpu"``): the port of the JAX package's
    ``plan_fft_conv1d``.

    When ``signal_length`` is given and an FFT size fits a batch of
    ``max_batch``, the conjugated one-sided spectra are computed once here
    and each call runs only the signal's side. The call re-checks its batch
    and takes the composed path where it would bust the kernel's budgets
    (``cell_fits``). Otherwise (no length, no fit, or ``cache_spectrum``
    False) each call runs ``fft_conv1d_fused``, which computes the spectra
    and raises where no FFT size fits. The signal's gradient flows through
    the composed path; the baked kernel is a constant.
    """
    dev = resolve_device(device, "plans are built")
    cout, cin, k = kernel.shape
    kernel = kernel.detach().to(dev, torch.float32)
    bias = None if bias is None else bias.detach().to(dev, torch.float32)
    n = None
    if signal_length is not None:
        n = choose_fft_size(k, signal_length + 2 * padding, cin, cout, batch=max_batch)
    if n is None or not cache_spectrum:
        def unplanned(signal: torch.Tensor) -> torch.Tensor:
            if signal.device != dev:
                raise ValueError(f"plan lives on {dev}, got a signal on {signal.device}")
            return fft_conv1d_fused(signal, kernel, bias, padding=padding)

        return unplanned

    spectra = kernel_spectra_one_sided(kernel, n)

    def planned(signal: torch.Tensor) -> torch.Tensor:
        check_planned_signal(signal, (signal_length,), dev)
        if not cell_fits(n, signal.shape[0], cin, cout):
            # this batch busts the planned FFT size's budgets
            return F.fft_conv(signal, kernel, bias, padding=(padding,), impl="xla").to(
                signal.dtype)
        x = F._pad_signal(signal, (padding,), "constant")
        out = _FusedCore.apply(x.float(), kernel, n, 1, spectra)
        if bias is not None:
            out = out + bias.reshape(1, -1, 1)
        return out.to(signal.dtype)

    return planned


def fft_conv_transpose1d_fused(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    stride=1,
    dilation=1,
    groups: int = 1,
    output_padding=0,
) -> torch.Tensor:
    """Fused 1D transposed convolution, ``ops.fft_conv_transpose`` semantics:
    ``fft_conv1d_fused`` on the zero-stuffed signal (``F._fused_transpose``),
    the port of the JAX package's ``fft_conv_transpose1d_fused``. Raises
    ValueError where no FFT size fits the stuffed signal."""
    out = fft_conv_transpose1d_fused_if_fits(
        signal, kernel, bias, padding, stride, dilation, groups, output_padding
    )
    if out is None:
        raise ValueError(
            "no fused FFT configuration fits this shape (the stuffed signal "
            "of the transposed conv leaves no full 128-sample block of valid "
            "outputs, or the spectra or the scratch exceed the kernel's "
            "budgets); use fft_conv_transpose(impl='xla')"
        )
    return out


def fft_conv_transpose1d_fused_if_fits(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    padding=0,
    stride=1,
    dilation=1,
    groups: int = 1,
    output_padding=0,
) -> Optional[torch.Tensor]:
    """``fft_conv_transpose1d_fused``, or None when ``choose_fft_size`` finds
    no FFT size for the stuffed signal and the dilated kernel; the gate of
    ``fft_conv_transpose(impl="auto")``."""
    if signal.ndim != 3 or kernel.ndim != 3:
        raise ValueError(
            "fft_conv_transpose1d_fused expects (B, Cin, L) and (Cin, Cout/g, K)"
        )

    def forward(x, w, g):
        cout, cpg, k = w.shape
        if choose_fft_size(k, x.shape[-1], cpg, cout, batch=x.shape[0], groups=g) is None:
            return None
        return fft_conv1d_fused(x, w, groups=g)

    return F._fused_transpose(
        signal, kernel, bias, to_ntuple(padding, 1), to_ntuple(stride, 1),
        to_ntuple(dilation, 1), groups, to_ntuple(output_padding, 1), forward,
    )
