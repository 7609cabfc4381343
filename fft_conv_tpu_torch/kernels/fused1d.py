"""Fused 1D FFT convolution: host side of the CUDA kernel ``csrc/fused1d.cu``.

The port's counterpart of ``fft_conv_tpu/kernels/fused1d.py``. Long signals
are processed overlap-save: blocks of FFT size N = N1 * 128 overlap by K-1
samples, and each block yields V = V1 * 128 valid outputs of the
cross-correlation (the first V samples of its circular result). Per block
the kernel runs the one-sided four-step DFT (only rows k1 in [0, N1/2] of the
scrambled spectrum, see ``_factor_consts``), a per-bin complex MAC over the
group's input channels against the conjugated kernel spectra, and the
inverse pipeline, writing only valid outputs.

On a CUDA tensor ``_fused_forward`` launches the kernel; on a CPU tensor it
runs ``_fused_forward_reference``, the same blocked pipeline written with
torch ops (the counterpart of the JAX package's Pallas interpret mode).
There is no other route: a CUDA tensor launches the kernel or raises.

Gradients: ``_FusedCore`` is a ``torch.autograd.Function`` whose backward is
two composed-path convolutions (``ops/functional.py``): dx is the transposed
convolution of the output gradient with the kernel, dw the correlation of
the signal with the output gradient, batch acting as the contracted channel.
"""

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..ops import functional as F
from ..utils.shapes import to_ntuple
from . import _build
from .fourstep import fft_factor_matrices, kernel_spectrum

_N2 = 128
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

# Launches of the CUDA kernel pair (phase 1 + phase 2) since import or the
# last reset; the plain version on CPU tensors does not count.
launches = 0


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
    ``dtype`` numpy arrays (float32 for the kernel, float64 for an oracle).
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


def _fused_forward_reference(
    x_padded: torch.Tensor, kernel: torch.Tensor, n: int, groups: int = 1
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the same blocked one-sided
    four-step pipeline in split re/im arithmetic, float64 for a float64
    signal and float32 otherwise.

    ``x_padded`` (B, Cin, L) already padded, ``kernel`` (Cout, Cin/g, K)
    already dilated; returns the valid correlation (B, Cout, L - K + 1).
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
    f1r, f1i, f2r, f2i, twr, twi, if1r, if1i, if2r, if2i = (
        torch.from_numpy(m).to(x.device)
        for m in _factor_consts(n1, n2, v1, np.float64 if dt == torch.float64 else np.float32)
    )

    # forward stage 1 (one-sided rows), twiddle, forward stage 2
    br, bi = f1r @ a, f1i @ a  # (B, Cin, nblk, H, N2)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    dr = cr @ f2r - ci @ f2i
    di = cr @ f2i + ci @ f2r

    # per-bin complex MAC over each out-channel's group of in-channels
    kr, ki = kernel_spectrum(kernel.to(dt), n, n1, n2, rows=h)
    kr = kr.reshape(groups, cout // groups, h, cpg, n2)
    ki = ki.reshape(groups, cout // groups, h, cpg, n2)
    dr = dr.reshape(b, groups, cpg, nblk, h, n2)
    di = di.reshape(b, groups, cpg, nblk, h, n2)
    mac = "bgcnhk,gohck->bgonhk"
    yr = torch.einsum(mac, dr, kr) - torch.einsum(mac, di, ki)
    yi = torch.einsum(mac, dr, ki) + torch.einsum(mac, di, kr)
    yr = yr.reshape(b, cout, nblk, h, n2)
    yi = yi.reshape(b, cout, nblk, h, n2)

    # inverse stage 1, conjugate twiddle, inverse stage 2 (valid rows)
    er = yr @ if2r - yi @ if2i
    ei = yr @ if2i + yi @ if2r
    gr = er * twr + ei * twi
    gi = ei * twr - er * twi
    out = if1r @ gr - if1i @ gi  # (B, Cout, nblk, V1, N2)
    return out.reshape(b, cout, nblk * v)[:, :, :v_total]


@lru_cache(maxsize=None)
def _device_consts(n1: int, v1: int, device: torch.device):
    """The kernel's factor matrices as interleaved complex64 tensors on
    ``device``: (f1, tw, f2, if1w, if2)."""
    f1r, f1i, f2r, f2i, twr, twi, if1r, if1i, if2r, if2i = _factor_consts(n1, _N2, v1)
    pairs = ((f1r, f1i), (twr, twi), (f2r, f2i), (if1r, if1i), (if2r, if2i))
    return tuple(
        torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)
        for re, im in pairs
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("fused1d")
    if lib.fused1d_forward.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused1d_forward.argtypes = [
            p, ll, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ll, p,
        ]
        lib.fused1d_forward.restype = i
        lib.fused1d_error_string.argtypes = [i]
        lib.fused1d_error_string.restype = ctypes.c_char_p
    return lib


def _launch_fused1d(
    x_padded: torch.Tensor, spectra: torch.Tensor, n: int, groups: int, k: int
) -> torch.Tensor:
    """Runs the CUDA kernel pair on ``x_padded`` (B, Cin, L) float32 with the
    one-sided conjugated spectra (Cout, N1/2+1, Cin/g, 128) complex64, both
    contiguous on one CUDA device. Returns (B, Cout, L - K + 1)."""
    global launches
    if not (x_padded.is_cuda and spectra.device == x_padded.device):
        raise ValueError("fused1d kernel: signal and spectra must be on one CUDA device")
    if x_padded.dtype != torch.float32 or spectra.dtype != torch.complex64:
        raise ValueError("fused1d kernel takes a float32 signal and complex64 spectra")
    x_padded = x_padded.contiguous()
    b, cin, l_pad = x_padded.shape
    cout, h, cpg, n2 = spectra.shape
    n1, _ = fused_split(n)
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
    f1, tw, f2, if1w, if2 = _device_consts(n1, v1, x_padded.device)
    out = torch.empty((b, cout, v_total), device=x_padded.device, dtype=torch.float32)
    d = torch.empty((chunk, b, cin, h, _N2), device=x_padded.device, dtype=torch.complex64)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    with torch.cuda.device(x_padded.device):
        for blk0 in range(0, nblk, chunk):
            err = lib.fused1d_forward(
                x_padded.data_ptr(), l_pad, spectra.data_ptr(), f1.data_ptr(),
                tw.data_ptr(), f2.data_ptr(), if1w.data_ptr(), if2.data_ptr(),
                d.data_ptr(), out.data_ptr(), b, cin, cout, groups, n1, v1,
                blk0, min(chunk, nblk - blk0), v_total, stream,
            )
            if err != 0:
                msg = lib.fused1d_error_string(err).decode()
                raise RuntimeError(f"fused1d kernel launch failed: {msg} (cudaError {err})")
            launches += 1
    return out


def kernel_spectra_one_sided(kernel: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's input: conjugated scrambled spectra of ``kernel``
    (Cout, Cin/g, K), rows k1 in [0, N1/2], as one interleaved complex64
    tensor (Cout, N1/2+1, Cin/g, 128) on the kernel's device."""
    n1, n2 = fused_split(n)
    kr, ki = kernel_spectrum(kernel.detach(), n, n1, n2, rows=n1 // 2 + 1)
    return torch.complex(kr.float(), ki.float()).contiguous()


def _fused_forward(
    x_padded: torch.Tensor, kernel: torch.Tensor, n: int, groups: int = 1
) -> torch.Tensor:
    """Valid correlation of ``x_padded`` with ``kernel`` at FFT size ``n``:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if x_padded.is_cuda:
        return _launch_fused1d(
            x_padded.float(), kernel_spectra_one_sided(kernel, n), n, groups,
            kernel.shape[-1],
        )
    if x_padded.device.type == "cpu":
        return _fused_forward_reference(x_padded.float(), kernel.float(), n, groups)
    raise ValueError(f"fused1d runs on CUDA or CPU tensors, got {x_padded.device}")


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
    """The fused correlation with the composed path as its backward."""

    @staticmethod
    def forward(ctx, x_padded, kernel, n, groups):
        ctx.save_for_backward(x_padded, kernel)
        ctx.groups = groups
        return _fused_forward(x_padded, kernel, n, groups)

    @staticmethod
    def backward(ctx, g):
        x_padded, kernel = ctx.saved_tensors
        dx, dw = _fused_bwd(
            x_padded, kernel, g.contiguous(), ctx.groups,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1],
        )
        return dx, dw, None, None


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
