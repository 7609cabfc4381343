"""FFT-domain convolution / transposed convolution — composed path.

The port's counterpart of ``fft_conv_tpu/ops/functional.py``: plain
``torch.fft.rfftn``/``irfftn`` plus a grouped per-bin contraction,
differentiable through autograd. It is the port's correctness oracle and the
backward of the fused kernels (``kernels/fused1d.py``, ``kernels/fused2d.py``,
``kernels/fused3d.py``).

Semantics match the reference exactly (cited per step):
  - fft_conv:            fft_conv_pytorch/functional.py:19-89
  - fft_conv_transpose:  fft_conv_pytorch/functional.py:92-176
  - complex_matmul:      fft_conv_pytorch/functional.py:11-16

Routing (``impl=``) follows the JAX package, with "on a TPU" read as "the
signal is a CUDA tensor": ``auto`` sends a 1D, 2D or 3D CUDA signal whose
plan fits to the fused kernel (in 3D a single-W-block plan only), and a 1D
or 2D transposed conv on a CUDA signal to the fused transposed path when
the stuffed full correlation fits. ``fft_conv_transpose(impl="fused")`` runs
the fused transposed path in 1D, 2D and 3D. ``impl="tiled"`` runs the
overlap-save DFT-matmul tiling (``ops/tiled.py``) on either device; unlike
the JAX package on a TPU, ``auto`` never picks it (its cost model was fit
to a TPU). bfloat16/float16 inputs are computed in float32 and cast back.
"""

from typing import Iterable, Optional, Union

import torch
import torch.nn.functional as F

from ..utils.shapes import conv_transpose_output_shape, dilated_size, next_pow2, to_ntuple
from .tiled import plan_tiles, tiled_valid_corr, untiled_shape

# Composed-path FFT length policy:
#   "even" — reference parity: round each padded spatial size up to even
#            (reference functional.py:64-66).
#   "pow2" — round up to the next power of two. Mathematically identical
#            for the cropped valid region (appended zeros never wrap into it).
# Module-level default, overridable per call via fft_policy=.
DEFAULT_FFT_POLICY = "even"

IMPLS = ("auto", "xla", "fused", "tiled")

IntOrTuple = Union[int, Iterable[int]]

# torch F.pad vocabulary, plus the jnp.pad spellings the JAX package accepts.
_PAD_MODES = {
    "constant": "constant",
    "zeros": "constant",
    "reflect": "reflect",
    "replicate": "replicate",
    "edge": "replicate",
    "circular": "circular",
    "wrap": "circular",
}

# Per-bin contractions up to this many (batch x Cin/g x Cout/g) products run
# as one broadcast multiply + sum; larger ones go through the einsum in
# complex_matmul. The bound also caps the broadcast temporary at this many
# complex values per frequency bin.
_BROADCAST_CONTRACT_LIMIT = 4096


def _fft_length(s: int, policy: str) -> int:
    if policy == "even":
        return (s + 1) // 2 * 2
    if policy == "pow2":
        return next_pow2(s)
    raise ValueError(f"unknown fft_policy: {policy!r}")


def complex_matmul(a: torch.Tensor, b: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Per-frequency-bin grouped channel contraction.

    ``a``: (B, Cin, *freq) complex, ``b``: (Cout, Cin/groups, *freq) complex.
    Returns (B, Cout, *freq): the reference einsum ``bgi...,goi...->bgo...``
    (functional.py:11-16).
    """
    batch = a.shape[0]
    a = a.reshape(batch, groups, a.shape[1] // groups, *a.shape[2:])
    b = b.reshape(groups, b.shape[0] // groups, b.shape[1], *b.shape[2:])
    out = torch.einsum("bgi...,goi...->bgo...", a, b)
    return out.reshape(batch, groups * out.shape[2], *out.shape[3:])


def _spectral_contract(
    sig_fr: torch.Tensor, ker_fr: torch.Tensor, groups: int
) -> torch.Tensor:
    """Grouped per-bin contraction; math identical to ``complex_matmul``."""
    batch, cin = sig_fr.shape[0], sig_fr.shape[1]
    cout = ker_fr.shape[0]
    cin_g, cout_g = cin // groups, cout // groups
    freq = sig_fr.shape[2:]
    if batch * cin_g * cout_g <= _BROADCAST_CONTRACT_LIMIT:
        a = sig_fr.reshape(batch, groups, 1, cin_g, *freq)
        b = ker_fr.reshape(1, groups, cout_g, cin_g, *freq)
        return (a * b).sum(dim=3).reshape(batch, cout, *freq)
    return complex_matmul(sig_fr, ker_fr, groups=groups)


def _dilate_kernel(kernel: torch.Tensor, dilation) -> torch.Tensor:
    """Zero-stuff the kernel's spatial dims: size (k-1)*d + 1, taps at step d
    (reference functional.py:49-57)."""
    if all(d == 1 for d in dilation):
        return kernel
    size = tuple(kernel.shape[:2]) + tuple(
        dilated_size(k, d) for k, d in zip(kernel.shape[2:], dilation)
    )
    out = kernel.new_zeros(size)
    out[(slice(None), slice(None)) + tuple(slice(None, None, d) for d in dilation)] = kernel
    return out


def _transpose_kernel_layout(kernel: torch.Tensor, groups: int, dilation_) -> torch.Tensor:
    """The transposed conv's kernel-side transform: flip the spatial taps,
    swap the (Cin, Cout/g) group layout to (Cout, Cin/g), and dilate —
    reference functional.py:109-114."""
    k_spatial = tuple(kernel.shape[2:])
    kernel = torch.flip(kernel, dims=tuple(range(2, kernel.ndim)))
    cin, cout_per_g = kernel.shape[0], kernel.shape[1]
    kernel = kernel.reshape(groups, cin // groups, cout_per_g, *k_spatial)
    kernel = kernel.transpose(1, 2)
    kernel = kernel.reshape(groups * cout_per_g, cin // groups, *k_spatial)
    return _dilate_kernel(kernel, dilation_)


def _pad_signal(signal: torch.Tensor, padding, padding_mode: str) -> torch.Tensor:
    """Symmetric spatial padding (reference functional.py:60-62)."""
    if all(p == 0 for p in padding):
        return signal
    mode = _PAD_MODES.get(padding_mode)
    if mode is None:
        raise ValueError(f"Unsupported padding_mode: {padding_mode!r}")
    pad = []
    for p in reversed(padding):  # F.pad lists the last dim first
        pad += [p, p]
    return F.pad(signal, pad, mode=mode)


def _stuff_signal(signal: torch.Tensor, k_dil, stride_) -> torch.Tensor:
    """Interior-stuff the signal for a transposed conv: size
    (s-1)*t + 1 + (k_dil-1), samples at offset k_dil-1 step t (reference
    functional.py:126-139)."""
    size = tuple(signal.shape[:2]) + tuple(
        (s - 1) * t + 1 + (k - 1) for s, k, t in zip(signal.shape[2:], k_dil, stride_)
    )
    out = signal.new_zeros(size)
    out[
        (slice(None), slice(None))
        + tuple(slice(k - 1, None, t) for k, t in zip(k_dil, stride_))
    ] = signal
    return out


def _stuff_full(signal: torch.Tensor, k_dil, stride_, output_padding_) -> torch.Tensor:
    """The signal of a transposed conv's full correlation: stride-1 zeros
    between samples, then one ``F.pad`` with K-1 on the left and
    K-1+output_padding on the right of each spatial dim."""
    x = signal
    if any(t != 1 for t in stride_):
        x = signal.new_zeros(
            tuple(signal.shape[:2])
            + tuple((s - 1) * t + 1 for s, t in zip(signal.shape[2:], stride_))
        )
        x[(slice(None), slice(None)) + tuple(slice(None, None, t) for t in stride_)] = signal
    pad = []
    for k, op in zip(reversed(tuple(k_dil)), reversed(tuple(output_padding_))):
        pad += [k - 1, k - 1 + op]  # F.pad lists the last dim first
    return F.pad(x, pad)


def _fused_transpose(signal, kernel, bias, padding_, stride_, dilation_, groups,
                     output_padding_, forward):
    """A transposed convolution through a fused forward: the shared body of
    ``fft_conv_transpose{1,2,3}d_fused``.

    It is the full correlation of the zero-stuffed signal (``_stuff_full``)
    with the flipped, (Cin, Cout/g)-swapped, dilated kernel
    (``_transpose_kernel_layout``), cropped by ``padding`` on each side.
    ``forward(x, w, groups)`` is the rank's unit-stride fused forward; where
    it returns None (no plan fits), so does this. As in the JAX package, an
    output_padding past torch's limit is accepted.
    """
    cin = kernel.shape[0]
    if signal.shape[1] != cin:
        raise ValueError(f"kernel Cin {cin} != signal Cin {signal.shape[1]}")
    if cin % groups:
        raise ValueError(f"in_channels {cin} not divisible by groups {groups}")
    w = _transpose_kernel_layout(kernel, groups, dilation_)
    dims = list(zip(signal.shape[2:], w.shape[2:], stride_, padding_, output_padding_))
    out_shape = tuple((s - 1) * t - 2 * p + k + op for s, k, t, p, op in dims)
    if any(o < 1 for o in out_shape):
        raise ValueError(
            f"non-positive output shape {out_shape} (spatial {tuple(signal.shape[2:])}, "
            f"kernel {tuple(kernel.shape[2:])}, padding {padding_})"
        )
    out = forward(_stuff_full(signal, w.shape[2:], stride_, output_padding_), w, groups)
    if out is None:
        return None
    out = out[(slice(None), slice(None))
              + tuple(slice(p, p + o) for p, o in zip(padding_, out_shape))]
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * len(out_shape))
    return out


def _freq_domain_conv(signal, kernel, fft_shape, groups):
    """rfftn(signal) x conj(rfftn(kernel)) -> irfftn, the shared core.

    Conjugating the kernel spectrum makes this cross-correlation, matching
    torch's "convolution" convention (reference functional.py:68-75). The
    JAX package's DFT-matmul branch of this function runs only on a TPU
    and is not carried, so the port lowers it to ``torch.fft`` alone.
    """
    in_dtype = signal.dtype
    if in_dtype in (torch.bfloat16, torch.float16):
        signal = signal.float()
        kernel = kernel.float()
    dims = tuple(range(-len(fft_shape), 0))
    sig_fr = torch.fft.rfftn(signal, s=fft_shape, dim=dims)
    ker_fr = torch.fft.rfftn(kernel, s=fft_shape, dim=dims).conj()
    out_fr = _spectral_contract(sig_fr, ker_fr, groups)
    out = torch.fft.irfftn(out_fr, s=fft_shape, dim=dims)
    return out.to(in_dtype)


def _check_rank(signal, kernel, layout: str) -> int:
    if signal.ndim < 3:
        raise ValueError(
            f"signal must be (batch, channels, *spatial) with >=1 spatial "
            f"dim; got shape {tuple(signal.shape)}"
        )
    if kernel.ndim != signal.ndim:
        raise ValueError(
            f"kernel rank {kernel.ndim} != signal rank {signal.ndim}; "
            f"expected {layout} matching the signal's spatial rank"
        )
    return signal.ndim - 2


def fft_conv(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrTuple = 1,
    padding: IntOrTuple = 0,
    dilation: IntOrTuple = 1,
    groups: int = 1,
    padding_mode: str = "constant",
    impl: str = "auto",
    fft_policy: Optional[str] = None,
) -> torch.Tensor:
    """N-d convolution via FFT; fast for large kernels.

    Args match ``torch.nn.functional.conv{1,2,3}d`` plus ``padding_mode``:
      signal: (B, Cin, *spatial); kernel: (Cout, Cin/groups, *k);
      bias: (Cout,) or None.

    ``impl``: "auto" (a 1D, 2D or 3D CUDA signal with a fitting plan runs
    the fused kernel, in 3D only when W needs no overlap-save blocks; CPU
    signals take the composed path), "xla" (always the composed path; the
    name is kept from the JAX package), "fused" (require the fused path: the
    CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor;
    ValueError if no plan fits), "tiled" (overlap-save DFT-matmul tiles,
    ``ops/tiled.py``, on either device; the composed path where the tile
    plan is the whole signal). In 3D a 'v4' plan (KD <= 9) runs kernel B3
    and a 'tap' plan (KD > 9, or where v4 does not fit) kernel B4.
    """
    n = _check_rank(signal, kernel, "(out_channels, in_channels/groups, *k)")
    stride_ = to_ntuple(stride, n)
    padding_ = to_ntuple(padding, n)
    dilation_ = to_ntuple(dilation, n)

    if padding_mode not in _PAD_MODES:
        raise ValueError(f"Unsupported padding_mode: {padding_mode!r}")
    if signal.shape[1] % groups or kernel.shape[0] % groups:
        raise ValueError(
            f"in_channels {signal.shape[1]} and out_channels "
            f"{kernel.shape[0]} must both be divisible by groups {groups}"
        )
    if signal.shape[1] // groups != kernel.shape[1]:
        raise ValueError(
            f"kernel expects {kernel.shape[1]} in-channels per group, signal "
            f"has {signal.shape[1]} / groups {groups}"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    if impl == "fused" and n > 3:
        raise ValueError("impl='fused' requires 1D/2D/3D input")
    wants_fused = impl == "fused" or (impl == "auto" and signal.is_cuda)
    if wants_fused and n == 1:
        from ..kernels.fused1d import choose_fft_size, fft_conv1d_fused

        l_pad = signal.shape[-1] + 2 * padding_[0]
        k_dil = dilated_size(kernel.shape[-1], dilation_[0])
        if choose_fft_size(
            k_dil, l_pad, signal.shape[1] // groups, kernel.shape[0],
            batch=signal.shape[0], groups=groups,
        ) is not None:
            return fft_conv1d_fused(
                signal, kernel, bias, padding=padding_[0],
                padding_mode=padding_mode,
                stride=stride_[0], dilation=dilation_[0], groups=groups,
            )
        if impl == "fused":
            raise ValueError(
                "no fused FFT configuration fits this shape (the dilated "
                "kernel leaves no full 128-sample block of valid outputs at "
                "any candidate FFT size, or the spectra or the scratch "
                "exceed the kernel's budgets)"
            )
    elif wants_fused and n == 2:
        from ..kernels.fused2d import fft_conv2d_fused, fft_conv2d_fused_if_fits

        args = (signal, kernel, bias, padding_, padding_mode, stride_, dilation_, groups)
        if impl == "fused":
            return fft_conv2d_fused(*args)  # raises when no plan fits
        out = fft_conv2d_fused_if_fits(*args)
        if out is not None:
            return out
    elif wants_fused and n == 3:
        from ..kernels.fused3d import fft_conv3d_fused, fft_conv3d_fused_if_fits

        args = (signal, kernel, bias, padding_, padding_mode, stride_, dilation_, groups)
        if impl == "fused":
            return fft_conv3d_fused(*args)  # raises when no plan fits
        # auto fuses single-block plans only, as the JAX package does
        out = fft_conv3d_fused_if_fits(*args, w_blocks=False)
        if out is not None:
            return out

    return _fft_conv(
        signal, kernel, bias, stride_, padding_, dilation_, int(groups),
        padding_mode, fft_policy or DEFAULT_FFT_POLICY, impl == "tiled",
    )


def _tiles_pay(spatial, k_spatial, out_len, channels) -> bool:
    """False for a degenerate tile plan (every axis one whole transform):
    whole-axis dense DFT products are strictly worse than the FFT path, so
    ``impl="tiled"`` falls through to it, as in the JAX package."""
    tile, _, _ = plan_tiles(spatial, k_spatial, out_len, channels)
    return tile != untiled_shape(spatial, k_spatial, out_len)


def _fft_conv(
    signal, kernel, bias, stride_, padding_, dilation_, groups, padding_mode,
    fft_policy, use_tiled=False,
):
    n = signal.ndim - 2
    kernel = _dilate_kernel(kernel, dilation_)
    signal = _pad_signal(signal, padding_, padding_mode)

    valid = [signal.shape[2 + i] - kernel.shape[2 + i] + 1 for i in range(n)]
    if any(v <= 0 for v in valid):
        raise ValueError(
            f"Kernel size can't be greater than actual input size: padded "
            f"input spatial {tuple(signal.shape[2:])} vs (dilated) kernel "
            f"{tuple(kernel.shape[2:])}"
        )

    spatial, k_spatial = tuple(signal.shape[2:]), tuple(kernel.shape[2:])
    channels = (signal.shape[0], signal.shape[1], kernel.shape[0])
    if use_tiled and _tiles_pay(spatial, k_spatial, tuple(valid), channels):
        out = tiled_valid_corr(signal, kernel, groups, out_len=tuple(valid))
        out = out[(slice(None), slice(None)) + tuple(slice(None, None, t) for t in stride_)]
    else:
        # circular transform at >= signal length; the crop never touches the
        # wraparound (reference functional.py:64-66)
        fft_shape = tuple(_fft_length(s, fft_policy) for s in spatial)
        out = _freq_domain_conv(signal, kernel, fft_shape, groups)
        # crop to the valid region [0 : s-k+1 : stride] (functional.py:76-82)
        out = out[
            (slice(None), slice(None))
            + tuple(slice(0, v, t) for v, t in zip(valid, stride_))
        ]

    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * n)
    return out


def fft_conv_transpose(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrTuple = 1,
    padding: IntOrTuple = 0,
    output_padding: IntOrTuple = 0,
    dilation: IntOrTuple = 1,
    groups: int = 1,
    impl: str = "auto",
    fft_policy: Optional[str] = None,
) -> torch.Tensor:
    """N-d transposed convolution via FFT.

    Args match ``torch.nn.functional.conv_transpose{1,2,3}d``:
      signal: (B, Cin, *spatial); kernel: (Cin, Cout/groups, *k)
      (transposed-conv weight convention); bias: (Cout,) or None.

    ``impl``: "fused" runs ``fft_conv_transpose{1,2,3}d_fused``: the fused
    forward (B1, B2 or B5, B3 or B4 on a CUDA tensor, their plain versions
    on a CPU one) on the zero-stuffed signal, ValueError when no plan fits
    it. "auto" on a 1D or 2D CUDA signal runs the same route when the
    stuffed full correlation fits, and the composed path when it does not;
    on a CPU signal, and on a 3D CUDA signal, "auto" runs the composed path,
    as "xla" does and as the JAX package's "auto" does. "tiled" runs the
    overlap-save tiling on the stuffed signal (outputs [0, out + padding) of
    its zero-extended correlation, the first ``padding`` cropped), or the
    composed path where the tile plan is the whole signal.

    Reference semantics: functional.py:92-176. Kernel flip + group transpose
    turns transposed conv into a regular FFT correlation; signal interior
    zero-stuffing implements stride-upsampling plus the left full-conv pad;
    the ``padding`` argument *removes* border from the result. As in the JAX
    package, ``output_padding >= max(stride, dilation)`` is accepted (torch
    rejects it) and extends the output with the zero-extended correlation.
    """
    n = _check_rank(signal, kernel, "(in_channels, out_channels/groups, *k)")
    stride_ = to_ntuple(stride, n)
    padding_ = to_ntuple(padding, n)
    output_padding_ = to_ntuple(output_padding, n)
    dilation_ = to_ntuple(dilation, n)

    if signal.shape[1] != kernel.shape[0]:
        raise ValueError(
            f"signal in_channels {signal.shape[1]} != kernel dim 0 "
            f"{kernel.shape[0]} (transposed-conv layout is (Cin, Cout/g, *k))"
        )
    if kernel.shape[0] % groups:
        raise ValueError(
            f"in_channels {kernel.shape[0]} must be divisible by groups "
            f"{groups}"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown impl: {impl!r}")
    if impl == "fused" and n > 3:
        raise ValueError("impl='fused' requires 1D/2D/3D input")
    args = (signal, kernel, bias, padding_, stride_, dilation_, groups, output_padding_)
    if n in (1, 2) and (impl == "fused" or (impl == "auto" and signal.is_cuda)):
        if n == 1:
            from ..kernels.fused1d import (
                fft_conv_transpose1d_fused as fused,
                fft_conv_transpose1d_fused_if_fits as fused_if_fits,
            )
        else:
            from ..kernels.fused2d import (
                fft_conv_transpose2d_fused as fused,
                fft_conv_transpose2d_fused_if_fits as fused_if_fits,
            )
        if impl == "fused":
            return fused(*args)  # raises when no plan fits the stuffed signal
        out = fused_if_fits(*args)
        if out is not None:
            return out
    elif impl == "fused":
        from ..kernels.fused3d import fft_conv_transpose3d_fused

        # the plan of the stuffed volume is checked where the forward is
        # (fft_conv3d_fused_if_fits); no plan raises ValueError there
        return fft_conv_transpose3d_fused(*args)

    return _fft_conv_transpose(
        signal, kernel, bias, stride_, padding_, output_padding_, dilation_,
        int(groups), fft_policy or DEFAULT_FFT_POLICY, impl == "tiled",
    )


def _fft_conv_transpose(
    signal, kernel, bias, stride_, padding_, output_padding_, dilation_, groups,
    fft_policy, use_tiled=False,
):
    n = signal.ndim - 2
    k_spatial = tuple(kernel.shape[2:])

    kernel = _transpose_kernel_layout(kernel, groups, dilation_)
    k_dil = tuple(kernel.shape[2:])
    signal_ = _stuff_signal(signal, k_dil, stride_)

    out_shape = conv_transpose_output_shape(
        signal.shape[2:], k_spatial, stride_, padding_, output_padding_, dilation_
    )
    out_full = tuple(o + p for o, p in zip(out_shape, padding_))
    channels = (signal_.shape[0], signal_.shape[1], kernel.shape[0])
    if use_tiled and _tiles_pay(tuple(signal_.shape[2:]), k_dil, out_full, channels):
        # outputs [0, out + p) of the zero-extended correlation
        out = tiled_valid_corr(signal_, kernel, groups, out_len=out_full)
    else:
        # FFT length >= linear-conv length s + k - 1, rounded per policy;
        # "even" reproduces the reference exactly (functional.py:143). It
        # also covers the crop's end o + p: past the correlation, where
        # output_padding runs beyond it, the samples are zeros (a wrap lands
        # in the k - 1 leading zeros of the stuffed signal), as torch's
        # conv_transpose gives them
        fft_shape = tuple(
            _fft_length(max(s + k - 1, o), fft_policy)
            for s, k, o in zip(signal_.shape[2:], k_dil, out_full)
        )
        out = _freq_domain_conv(signal_, kernel, fft_shape, groups)
    # crop [p : out+p] per dim (functional.py:163-169)
    out = out[
        (slice(None), slice(None))
        + tuple(slice(p, o) for p, o in zip(padding_, out_full))
    ]

    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * n)
    return out
