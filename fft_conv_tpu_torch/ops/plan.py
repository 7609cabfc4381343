"""Planned N-d FFT convolution: kernel spectra computed once, for serving.

The port of ``fft_conv_tpu/ops/plan.py``. A plan is built for one kernel
and one spatial shape of the signal (at model-load time, say) and called per
request; its kernel-side work is done when it is built. Plans live on a
device, the card unless ``device="cpu"`` is passed, and take signals on
that device only.

Plan tiers, most to least specialised:
  1. A 1D/2D/3D stride-1, dilation-1, groups=1 config whose fused plan fits,
     on a CUDA device, gets the fused plan with baked spectra
     (``kernels.fused{1,2,3}d.plan_fft_conv{1,2,3}d``): each call launches
     B1, B2 (or B5), or B3 (after B6 under "pk") or B4. The JAX package
     gates this tier on a TPU; the port gates it on the plan's device.
  3. Everything else bakes the kernel's conjugated ``rfftn`` spectrum and
     runs the signal's transforms per call (``torch.fft``), with any stride,
     dilation, groups and padding mode.
The JAX package's tier 2 (split re/im matmul-DFT spectra for short axes) is
not ported yet: the configs it serves take tier 3 here, which computes the
same function.
"""

from typing import Iterable, Optional, Union

import torch

from ..utils.device import Device, check_planned_signal, resolve_device
from ..utils.shapes import conv_transpose_output_shape, fft_even_shape, to_ntuple
from . import functional as F

IntOrTuple = Union[int, Iterable[int]]


def plan_fft_conv(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrTuple = 1,
    padding: IntOrTuple = 0,
    dilation: IntOrTuple = 1,
    groups: int = 1,
    padding_mode: str = "constant",
    *,
    signal_spatial: Iterable[int],
    max_batch: int = 1,
    device: Device = None,
    _fused: bool = True,
):
    """Returns ``fn(signal) -> out`` with the kernel baked in, on ``device``.

    ``signal_spatial`` fixes the spatial shape the plan serves (plans are
    shape-specialised, like FFT plans everywhere; another shape raises
    ValueError). The batch stays free; ``max_batch`` sizes the fused 1D
    plan's FFT choice for the expected batch, and its calls re-check the
    batch (see ``kernels.fused1d.plan_fft_conv1d``). ``_fused=False`` keeps
    tier 1 off (the 3D transposed plan).
    """
    n = kernel.ndim - 2
    stride_ = to_ntuple(stride, n)
    padding_ = to_ntuple(padding, n)
    dilation_ = to_ntuple(dilation, n)
    signal_spatial = tuple(int(s) for s in signal_spatial)
    if len(signal_spatial) != n:
        raise ValueError(f"signal_spatial must have {n} dims, got {len(signal_spatial)}")
    dev = resolve_device(device, "plans are built")
    padded = tuple(s + 2 * p for s, p in zip(signal_spatial, padding_))
    unit = stride_ == (1,) * n and dilation_ == (1,) * n and groups == 1

    if _fused and unit and dev.type == "cuda":
        if n == 1 and padding_mode in ("constant", "zeros"):
            from ..kernels.fused1d import choose_fft_size, plan_fft_conv1d

            if choose_fft_size(kernel.shape[-1], padded[0], kernel.shape[1], kernel.shape[0],
                               batch=max_batch) is not None:
                return plan_fft_conv1d(kernel, bias, padding=padding_[0],
                                       signal_length=signal_spatial[0],
                                       max_batch=max_batch, device=dev)
        if n == 2:
            from ..kernels.fused2d import fused2d_fits, plan_fft_conv2d

            if fused2d_fits(kernel.shape[2], kernel.shape[3], kernel.shape[1],
                            kernel.shape[0], padded):
                return plan_fft_conv2d(kernel, bias, padding=padding_,
                                       padding_mode=padding_mode,
                                       signal_hw=signal_spatial, device=dev)
        if n == 3:
            from ..kernels.fused3d import plan_3d_blocked, plan_fft_conv3d

            cout, cin, kd, kh, kw = kernel.shape
            if (kd <= padded[0] and kh <= padded[1] and kw <= padded[2]
                    and plan_3d_blocked(cin, cout, *padded, kd, kh, kw) is not None):
                return plan_fft_conv3d(kernel, bias, padding=padding_,
                                       padding_mode=padding_mode,
                                       signal_dhw=signal_spatial, device=dev)

    kernel = F._dilate_kernel(kernel.detach().to(dev, torch.float32), dilation_)
    bias = None if bias is None else bias.detach().to(dev, torch.float32)
    valid = tuple(ps - ks + 1 for ps, ks in zip(padded, kernel.shape[2:]))
    if any(v <= 0 for v in valid):
        raise ValueError("Kernel size can't be greater than actual input size")
    fft_shape = fft_even_shape(padded)
    dims = tuple(range(-n, 0))
    # tier 3: the kernel's conjugated spectrum, once; per call only the
    # signal's transforms run
    ker_fr = torch.fft.rfftn(kernel, s=fft_shape, dim=dims).conj()
    crop = (slice(None), slice(None)) + tuple(slice(0, v, t) for v, t in zip(valid, stride_))

    def planned(signal: torch.Tensor) -> torch.Tensor:
        check_planned_signal(signal, signal_spatial, dev)
        x = F._pad_signal(signal, padding_, padding_mode).float()
        sig_fr = torch.fft.rfftn(x, s=fft_shape, dim=dims)
        out = torch.fft.irfftn(F._spectral_contract(sig_fr, ker_fr, groups), s=fft_shape,
                               dim=dims)[crop]
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
        return out.to(signal.dtype)

    return planned


def plan_fft_conv_transpose(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrTuple = 1,
    padding: IntOrTuple = 0,
    output_padding: IntOrTuple = 0,
    dilation: IntOrTuple = 1,
    groups: int = 1,
    *,
    signal_spatial: Iterable[int],
    max_batch: int = 1,
    device: Device = None,
):
    """Planned transposed convolution: ``fn(signal) -> out`` with the
    transformed kernel's spectra baked in, on ``device``.

    The kernel-side transform (flip the taps, (Cin, Cout/g) -> (Cout,
    Cin/g), dilate) is done once here; then ``plan_fft_conv`` plans the full
    correlation of the zero-stuffed signal, so its tiers apply unchanged
    (in 3D tier 1 stays off, as ``fft_conv_transpose(impl="auto")`` keeps
    the 3D transposed conv on the composed path). Per call only the
    signal's side runs: the stuffing, the planned correlation and the crop.

    Arguments follow ``torch.nn.functional.conv_transpose{1,2,3}d``: kernel
    (Cin, Cout/groups, *k), signal (B, Cin, *signal_spatial).
    """
    n = kernel.ndim - 2
    stride_ = to_ntuple(stride, n)
    padding_ = to_ntuple(padding, n)
    output_padding_ = to_ntuple(output_padding, n)
    dilation_ = to_ntuple(dilation, n)
    signal_spatial = tuple(int(s) for s in signal_spatial)
    if len(signal_spatial) != n:
        raise ValueError(f"signal_spatial must have {n} dims, got {len(signal_spatial)}")
    cin = kernel.shape[0]
    if cin % groups:
        raise ValueError(f"in_channels {cin} must be divisible by groups {groups}")
    dev = resolve_device(device, "plans are built")
    k_spatial = tuple(kernel.shape[2:])
    ker = F._transpose_kernel_layout(kernel.detach().to(dev, torch.float32), groups, dilation_)
    k_dil = tuple(ker.shape[2:])
    out_shape = conv_transpose_output_shape(
        signal_spatial, k_spatial, stride_, padding_, output_padding_, dilation_
    )
    if any(o <= 0 for o in out_shape):
        raise ValueError(
            f"transposed-conv output shape {out_shape} is non-positive for "
            f"signal_spatial={signal_spatial}"
        )
    # the stuffed signal (F._stuff_full) has (s-1)*t + 1 + 2(k-1) + op
    # samples a dim; its valid correlation has out + 2 * padding, cropped to
    # [p, p + out)
    full = tuple((s - 1) * t + 2 * k - 1 + op
                 for s, t, k, op in zip(signal_spatial, stride_, k_dil, output_padding_))
    inner = plan_fft_conv(ker, bias, groups=groups, signal_spatial=full,
                          max_batch=max_batch, device=dev, _fused=(n != 3))
    crop = (slice(None), slice(None)) + tuple(
        slice(p, p + o) for p, o in zip(padding_, out_shape))

    def planned_t(signal: torch.Tensor) -> torch.Tensor:
        check_planned_signal(signal, signal_spatial, dev)
        if signal.shape[1] != cin:
            raise ValueError(f"plan serves in_channels {cin}, got {signal.shape[1]}")
        return inner(F._stuff_full(signal, k_dil, stride_, output_padding_))[crop]

    return planned_t
