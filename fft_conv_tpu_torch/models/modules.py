"""FFT-convolution layers as ``torch.nn.Module``s.

The port's counterpart of ``fft_conv_tpu/models/modules.py``. Weights and
biases are ``nn.Parameter``s in torch's layouts ((Cout, Cin/g, *k) for a
convolution, (Cin, Cout/g, *k) for a transposed one), initialized as torch's
ConvNd does (``models/init.py``) from an explicit ``torch.Generator``.
Hyperparameter validation and messages follow the JAX package.

Layers are built on the card: ``device=None`` means ``"cuda"``, and the
constructor raises when there is no CUDA device unless ``device="cpu"`` was
asked for.

The port provides the 1D, 2D and 3D layers. Every layer defaults to
``impl="auto"``, as the JAX layers do: on a CUDA signal the 1D and 2D layers,
transposed or not, and ``FFTConv3d`` run their fused kernels where a plan
fits; ``FFTConvTranspose3d`` runs the composed path, as the JAX package's
"auto" does, and its fused route (kernels B3 and B4) under
``impl="fused"``. On a CPU signal "auto" is the composed path. Any layer
runs ``impl="tiled"`` (the overlap-save tiles of ``ops/tiled.py``) on
either device.
"""

from typing import Iterable, Optional, Union

import torch
from torch import nn

from ..ops.functional import IMPLS, fft_conv, fft_conv_transpose
from ..utils.device import resolve_device
from ..utils.shapes import to_ntuple
from .init import init_conv_params

IntOrTuple = Union[int, Iterable[int]]

_CONV_PADDING_MODES = ("zeros", "reflect", "replicate", "circular")


class _FFTConvBase(nn.Module):
    """Shared hyperparameters, validation and parameters."""

    ndim: int = 1  # spatial rank; overridden per subclass
    transposed: bool = False

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: IntOrTuple,
        stride: IntOrTuple = 1,
        padding: IntOrTuple = 0,
        output_padding: IntOrTuple = 0,
        dilation: IntOrTuple = 1,
        groups: int = 1,
        bias: bool = True,
        padding_mode: str = "zeros",
        *,
        impl: str = "auto",
        generator: Optional[torch.Generator] = None,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        n = self.ndim
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if out_channels % groups != 0:
            raise ValueError("out_channels must be divisible by groups")
        if self.transposed:
            if padding_mode != "zeros":
                raise ValueError(
                    "Only 'zeros' padding mode is supported for transposed conv"
                )
        elif padding_mode not in _CONV_PADDING_MODES:
            raise ValueError(
                f"padding_mode must be one of {_CONV_PADDING_MODES}, "
                f"got {padding_mode!r}"
            )
        if impl not in IMPLS:
            raise ValueError(f"unknown impl: {impl!r}")

        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.kernel_size = to_ntuple(kernel_size, n)
        self.stride = to_ntuple(stride, n)
        self.padding = to_ntuple(padding, n)
        self.output_padding = to_ntuple(output_padding, n)
        self.dilation = to_ntuple(dilation, n)
        self.groups = int(groups)
        self.padding_mode = padding_mode
        self.impl = impl

        if self.transposed:
            weight_shape = (self.in_channels, self.out_channels // self.groups)
        else:
            weight_shape = (self.out_channels, self.in_channels // self.groups)
        weight_shape += self.kernel_size

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        weight, bias_ = init_conv_params(
            generator, weight_shape, bias, self.out_channels, dtype=dtype,
            device=resolve_device(device, "FFT convolution layers are built"),
        )
        self.weight = nn.Parameter(weight)
        self.bias = None if bias_ is None else nn.Parameter(bias_)

    def _check_input(self, signal: torch.Tensor) -> None:
        if signal.ndim != self.weight.ndim:
            raise ValueError(
                f"expected {self.weight.ndim}-d input (batched), "
                f"got {signal.ndim}-d"
            )

    def extra_repr(self) -> str:
        s = (
            f"{self.in_channels}, {self.out_channels}, "
            f"kernel_size={self.kernel_size}, stride={self.stride}, "
            f"padding={self.padding}"
        )
        if self.transposed and any(o != 0 for o in self.output_padding):
            s += f", output_padding={self.output_padding}"
        if any(d != 1 for d in self.dilation):
            s += f", dilation={self.dilation}"
        if self.groups != 1:
            s += f", groups={self.groups}"
        if self.bias is None:
            s += ", bias=False"
        if self.padding_mode != "zeros":
            s += f", padding_mode={self.padding_mode!r}"
        return s


class _FFTConvForward(_FFTConvBase):
    """Forward via ``fft_conv``."""

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        self._check_input(signal)
        # torch's "zeros" is F.pad's "constant"
        padding_mode = "constant" if self.padding_mode == "zeros" else self.padding_mode
        return fft_conv(
            signal,
            self.weight,
            bias=self.bias,
            stride=self.stride,
            padding=self.padding,
            dilation=self.dilation,
            groups=self.groups,
            padding_mode=padding_mode,
            impl=self.impl,
        )


class _FFTConvTransposeForward(_FFTConvBase):
    """Forward via ``fft_conv_transpose``."""

    transposed = True

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        self._check_input(signal)
        return fft_conv_transpose(
            signal,
            self.weight,
            bias=self.bias,
            stride=self.stride,
            padding=self.padding,
            output_padding=self.output_padding,
            dilation=self.dilation,
            groups=self.groups,
            impl=self.impl,
        )


class FFTConv1d(_FFTConvForward):
    ndim = 1


class FFTConvTranspose1d(_FFTConvTransposeForward):
    ndim = 1


class FFTConv2d(_FFTConvForward):
    ndim = 2


class FFTConvTranspose2d(_FFTConvTransposeForward):
    ndim = 2


class FFTConv3d(_FFTConvForward):
    ndim = 3


class FFTConvTranspose3d(_FFTConvTransposeForward):
    ndim = 3
