"""nn API alias, mirroring ``fft_conv_tpu/nn.py``.

The module implementations live in ``fft_conv_tpu_torch.models.modules``.
"""

from .models.modules import (
    FFTConv1d,
    FFTConv2d,
    FFTConv3d,
    FFTConvTranspose1d,
    FFTConvTranspose2d,
    FFTConvTranspose3d,
    _FFTConvForward,
    _FFTConvTransposeForward,
)

__all__ = [
    "FFTConv1d",
    "FFTConv2d",
    "FFTConv3d",
    "FFTConvTranspose1d",
    "FFTConvTranspose2d",
    "FFTConvTranspose3d",
]
