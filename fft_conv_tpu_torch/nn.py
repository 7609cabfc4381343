"""nn API alias, mirroring ``fft_conv_tpu/nn.py``.

The module implementations live in ``fft_conv_tpu_torch.models.modules``.
The port provides the 1D and 2D layers so far.
"""

from .models.modules import (
    FFTConv1d,
    FFTConv2d,
    FFTConvTranspose1d,
    FFTConvTranspose2d,
    _FFTConvForward,
    _FFTConvTransposeForward,
)

__all__ = ["FFTConv1d", "FFTConv2d", "FFTConvTranspose1d", "FFTConvTranspose2d"]
