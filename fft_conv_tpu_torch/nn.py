"""nn API alias, mirroring ``fft_conv_tpu/nn.py``.

The module implementations live in ``fft_conv_tpu_torch.models.modules``.
This slice of the port provides the 1D layers.
"""

from .models.modules import (
    FFTConv1d,
    FFTConvTranspose1d,
    _FFTConvForward,
    _FFTConvTransposeForward,
)

__all__ = ["FFTConv1d", "FFTConvTranspose1d"]
