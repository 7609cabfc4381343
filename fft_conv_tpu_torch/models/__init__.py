from .modules import (
    FFTConv1d,
    FFTConv2d,
    FFTConv3d,
    FFTConvTranspose1d,
    FFTConvTranspose2d,
    FFTConvTranspose3d,
)

__all__ = [
    "FFTConv1d",
    "FFTConv2d",
    "FFTConv3d",
    "FFTConvTranspose1d",
    "FFTConvTranspose2d",
    "FFTConvTranspose3d",
]
