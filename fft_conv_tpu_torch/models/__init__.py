from .modules import FFTConv1d, FFTConvTranspose1d

__all__ = ["FFTConv1d", "FFTConvTranspose1d"]
