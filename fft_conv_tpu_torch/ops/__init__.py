from .functional import complex_matmul, fft_conv, fft_conv_transpose

__all__ = ["fft_conv", "fft_conv_transpose", "complex_matmul"]
