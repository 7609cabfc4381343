from .functional import complex_matmul, fft_conv, fft_conv_transpose
from .plan import plan_fft_conv, plan_fft_conv_transpose
from .streaming import streaming_conv1d_init, streaming_conv1d_step

__all__ = [
    "fft_conv",
    "fft_conv_transpose",
    "complex_matmul",
    "plan_fft_conv",
    "plan_fft_conv_transpose",
    "streaming_conv1d_init",
    "streaming_conv1d_step",
]
