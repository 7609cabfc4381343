"""Functional API alias, mirroring ``fft_conv_tpu/functional.py``.

The implementation lives in ``fft_conv_tpu_torch.ops.functional``.
"""

from .ops.functional import complex_matmul, fft_conv, fft_conv_transpose
from .utils.shapes import to_ntuple

__all__ = ["fft_conv", "fft_conv_transpose", "complex_matmul", "to_ntuple"]
