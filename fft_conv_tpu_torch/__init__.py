"""fft_conv_tpu_torch — the PyTorch and CUDA port of the JAX package ``fft_conv_tpu``.

FFT convolution with torch ``conv{1,2,3}d``/``conv_transpose{1,2,3}d``
semantics, with the fused 1D, 2D and 3D FFT convolutions and the fused 3D
transposed convolution as hand-written CUDA kernels for Hopper
(``kernels/``). It imports torch and numpy, and nothing of JAX or of the JAX
package.

Public API mirrors ``fft_conv_tpu/__init__.py``: the ``functional`` and
``nn`` submodules, ``fft_conv``, ``fft_conv_transpose``, ``complex_matmul``
and the 1D, 2D and 3D layers, with every ``impl`` ("auto", "xla", "fused",
"tiled"; the overlap-save tiling is ``ops.tiled``, on the split re/im
DFT products of ``ops.spectral``). The serving plans are
``ops.plan_fft_conv`` and ``ops.plan_fft_conv_transpose``, the streaming
step ``ops.streaming_conv1d_step``, the checkpoints ``utils.checkpoint`` and
the measurement harness ``bench`` (aliased as ``benchmark_utils``), as in
the JAX package, the sharded convolution ``parallel`` (a
``torch.distributed`` device mesh, DTensor placements), the benchmark sweep
``bench.generate_benchmark_plot`` and the JAX package's five example
scripts as ``examples``.
"""

from . import functional, nn
from .__version__ import __version__
from .nn import (
    FFTConv1d,
    FFTConv2d,
    FFTConv3d,
    FFTConvTranspose1d,
    FFTConvTranspose2d,
    FFTConvTranspose3d,
)
from .ops.functional import complex_matmul, fft_conv, fft_conv_transpose

__all__ = [
    "functional",
    "nn",
    "fft_conv",
    "fft_conv_transpose",
    "complex_matmul",
    "FFTConv1d",
    "FFTConv2d",
    "FFTConv3d",
    "FFTConvTranspose1d",
    "FFTConvTranspose2d",
    "FFTConvTranspose3d",
    "__version__",
]
