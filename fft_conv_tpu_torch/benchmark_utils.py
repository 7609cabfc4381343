"""benchmark_utils alias, API-surface parity with the upstream reference and
with ``fft_conv_tpu/benchmark_utils.py``.

``from fft_conv_tpu_torch.benchmark_utils import benchmark,
_assert_almost_equal`` works like the reference's
``fft_conv_pytorch.benchmark_utils`` (benchmark_utils.py:12-63). The
implementations live in ``fft_conv_tpu_torch.bench.harness``.
"""

from .bench.harness import (
    Benchmark,
    _assert_almost_equal,
    _gcd,
    benchmark,
    benchmark_chained,
    fft_conv_bytes,
    hbm_gbps,
    measure,
)

__all__ = [
    "Benchmark",
    "measure",
    "benchmark",
    "benchmark_chained",
    "_assert_almost_equal",
    "_gcd",
    "hbm_gbps",
    "fft_conv_bytes",
]
