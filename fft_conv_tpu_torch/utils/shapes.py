"""Pure shape math shared by the functional core, kernels and modules.

Plain Python-int arithmetic with no framework imports. This is the port's own
copy of ``fft_conv_tpu/utils/shapes.py``: the PyTorch package imports nothing
from the JAX package, and ``tests/test_torch_shapes.py`` holds the two copies
to the same answers.

Reference parity: fft_conv_pytorch/utils.py:4-20 (to_ntuple) plus the inline
size formulas at functional.py:49-57, 66, 126-139, 143-154.
"""

from typing import Iterable, Tuple, Union

IntOrTuple = Union[int, Iterable[int]]


def to_ntuple(val: IntOrTuple, n: int) -> Tuple[int, ...]:
    """Casts ``val`` to a tuple of length ``n``.

    Ints broadcast to ``n`` copies; iterables must already have length ``n``
    (otherwise ``ValueError``), matching reference utils.py:4-20 exactly.
    """
    if isinstance(val, Iterable):
        out = tuple(int(v) for v in val)
        if len(out) != n:
            raise ValueError(f"Cannot cast tuple of length {len(out)} to length {n}.")
        return out
    return n * (int(val),)


def dilated_size(k: int, d: int) -> int:
    """Spatial extent of a kernel of size ``k`` zero-stuffed with dilation ``d``.

    Matches reference functional.py:52 (``(k - 1) * d + 1``).
    """
    return (k - 1) * d + 1


def stuffed_signal_size(s: int, k_dilated: int, stride: int) -> int:
    """Transposed-conv signal after stride-upsampling plus left full-conv pad.

    Matches reference functional.py:129 (``(s - 1) * t + 1 + (k - 1)``).
    """
    return (s - 1) * stride + 1 + (k_dilated - 1)


def fft_even_shape(sizes: Iterable[int]) -> Tuple[int, ...]:
    """Round each size up to even — the one-sided FFT wants an even last dim.

    Matches reference functional.py:66 (``(s + 1) // 2 * 2``). Note this keeps
    the FFT length ≈ signal length (circular transform); linear-conv
    correctness comes from cropping to the valid region afterwards.
    """
    return tuple((s + 1) // 2 * 2 for s in sizes)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (the composed path's "pow2" FFT policy)."""
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def conv_output_shape(
    spatial: Iterable[int],
    kernel: Iterable[int],
    stride: Iterable[int],
    padding: Iterable[int],
    dilation: Iterable[int],
) -> Tuple[int, ...]:
    """Standard conv output size: floor((s + 2p - d*(k-1) - 1)/t) + 1."""
    return tuple(
        (s + 2 * p - d * (k - 1) - 1) // t + 1
        for s, k, t, p, d in zip(spatial, kernel, stride, padding, dilation)
    )


def conv_transpose_output_shape(
    spatial: Iterable[int],
    kernel: Iterable[int],
    stride: Iterable[int],
    padding: Iterable[int],
    output_padding: Iterable[int],
    dilation: Iterable[int],
) -> Tuple[int, ...]:
    """Transposed-conv output size: (s-1)*t - 2p + d*(k-1) + o + 1.

    Matches reference functional.py:144-154.
    """
    return tuple(
        (s - 1) * t - 2 * p + d * (k - 1) + o + 1
        for s, k, t, p, d, o in zip(
            spatial, kernel, stride, padding, dilation, output_padding
        )
    )
