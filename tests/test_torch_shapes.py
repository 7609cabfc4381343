"""The PyTorch port's copy of the shape math against the JAX package's.

``fft_conv_tpu_torch/utils/shapes.py`` is a copy, not an import, of
``fft_conv_tpu/utils/shapes.py``; every function must give the same answer.
"""

import itertools

import pytest

from fft_conv_tpu.utils import shapes as jax_shapes
from fft_conv_tpu_torch.utils import shapes as torch_shapes


@pytest.mark.parametrize(
    "val,n", [(3, 1), (2, 3), ((4,), 1), ((1, 2), 2), ([5, 6, 7], 3), (range(2), 2)]
)
def test_to_ntuple(val, n):
    assert torch_shapes.to_ntuple(val, n) == jax_shapes.to_ntuple(val, n)


@pytest.mark.parametrize("val,n", [((1, 2), 3), ((1, 2, 3), 1)])
def test_to_ntuple_rejects_wrong_length(val, n):
    with pytest.raises(ValueError, match="Cannot cast tuple"):
        torch_shapes.to_ntuple(val, n)
    with pytest.raises(ValueError, match="Cannot cast tuple"):
        jax_shapes.to_ntuple(val, n)


@pytest.mark.parametrize("k,d", list(itertools.product([1, 2, 5, 256], [1, 2, 3])))
def test_dilated_size(k, d):
    assert torch_shapes.dilated_size(k, d) == jax_shapes.dilated_size(k, d)


@pytest.mark.parametrize("s,k,t", list(itertools.product([1, 7, 64], [1, 5], [1, 3])))
def test_stuffed_signal_size(s, k, t):
    assert torch_shapes.stuffed_signal_size(s, k, t) == jax_shapes.stuffed_signal_size(s, k, t)


@pytest.mark.parametrize("sizes", [(1,), (2, 3), (7, 8, 9), (32768,)])
def test_fft_even_shape(sizes):
    assert torch_shapes.fft_even_shape(sizes) == jax_shapes.fft_even_shape(sizes)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 127, 128, 129, 32768, 32769])
def test_next_pow2(n):
    assert torch_shapes.next_pow2(n) == jax_shapes.next_pow2(n)


CONV_CASES = list(
    itertools.product([(7,), (8, 9)], [1, 3], [1, 2], [0, 1], [1, 2])
)


@pytest.mark.parametrize("spatial,k,t,p,d", CONV_CASES)
def test_conv_output_shape(spatial, k, t, p, d):
    n = len(spatial)
    args = (spatial, (k,) * n, (t,) * n, (p,) * n, (d,) * n)
    assert torch_shapes.conv_output_shape(*args) == jax_shapes.conv_output_shape(*args)


@pytest.mark.parametrize("spatial,k,t,p,d", CONV_CASES)
@pytest.mark.parametrize("o", [0, 1])
def test_conv_transpose_output_shape(spatial, k, t, p, d, o):
    n = len(spatial)
    args = (spatial, (k,) * n, (t,) * n, (p,) * n, (o,) * n, (d,) * n)
    assert (
        torch_shapes.conv_transpose_output_shape(*args)
        == jax_shapes.conv_transpose_output_shape(*args)
    )
