"""Torch-compatible parameter initialization.

``torch.nn.ConvNd`` initializes weights with ``kaiming_uniform_(a=sqrt(5))``
and biases with ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``. With a = sqrt(5),
kaiming-uniform's bound also reduces to exactly ``1/sqrt(fan_in)``:

    gain  = sqrt(2 / (1 + a^2)) = sqrt(1/3)
    bound = sqrt(3) * gain / sqrt(fan_in) = 1 / sqrt(fan_in)

``fan_in`` is dim 1 of the weight times the receptive field: (Cin/g)*prod(k)
for conv weights (Cout, Cin/g, *k) and (Cout/g)*prod(k) for transposed
weights (Cin, Cout/g, *k). Values are drawn from an explicit
``torch.Generator`` on the CPU and then moved, so a seed gives the same
parameters on every device.
"""

import math
from typing import Optional, Sequence, Tuple

import torch


def conv_fan_in(weight_shape: Sequence[int]) -> int:
    receptive = 1
    for k in weight_shape[2:]:
        receptive *= k
    return weight_shape[1] * receptive


def init_conv_params(
    generator: torch.Generator,
    weight_shape: Sequence[int],
    use_bias: bool,
    out_channels: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (weight, bias-or-None) with torch ConvNd's default init."""
    fan_in = conv_fan_in(weight_shape)
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    def uniform(shape):
        u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
        return (u * (2 * bound) - bound).to(device=device, dtype=dtype)

    weight = uniform(weight_shape)
    bias = uniform((out_channels,)) if use_bias else None
    return weight, bias
