"""Sharded FFT convolution on ``torch.distributed``: the port's counterpart
of ``fft_conv_tpu.parallel``, with a ``DeviceMesh`` for the JAX mesh, DTensor
placements for its shardings, and each rank's own ``fft_conv`` for the body
of ``shard_map``."""

from .overlap_save import fft_conv_spatial_sharded
from .shard import fft_conv_sharded, fft_conv_transpose_sharded
from .sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    conv_input_specs,
    conv_output_spec,
    make_mesh,
    shard_conv_inputs,
    transpose_input_specs,
)

__all__ = [
    "make_mesh",
    "conv_input_specs",
    "conv_output_spec",
    "shard_conv_inputs",
    "transpose_input_specs",
    "fft_conv_spatial_sharded",
    "fft_conv_sharded",
    "fft_conv_transpose_sharded",
    "DATA_AXIS",
    "MODEL_AXIS",
]
