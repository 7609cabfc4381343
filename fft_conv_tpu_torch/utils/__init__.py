from .convert import module_from_jax_state, params_from_jax
from .shapes import (
    conv_output_shape,
    conv_transpose_output_shape,
    dilated_size,
    fft_even_shape,
    next_pow2,
    stuffed_signal_size,
    to_ntuple,
)

__all__ = [
    "to_ntuple",
    "dilated_size",
    "stuffed_signal_size",
    "fft_even_shape",
    "next_pow2",
    "conv_output_shape",
    "conv_transpose_output_shape",
    "params_from_jax",
    "module_from_jax_state",
]
