"""Streaming (chunked, stateful) 1D FFT convolution: the port's counterpart
of ``fft_conv_tpu/ops/streaming.py``.

A long signal arrives in chunks, as audio does at a server that filters it
in fixed frames. The overlap-save recurrence is an explicit state: the last
K_dilated - 1 input samples are carried between calls and every call emits
exactly one output per input sample (causal: zero history before the
stream starts).

Each step is one ``fft_conv`` (``impl="auto"``) on ``state ‖ chunk``, so a
CUDA chunk whose length the fused 1D plan fits runs kernel B1, and the
step recomputes the kernel spectra each time, as the JAX step does. The step
is differentiable through ``torch.autograd``.
"""

from typing import Optional, Tuple

import torch

from ..utils.device import Device, resolve_device
from ..utils.shapes import dilated_size
from .functional import fft_conv


def streaming_conv1d_init(
    batch: int, in_channels: int, kernel_size: int, dilation: int = 1,
    dtype: torch.dtype = torch.float32, device: Device = None,
) -> torch.Tensor:
    """Zero history (B, Cin, K_dilated - 1): the stream behaves as if
    preceded by silence. On the card unless ``device="cpu"`` is passed
    (RuntimeError without a card)."""
    device = resolve_device(device, "the stream's state is made")
    k_dil = dilated_size(kernel_size, dilation)
    return torch.zeros((batch, in_channels, k_dil - 1), dtype=dtype, device=device)


def streaming_conv1d_step(
    state: torch.Tensor,
    chunk: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dilation: int = 1,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming step: (state, chunk (B, Cin, T)) -> (y (B, Cout, T),
    state').

    Causal alignment: output sample t of the stream depends on input samples
    (t - K_dilated + 1 .. t). Concatenating all emitted chunks equals
    ``fft_conv(left_pad(x, K_dilated - 1), kernel)`` over the whole stream.
    The new state is a tensor of its own, not a view that would keep the
    whole extended chunk alive. Raises ValueError when ``state`` does not
    carry K_dilated - 1 samples.
    """
    k_dil = dilated_size(kernel.shape[-1], dilation)
    if state.shape[-1] != k_dil - 1:
        raise ValueError(
            f"state carries {state.shape[-1]} samples, kernel needs {k_dil - 1}"
        )
    ext = torch.cat([state, chunk], dim=-1)
    y = fft_conv(ext, kernel, bias, dilation=dilation, groups=groups)
    if k_dil == 1:
        return y, state
    return y, ext[..., ext.shape[-1] - (k_dil - 1):].clone(memory_format=torch.contiguous_format)
