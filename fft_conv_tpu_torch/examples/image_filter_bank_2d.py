"""Example: large-kernel 2D filter bank over a batch of images.

FFT convolution shines when kernels are big (the reference's headline:
faster than direct conv for kernels over ~100 elements). This builds a
bank of large Gabor-style filters and applies it with ``fft_conv`` and
``FFTConv2d``: on the card the call runs the fused tile kernel B2, on the
CPU the composed ``torch.fft`` path. Same numbers either way.

The port of ``examples/image_filter_bank_2d.py``.

Run: python -m fft_conv_tpu_torch.examples.image_filter_bank_2d
"""

from typing import Mapping, Optional

import numpy as np
import torch

from fft_conv_tpu_torch import FFTConv2d, fft_conv
from fft_conv_tpu_torch.utils.convert import module_from_jax_state
from fft_conv_tpu_torch.utils.device import Device, resolve_device


def gabor_bank(n_filters: int, size: int) -> np.ndarray:
    """(n_filters, 1, size, size) oriented band-pass filters."""
    y, x = np.mgrid[-(size // 2):size - size // 2, -(size // 2):size - size // 2]
    out = []
    for i in range(n_filters):
        theta = np.pi * i / n_filters
        u = x * np.cos(theta) + y * np.sin(theta)
        v = -x * np.sin(theta) + y * np.cos(theta)
        g = np.exp(-(u**2 + v**2) / (2 * (size / 6) ** 2)) * np.cos(
            2 * np.pi * u / (size / 3)
        )
        out.append(g / np.abs(g).sum())
    return np.stack(out)[:, None].astype(np.float32)


def run(device: Device = None, batch: int = 2, size: int = 512, n_filters: int = 8,
        kernel_size: int = 31, seed: int = 0,
        state: Optional[Mapping[str, np.ndarray]] = None) -> dict:
    """The script's calls on ``device`` (the card unless ``device="cpu"``):
    the inputs ("images", "bank"), the bank's responses ("responses"), the
    layer ("layer", its gradients in ``.grad`` after the loss's backward)
    and its output ("y"). ``state``, a JAX ``FFTConv2d``'s state as numpy
    arrays, sets the layer's parameters; without it they come from the
    port's init with a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device, "the example runs")
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        rng.standard_normal((batch, 1, size, size)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(gabor_bank(n_filters, kernel_size)).to(dev)
    pad = kernel_size // 2

    # functional API: torch conv2d semantics, 'same' output via padding
    responses = fft_conv(images, bank, padding=pad)

    # module API: a learnable layer with the same cost profile
    layer = FFTConv2d(1, n_filters, kernel_size, padding=pad, device=dev,
                      generator=torch.Generator().manual_seed(seed))
    if state is not None:
        module_from_jax_state(layer, state)
    with torch.no_grad():
        y = layer(images)

    # gradients: the forward runs the same kernel, the backward the
    # composed path
    (layer(images) ** 2).mean().backward()
    return {"images": images, "bank": bank, "responses": responses, "layer": layer, "y": y}


def main():
    r = run()
    print("filter-bank responses:", tuple(r["responses"].shape))  # (2, 8, 512, 512)
    print("FFTConv2d forward:   ", tuple(r["y"].shape))
    print("grad weight shape:   ", tuple(r["layer"].weight.grad.shape))


if __name__ == "__main__":
    main()
