"""Example: 3D stencil filtering over volumes (CT denoise / PSF blur).

3D is where direct convolution's cost explodes (K^3 taps per output): a
7^3 stencil is 343 MACs per voxel. At this example's shape the padded
volume is 70^3, wider than one 64-wide W block, so ``fft_conv`` and
``FFTConv3d`` under ``impl="auto"`` run the composed ``torch.fft`` path on
either device, as the JAX package's "auto" does at this shape: it fuses
single-block plans only. ``impl="fused"`` would run kernel B3 over two W
blocks.

The port of ``examples/volume_stencil_3d.py``.

Run: python -m fft_conv_tpu_torch.examples.volume_stencil_3d
"""

from typing import Mapping, Optional

import numpy as np
import torch

from fft_conv_tpu_torch import FFTConv3d, fft_conv
from fft_conv_tpu_torch.utils.convert import module_from_jax_state
from fft_conv_tpu_torch.utils.device import Device, resolve_device


def gaussian_psf(channels: int, size: int) -> np.ndarray:
    """(channels, 1, size, size, size) separable Gaussian blur kernels
    of increasing width — a multi-scale smoothing bank."""
    g = np.mgrid[:size, :size, :size] - size // 2
    r2 = (g**2).sum(axis=0)
    out = []
    for i in range(channels):
        sigma = 0.6 + 0.5 * i
        k = np.exp(-r2 / (2 * sigma**2))
        out.append(k / k.sum())
    return np.stack(out)[:, None].astype(np.float32)


def run(device: Device = None, batch: int = 2, size: int = 64, channels: int = 4,
        kernel_size: int = 7, seed: int = 0,
        state: Optional[Mapping[str, np.ndarray]] = None) -> dict:
    """The script's calls on ``device`` (the card unless ``device="cpu"``):
    the inputs ("volumes", "psf"), the smoothed volumes ("smoothed"), the
    layer ("layer", its gradients in ``.grad`` after the loss's backward)
    and its output ("y"). ``state``, a JAX ``FFTConv3d``'s state as numpy
    arrays, sets the layer's parameters; without it they come from the
    port's init with a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device, "the example runs")
    rng = np.random.default_rng(seed)
    volumes = torch.from_numpy(
        rng.standard_normal((batch, 1, size, size, size)).astype(np.float32)).to(dev)
    psf = torch.from_numpy(gaussian_psf(channels, kernel_size)).to(dev)
    pad = kernel_size // 2

    # functional API: torch conv3d semantics, 'same' output via padding
    smoothed = fft_conv(volumes, psf, padding=pad)

    # module API: a learnable 3D layer with the same cost profile
    layer = FFTConv3d(1, channels, kernel_size, padding=pad, device=dev,
                      generator=torch.Generator().manual_seed(seed))
    if state is not None:
        module_from_jax_state(layer, state)
    with torch.no_grad():
        y = layer(volumes)

    (layer(volumes) ** 2).mean().backward()
    return {"volumes": volumes, "psf": psf, "smoothed": smoothed, "layer": layer, "y": y}


def main():
    r = run()
    print("multi-scale smoothing:", tuple(r["smoothed"].shape))  # (2, 4, 64, 64, 64)
    print("FFTConv3d forward:    ", tuple(r["y"].shape))
    print("grad weight shape:    ", tuple(r["layer"].weight.grad.shape))


if __name__ == "__main__":
    main()
