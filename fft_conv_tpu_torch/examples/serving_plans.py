"""Example: serving with precomputed convolution plans.

The reference re-plans cuFFT (and re-flips/re-transforms transposed-conv
kernels) on every call; here a plan is an explicit object.
``plan_fft_conv`` bakes the kernel's spectra once and the returned callable
only transforms the signal: on the card a stride-1 plan that fits launches
its fused kernel (B2 here) with no spectra computed per call.
Shape-specialized, like FFT plans everywhere: one plan per served signal
geometry.

A typical inference server builds the plans at model-load time (one per
(layer, input-shape) pair) and calls them per request.

The port of ``examples/serving_plans.py``.

Run: python -m fft_conv_tpu_torch.examples.serving_plans
"""

import numpy as np
import torch

from fft_conv_tpu_torch.ops import plan_fft_conv, plan_fft_conv_transpose
from fft_conv_tpu_torch.utils.device import Device, resolve_device


def run(device: Device = None, batch: int = 4, channels: int = 3, features: int = 8,
        kernel_size: int = 15, image: int = 256, up_image: int = 128, seed: int = 0) -> dict:
    """The script's plans on ``device`` (the card unless ``device="cpu"``):
    the inputs ("bank", "bias", "images", "up_k", "small"), the plans
    ("conv", "up"), the outputs ("feats", "big", "head") and the
    wrong-shape error's message ("rejected")."""
    dev = resolve_device(device, "the example runs")
    rng = np.random.default_rng(seed)

    def tensor(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # --- forward conv: a 2D filter bank served at a fixed image size ----
    bank = tensor((features, channels, kernel_size, kernel_size))
    bias = tensor((features,))
    conv = plan_fft_conv(bank, bias, padding=kernel_size // 2,
                         signal_spatial=(image, image), device=dev)

    images = tensor((batch, channels, image, image))
    feats = conv(images)                  # batch stays free

    # --- transposed conv: a stride-2 upsampler head --------------------
    # kernel layout (Cin, Cout/groups, kh, kw), torch conv_transpose2d
    up_k = tensor((features, channels, 4, 4))
    up = plan_fft_conv_transpose(
        up_k, stride=2, padding=1, signal_spatial=(up_image, up_image), device=dev)
    small = tensor((batch, features, up_image, up_image))
    big = up(small)

    # plans are ordinary callables: compose them in one function
    def head(x):
        return up(torch.tanh(conv(x))[:, :features, :up_image, :up_image])

    composed = head(images)

    # shape-specialization is enforced loudly
    try:
        conv(torch.zeros((1, channels, image // 4, image // 4), device=dev))
        rejected = None
    except ValueError as e:
        rejected = str(e)
    return {"bank": bank, "bias": bias, "images": images, "up_k": up_k, "small": small,
            "conv": conv, "up": up, "feats": feats, "big": big, "head": composed,
            "rejected": rejected}


def main():
    r = run()
    print("planned conv:", tuple(r["images"].shape), "->", tuple(r["feats"].shape))
    print("planned transpose:", tuple(r["small"].shape), "->", tuple(r["big"].shape))
    print("composed pipeline:", tuple(r["head"].shape))
    if r["rejected"] is not None:
        print("wrong shape rejected:", r["rejected"])


if __name__ == "__main__":
    main()
