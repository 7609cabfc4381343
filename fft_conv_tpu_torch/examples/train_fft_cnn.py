"""Example: training a small FFT-convolution network.

Two ``FFTConv1d`` layers with a ReLU between them, a mean-squared-error
loss and ``torch.optim.SGD``, five steps. On the card each forward runs
kernel B1 once per layer; the backward runs the composed ``torch.fft``
path.

The port of ``examples/train_fft_cnn.py``. That script's docstring also
promises a sharded run, which its code never makes; this one makes none
either (the sharded convolution is ``fft_conv_tpu_torch.parallel``).

Run: python -m fft_conv_tpu_torch.examples.train_fft_cnn
"""

from typing import Mapping, Optional

import numpy as np
import torch

from fft_conv_tpu_torch import FFTConv1d
from fft_conv_tpu_torch.utils.convert import module_from_jax_state
from fft_conv_tpu_torch.utils.device import Device, resolve_device


def run(device: Device = None, batch: int = 4, length: int = 4096, kernel_size: int = 65,
        hidden: int = 8, steps: int = 5, lr: float = 1e-2, seed: int = 0,
        state: Optional[Mapping[str, np.ndarray]] = None) -> dict:
    """Trains the script's network on ``device`` (the card unless
    ``device="cpu"``): the inputs ("x", "target"), the parameters before
    the first step as numpy arrays ("initial_state"), each step's loss
    ("losses", before that step's update) and the trained network
    ("model", a ``ModuleDict`` of "conv1" and "conv2"). ``state``, the JAX
    script's model as one flat dict of numpy arrays ("conv1.weight",
    "conv1.bias", "conv2.weight", "conv2.bias"), sets the parameters;
    without it they come from the port's init with one ``torch.Generator``
    seeded with ``seed``."""
    dev = resolve_device(device, "the example runs")
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    pad = kernel_size // 2
    model = torch.nn.ModuleDict({
        "conv1": FFTConv1d(3, hidden, kernel_size, padding=pad, device=dev, generator=gen),
        "conv2": FFTConv1d(hidden, 1, kernel_size, padding=pad, device=dev, generator=gen),
    })
    if state is not None:
        module_from_jax_state(model, state)
    initial_state = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}

    x = torch.from_numpy(rng.standard_normal((batch, 3, length)).astype(np.float32)).to(dev)
    target = torch.from_numpy(
        rng.standard_normal((batch, 1, length)).astype(np.float32)).to(dev)

    def forward(m, x):
        h = torch.relu(m["conv1"](x))
        return m["conv2"](h)

    opt = torch.optim.SGD(model.parameters(), lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.mean((forward(model, x) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return {"x": x, "target": target, "initial_state": initial_state, "losses": losses,
            "model": model}


def main():
    for step, loss in enumerate(run()["losses"]):
        print(f"step {step}: loss {loss:.4f}")


if __name__ == "__main__":
    main()
