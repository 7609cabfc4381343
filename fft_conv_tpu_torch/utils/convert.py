"""Carry parameters of the JAX package's modules over to the port's.

Both packages keep torch's weight layouts ((Cout, Cin/g, *k) for a
convolution, (Cin, Cout/g, *k) for a transposed one) and a (Cout,) bias, so
the conversion is a copy of numpy arrays onto a device. The caller turns the
JAX arrays into numpy (``np.asarray``); this module imports no JAX.
"""

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .device import Device, resolve_device


def _to_tensor(array, device: Device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32, copy=True)).to(device)


def params_from_jax(
    weight: np.ndarray, bias: Optional[np.ndarray], device: Device = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(weight, bias-or-None) as float32 tensors on ``device``, the card
    unless ``device="cpu"`` is passed (RuntimeError without a card)."""
    device = resolve_device(device, "parameters are carried")
    return (
        _to_tensor(weight, device),
        None if bias is None else _to_tensor(bias, device),
    )


def module_from_jax_state(
    module: torch.nn.Module, state: Mapping[str, np.ndarray]
) -> torch.nn.Module:
    """Loads a JAX module's ``state_dict`` (as numpy arrays) into ``module``.

    Raises ``ValueError`` when a shape or the presence of the bias differs;
    returns ``module`` for chaining.
    """
    own = module.state_dict()
    if set(own) != set(state):
        raise ValueError(
            f"parameter names differ: module has {sorted(own)}, "
            f"state has {sorted(state)}"
        )
    device = next(iter(own.values())).device
    loaded = {}
    for name, value in state.items():
        tensor = _to_tensor(value, device)
        if tensor.shape != own[name].shape:
            raise ValueError(
                f"{name} shape mismatch: got {tuple(tensor.shape)}, "
                f"expected {tuple(own[name].shape)}"
            )
        loaded[name] = tensor
    module.load_state_dict(loaded)
    return module
