"""Checkpoint and resume: the port's counterpart of
``fft_conv_tpu/utils/checkpoint.py``.

  * ``save_checkpoint`` / ``load_checkpoint``: a dependency-free ``.npz``
    with torch's key names and weight layouts, the JAX package's format, so
    a checkpoint moves between the two packages and ``torch.nn.Conv*``
    state dicts in every direction.
  * ``save_torch`` / ``load_torch``: the module's state dict through
    ``torch.save`` / ``torch.load``, in place of the JAX package's orbax
    pair, which has no torch counterpart.

``load_checkpoint`` and ``load_torch`` load in place, onto the module's own
device, and return the module, so call sites read as they do in JAX, where
loading returns a new module.
"""

from typing import Dict

import numpy as np
import torch

from .convert import module_from_jax_state


def module_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Torch-layout state dict as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def save_checkpoint(path: str, module: torch.nn.Module) -> None:
    """Writes the module's parameters to ``path`` (.npz, torch key names)."""
    np.savez(path, **module_state(module))


def load_checkpoint(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Loads the parameters in ``path`` into ``module`` on its own device and
    returns it. Accepts .npz files written by ``save_checkpoint`` in either
    package, or by ``np.savez`` from a torch ``state_dict()``. Raises
    ValueError when a name or a shape differs."""
    with np.load(path) as data:
        state = {k: data[k] for k in data.files}
    return module_from_jax_state(module, state)


def save_torch(path: str, module: torch.nn.Module) -> None:
    """Writes the module's state dict to ``path`` with ``torch.save``."""
    torch.save(module.state_dict(), path)


def load_torch(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Loads a state dict written by ``save_torch`` into ``module`` on its
    own device and returns it. Reads tensors only (``weights_only``)."""
    device = next(module.parameters()).device
    module.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return module
