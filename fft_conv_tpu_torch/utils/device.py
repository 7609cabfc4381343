"""Where the port's entry points put their tensors.

The port runs on the card: ``device=None`` means ``"cuda"``, and asking for
the card where there is none raises, so that nothing quietly runs on the
CPU. The CPU is there for whoever asks for it by name (``device="cpu"``),
as the tests do.
"""

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device, what: str) -> torch.device:
    """``device`` as a ``torch.device``, ``None`` meaning the card (the
    current one when no index is given). Raises RuntimeError for a CUDA
    device when there is none; ``what`` names the caller in the message."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device: {what} on the card unless device='cpu' is passed"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_planned_signal(signal: torch.Tensor, spatial, device: torch.device) -> None:
    """Raises ValueError unless ``signal`` has the spatial shape a plan
    serves and lies on the plan's device."""
    if tuple(signal.shape[2:]) != tuple(spatial):
        raise ValueError(
            f"plan serves spatial shape {tuple(spatial)}, got {tuple(signal.shape[2:])}"
        )
    if signal.device != device:
        raise ValueError(f"plan lives on {device}, got a signal on {signal.device}")
