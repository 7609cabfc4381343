"""Mesh and placement helpers: batch-DP and channel-TP for FFT convolution.

The port's counterpart of ``fft_conv_tpu/parallel/sharding.py``. A JAX
``Mesh`` becomes a ``torch.distributed`` ``DeviceMesh`` with the dimensions
("data", "model", "spatial"), and a ``NamedSharding`` becomes the list of
DTensor placements, one per mesh dimension:

  * data parallel   — shard the signal's batch axis. FFT convolution is
    embarrassingly parallel over batch: each rank convolves its block, with
    no collective.
  * tensor parallel — shard the kernel's out-channel axis (and the bias).
    Each rank computes its slice of the per-bin channel contraction; the
    in-channels stay replicated, so again no collective in the forward.

``overlap_save.py`` holds the one strategy that communicates (spatial
sharding, a point-to-point halo exchange).
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

Placements = List[Placement]


def make_mesh(
    data: int = 1,
    model: int = 1,
    spatial: int = 1,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Builds a (data, model, spatial) mesh over the first data·model·spatial
    ranks of the default process group.

    Any dimension of size 1 still exists in the mesh, so placements can
    always name it. ``device_type=None`` means the card ("cuda"), and raises
    RuntimeError without one unless ``"cpu"`` is passed. Every rank of the
    group must call this (it creates the mesh's process groups); ranks past
    the mesh's size are not part of it and take no part in the sharded
    functions. ValueError when the mesh needs more ranks than the group has.
    """
    device_type = resolve_device(device_type, "make_mesh").type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    n = data * model * spatial
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh needs {n} ranks, only {world} available")
    ranks = torch.arange(n).reshape(data, model, spatial)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS, "spatial"))


def _on(mesh: DeviceMesh, dims: Dict[Optional[str], Placement]) -> Placements:
    """Placements over ``mesh``: ``dims`` by mesh dimension name (a None
    name is no dimension), Replicate elsewhere."""
    return [dims.get(name, Replicate()) for name in mesh.mesh_dim_names]


def conv_input_specs(mesh: DeviceMesh) -> Tuple[Placements, Placements, Placements]:
    """(signal, kernel, bias) placements for combined DP+TP FFT convolution.

    signal (B, Cin, *s): batch over 'data', channels and spatial replicated.
    kernel (Cout, Cin/g, *k): out-channels over 'model'.
    bias (Cout,): over 'model', aligned with the kernel's shards.
    """
    model = _on(mesh, {MODEL_AXIS: Shard(0)})
    return _on(mesh, {DATA_AXIS: Shard(0)}), model, list(model)


def conv_output_spec(mesh: DeviceMesh) -> Placements:
    """Output (B, Cout, *s): batch over 'data', out-channels over 'model'."""
    return _on(mesh, {DATA_AXIS: Shard(0), MODEL_AXIS: Shard(1)})


def shard_conv_inputs(signal, kernel, bias, mesh: DeviceMesh):
    """Places (signal, kernel, bias) with the DP+TP placements on the mesh.

    Every rank holds the same global tensors, so each takes its own block
    locally: no collective, no broadcast. The placing is differentiable: a
    gradient reaching a placed tensor flows back to the global one.
    """
    sig_p, ker_p, bias_p = conv_input_specs(mesh)
    signal = _place(signal, mesh, sig_p)
    kernel = _place(kernel, mesh, ker_p)
    if bias is not None:
        bias = _place(bias, mesh, bias_p)
    return signal, kernel, bias


def transpose_input_specs(mesh: DeviceMesh) -> Tuple[Placements, Placements, Placements]:
    """(signal, kernel, bias) placements for DP+TP transposed FFT convolution.

    Transposed kernels are (Cin, Cout/g, *k), so the TP dimension is dim 1;
    the bias stays (Cout,) over 'model'.
    """
    return (
        _on(mesh, {DATA_AXIS: Shard(0)}),
        _on(mesh, {MODEL_AXIS: Shard(1)}),
        _on(mesh, {MODEL_AXIS: Shard(0)}),
    )


def _place(t: torch.Tensor, mesh: DeviceMesh, placements: Placements) -> DTensor:
    """``t`` as a DTensor with ``placements`` on ``mesh``.

    A plain tensor is the same global tensor on every rank: it becomes a
    replicated DTensor (no check, no broadcast) and each rank slices its
    block out of it. Replicate to Shard is a local slice, so neither needs a
    collective; a DTensor with other placements is redistributed. Raises
    ValueError for a tensor on another kind of device than the mesh, so that
    nothing moves between the card and the host unasked.
    """
    if t.device.type != mesh.device_type:
        raise ValueError(f"tensor on {t.device}, mesh on {mesh.device_type}")
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if list(t.placements) != list(placements):
        t = t.redistribute(mesh, placements)
    return t
