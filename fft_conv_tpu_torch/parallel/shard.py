"""Data- and tensor-parallel FFT convolution over a ``torch.distributed`` mesh.

The port's counterpart of ``fft_conv_tpu/parallel/shard.py``. Where the JAX
package runs its body under ``shard_map``, each rank here runs the port's
``fft_conv`` (or ``fft_conv_transpose``) on its local block: the same SPMD
decomposition, which FFT convolution admits over (batch, groups,
out-channels) with no collective in the forward, except the in-channel
mode, which sums partial outputs once.

Parallel modes composed by one mesh:
  * data dimension  — batch sharding (always collective-free)
  * model dimension — one of:
      - out-channel sharding (groups == 1), collective-free
      - whole-group sharding (model divides groups), collective-free; the
        signal's channel axis is sharded alongside
      - in-channel sharding (tp_mode="in", groups == 1): each rank
        convolves its slice of in-channels, then one all-reduce over the
        model dimension sums the partial outputs

Inputs are plain global tensors (the same on every rank) or DTensors; the
output is a DTensor placed as the JAX package's output spec. A dimension of
size 1 counts as absent, as in the JAX package. Gradients reach the global
inputs whole on every rank: a replicated input's local gradient is partial
over the dimensions that split the work, and is summed over them in the
backward, as JAX sums a replicated input's cotangent.
"""

from typing import Dict, Iterable, Optional, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Shard

from ..ops.functional import fft_conv, fft_conv_transpose
from ..utils.shapes import to_ntuple
from .sharding import _on, _place

IntOrTuple = Union[int, Iterable[int]]


def _tp_plan(groups: int, cin: int, cout: int, model_size: int, tp_mode: str):
    """Returns (signal_channel_sharded, local_groups) and validates."""
    if tp_mode not in ("in", "out"):
        raise ValueError(f"tp_mode must be 'in' or 'out', got {tp_mode!r}")
    if model_size == 1:
        return False, groups
    if tp_mode == "in":
        if groups != 1:
            raise ValueError("tp_mode='in' supports groups == 1 only")
        if cin % model_size:
            raise ValueError(
                f"in_channels {cin} not divisible by model axis {model_size}"
            )
        return True, 1
    if groups == 1:
        if cout % model_size:
            raise ValueError(
                f"out_channels {cout} not divisible by model axis {model_size}"
            )
        return False, 1
    if groups % model_size:
        raise ValueError(
            f"groups ({groups}) must be divisible by the model axis size "
            f"({model_size}) for grouped tensor parallelism"
        )
    return True, groups // model_size


def _size(mesh: DeviceMesh, name: Optional[str]) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _axes(mesh: DeviceMesh, data_axis, model_axis, batch: int):
    """(data, model, model_size): the named dimensions of size > 1, or None.
    Raises ValueError where this rank is not part of the mesh or the batch
    does not split over the data dimension."""
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not part of the mesh")
    data = data_axis if _size(mesh, data_axis) > 1 else None
    model = model_axis if _size(mesh, model_axis) > 1 else None
    if data and batch % _size(mesh, data):
        raise ValueError(
            f"batch {batch} not divisible by data axis {_size(mesh, data)}"
        )
    return data, model, _size(mesh, model)


def _block(t, mesh: DeviceMesh, placements, split) -> Optional[torch.Tensor]:
    """This rank's block of ``t`` (a global tensor or a DTensor, or None)
    placed by ``placements`` (by dimension name). Its gradient is this
    rank's share: partial over the dimensions in ``split`` where ``t`` is
    replicated (each rank's output covers a part of the whole), summed over
    them in the backward."""
    if t is None:
        return None
    t = _place(t, mesh, _on(mesh, placements))
    grads = [
        p if p.is_shard() or name not in split else Partial()
        for name, p in zip(mesh.mesh_dim_names, t.placements)
    ]
    return t.to_local(grad_placements=grads)


def fft_conv_sharded(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrTuple = 1,
    padding: IntOrTuple = 0,
    dilation: IntOrTuple = 1,
    groups: int = 1,
    padding_mode: str = "constant",
    *,
    mesh: DeviceMesh,
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
    tp_mode: str = "out",
    impl: str = "auto",
) -> DTensor:
    """DP+TP fft_conv over a mesh. Semantics identical to ``ops.fft_conv``.

    signal (B, Cin, *s): B sharded over ``data_axis``; kernel
    (Cout, Cin/groups, *k): Cout (or Cin for tp_mode="in") sharded over
    ``model_axis``. Returns a DTensor sharded (data, model) over (B, Cout),
    or replicated over model for tp_mode="in".

    ``impl`` selects each rank's local implementation exactly as in
    ``ops.fft_conv``: batch and channel sharding never change the local
    spatial shapes, so on the card each rank launches the fused kernel the
    unsharded call would.
    """
    data, model, model_size = _axes(mesh, data_axis, model_axis, signal.shape[0])
    sig_ch_sharded, local_groups = _tp_plan(
        groups, signal.shape[1], kernel.shape[0], model_size, tp_mode
    )
    n = signal.ndim - 2
    conv_kwargs = dict(
        stride=to_ntuple(stride, n),
        padding=to_ntuple(padding, n),
        dilation=to_ntuple(dilation, n),
        groups=local_groups,
        padding_mode=padding_mode,
        impl=impl,
    )
    split = {data, model}
    if tp_mode == "in" and model:
        s = _block(signal, mesh, {data: Shard(0), model: Shard(1)}, split)
        k = _block(kernel, mesh, {model: Shard(1)}, split)
        # the bias is added after the sum: its gradient is whole over model
        b = _block(bias, mesh, {}, {data})
        out = fft_conv(s, k, None, **conv_kwargs)
        out = DTensor.from_local(
            out, mesh, _on(mesh, {data: Shard(0), model: Partial()}), run_check=False
        )
        out_p = _on(mesh, {data: Shard(0)})
        out = out.redistribute(mesh, out_p).to_local()  # the one all-reduce
        if b is not None:
            out = out + b.to(out.dtype).reshape((1, -1) + (1,) * n)
    else:
        sig_p = {data: Shard(0), model: Shard(1)} if sig_ch_sharded else {data: Shard(0)}
        s = _block(signal, mesh, sig_p, split)
        k = _block(kernel, mesh, {model: Shard(0)}, split)
        b = _block(bias, mesh, {model: Shard(0)}, split)
        out = fft_conv(s, k, b, **conv_kwargs)
        out_p = _on(mesh, {data: Shard(0), model: Shard(1)})
    return DTensor.from_local(out, mesh, out_p, run_check=False)


def fft_conv_transpose_sharded(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrTuple = 1,
    padding: IntOrTuple = 0,
    output_padding: IntOrTuple = 0,
    dilation: IntOrTuple = 1,
    groups: int = 1,
    *,
    mesh: DeviceMesh,
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
    impl: str = "auto",
) -> DTensor:
    """DP+TP transposed fft_conv. Kernel layout (Cin, Cout/g, *k) means TP
    shards dim 1 (out-channels within each group) when groups == 1, or whole
    groups on dim 0 otherwise (mirroring ``fft_conv_sharded``); ``impl``
    selects the per-rank implementation as in ``ops.fft_conv_transpose``."""
    data, model, model_size = _axes(mesh, data_axis, model_axis, signal.shape[0])
    cout_g = kernel.shape[1]
    n = signal.ndim - 2
    sig_p: Dict[Optional[str], Placement] = {data: Shard(0)}
    ker_p: Dict[Optional[str], Placement] = {}
    local_groups = groups
    if model:
        if groups == 1:
            if cout_g % model_size:
                raise ValueError(
                    f"out_channels {cout_g} not divisible by model axis "
                    f"{model_size}"
                )
            ker_p[model] = Shard(1)
        else:
            if groups % model_size:
                raise ValueError(
                    f"groups ({groups}) must be divisible by model axis "
                    f"({model_size})"
                )
            # whole groups: the Cin rows of a group stay together (dim 0)
            sig_p[model] = Shard(1)
            ker_p[model] = Shard(0)
            local_groups = groups // model_size

    conv_kwargs = dict(
        stride=to_ntuple(stride, n),
        padding=to_ntuple(padding, n),
        output_padding=to_ntuple(output_padding, n),
        dilation=to_ntuple(dilation, n),
        groups=local_groups,
        impl=impl,
    )
    split = {data, model}
    out = fft_conv_transpose(
        _block(signal, mesh, sig_p, split),
        _block(kernel, mesh, ker_p, split),
        _block(bias, mesh, {model: Shard(0)}, split),
        **conv_kwargs,
    )
    return DTensor.from_local(
        out, mesh, _on(mesh, {data: Shard(0), model: Shard(1)}), run_check=False
    )
