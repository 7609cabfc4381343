"""Overlap-save spatially sharded FFT convolution (point-to-point halos).

The port's counterpart of ``fft_conv_tpu/parallel/overlap_save.py``. The
innermost spatial axis is sharded across the mesh's spatial dimension: each
rank FFT-convolves its local block plus a (dilated kernel - 1)-sample halo
fetched from its right neighbour with one point-to-point exchange (the
JAX package's ``lax.ppermute``). No all-to-all, no distributed FFT.

Math (valid cross-correlation, innermost axis): output index i needs signal
[i, i + K - 1]. Rank m holding block [mC, (m+1)C) therefore needs its block
plus the first K-1 samples of rank m+1's block; it then computes exactly C
valid outputs. The global result is the concatenation, cropped to the true
valid length V = S - K + 1 (the last rank's tail outputs past V are
garbage fed by the circular halo and are cropped away). Stride and bias are
applied globally afterwards, on the gathered result, which every rank
returns whole.
"""

from typing import Iterable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..ops.functional import _dilate_kernel, _freq_domain_conv, _pad_signal
from ..utils.shapes import fft_even_shape, to_ntuple
from .sharding import _on, _place

IntOrTuple = Union[int, Iterable[int]]


def _shift(t: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Sends ``t`` to global rank ``to`` and returns what global rank
    ``frm`` sent, in one batch of point-to-point calls over ``group``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, to, group),
        dist.P2POp(dist.irecv, out, frm, group),
    ]):
        req.wait()
    return out


class _Halo(torch.autograd.Function):
    """Each rank's leading samples go to its left neighbour, circularly, and
    each rank gets its right neighbour's. The backward sends the gradient of
    what was received back to its sender: the transpose of the shift."""

    @staticmethod
    def forward(ctx, lead, group, left, right):
        ctx.route = group, left, right
        return _shift(lead, group, left, right)

    @staticmethod
    def backward(ctx, grad):
        group, left, right = ctx.route
        return _shift(grad, group, right, left), None, None, None


def _local_overlap_save(block, kernel, mesh, axis_name, halo, groups):
    """Per-rank body: halo exchange + local valid FFT convolution.

    block: (B, Cin, *spatial_local), the last axis the sharded one.
    Returns (B, Cout, *valid_other, C) with C = local block length.
    """
    m = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if halo > 0:
        # my first `halo` samples go to my LEFT neighbour (i receives from i+1);
        # with one shard they are my own, as ppermute's perm [(0, 0)] gives
        lead = block[..., :halo]
        if m > 1:
            group = mesh.get_group(axis_name)
            r = mesh.get_local_rank(axis_name)
            lead = _Halo.apply(
                lead, group,
                dist.get_global_rank(group, (r - 1) % m),
                dist.get_global_rank(group, (r + 1) % m),
            )
        block = torch.cat([block, lead], dim=-1)
    fft_shape = fft_even_shape(block.shape[2:])
    out = _freq_domain_conv(block, kernel, fft_shape, groups)
    # valid crop: every spatial dim [0 : s - k + 1); the last dim yields
    # exactly C = block_len - halo outputs
    return out[(slice(None), slice(None)) + tuple(
        slice(0, s - k + 1) for s, k in zip(block.shape[2:], kernel.shape[2:]))]


def fft_conv_spatial_sharded(
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
    axis_name: str = "spatial",
) -> torch.Tensor:
    """fft_conv with the innermost spatial axis sharded over ``axis_name``.

    Semantically identical to ``ops.fft_conv``; the innermost spatial axis is
    computed blockwise per rank with a halo exchange, and every rank returns
    the whole result. The inputs are the same global tensors on every rank.
    The padded innermost axis is right-padded with zeros to a multiple of
    the dimension's size; ValueError where the halo exceeds a block (use
    fewer shards or the unsharded path). Each rank runs the composed path:
    no fused kernel.
    """
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not part of the mesh")
    n = signal.ndim - 2
    padding_ = to_ntuple(padding, n)
    stride_ = to_ntuple(stride, n)
    dilation_ = to_ntuple(dilation, n)
    axis_size = mesh.size(mesh.mesh_dim_names.index(axis_name))

    kernel = _dilate_kernel(kernel, dilation_)
    signal = _pad_signal(signal, padding_, padding_mode)

    s_last = signal.shape[-1]
    k_last = kernel.shape[-1]
    if any(s < k for s, k in zip(signal.shape[2:], kernel.shape[2:])):
        raise ValueError(
            f"Kernel size can't be greater than actual input size: padded "
            f"input spatial {tuple(signal.shape[2:])} vs (dilated) kernel "
            f"{tuple(kernel.shape[2:])}"
        )

    # Right-pad the sharded axis with zeros to a multiple of the axis size.
    # Appended zeros never reach the valid region [0, s - k + 1), which is
    # computed against the *original* padded length and cropped below.
    extra = (-s_last) % axis_size
    if extra:
        signal = F.pad(signal, (0, extra))

    if k_last - 1 > (s_last + extra) // axis_size:
        raise ValueError(
            f"halo (dilated kernel - 1 = {k_last - 1}) exceeds the local "
            f"block length {(s_last + extra) // axis_size}; use fewer shards "
            f"or the unsharded path"
        )

    last = {axis_name: Shard(signal.ndim - 1)}
    # the signal's gradient is gathered whole in the backward; the kernel's
    # is this rank's share, summed over the shards
    block = _place(signal, mesh, _on(mesh, last)).to_local()
    ker = _place(kernel, mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=_on(mesh, {axis_name: Partial()})
    )
    out = _local_overlap_save(block, ker, mesh, axis_name, k_last - 1, groups)
    # every rank gets the whole; the gather's backward is a slice
    out = DTensor.from_local(out, mesh, _on(mesh, last), run_check=False).full_tensor()

    # Global valid length on the sharded axis, then stride every dim.
    out = out[(slice(None), slice(None))
              + tuple(slice(None, None, t) for t in stride_[:-1])
              + (slice(0, s_last - k_last + 1, stride_[-1]),)]

    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * n)
    return out
