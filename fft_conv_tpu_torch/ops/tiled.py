"""Tiled (overlap-save) spectral convolution: the port of
``fft_conv_tpu/ops/tiled.py``.

A whole-signal DFT-matmul convolution pays O(N) product flops per output
sample per axis. Overlap-save tiling cuts that to O(T) with tile size
T << N, at the price of (T / (T-K+1))^d overlap redundancy.
It is the N-d analog of B1's overlap-save blocks, in plain torch ops, so it
composes with every fft_conv feature (groups, stride, dilation, transpose,
any rank) and differentiates through autograd:

    pad right -> stack overlapping tiles (``Tensor.unfold``, a view) ->
    per-tile rfftn as DFT products -> per-bin grouped MAC -> per-tile
    irfftn -> crop each tile's leading valid V samples -> reassemble

``fft_conv(impl="tiled")`` and ``fft_conv_transpose(impl="tiled")`` run it
with the tiles ``plan_tiles`` picks. The cost model and its weights are
the JAX package's, fit to a TPU sweep: ``plan_tiles`` returns exactly its
tuple. The JAX package's ``auto`` asks the same model whether tiling beats
one whole-signal transform (``tiling_wins``) on a TPU; the port's ``auto``
never tiles, so that predicate is not carried.
"""

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .spectral import irfftn_matmul, rfftn_matmul

# Candidate tile FFT lengths per axis. Any even length works (dense DFT
# matrices, no radix constraint); the plan search minimizes a flops+bytes
# cost over them. "Whole axis" (single tile) is always a candidate, so the
# planner degrades to the untiled path.
_TILE_CANDIDATES = (
    32, 48, 64, 96, 128, 160, 192, 256, 320, 384, 512, 768, 1024, 1536, 2048,
)

# The JAX package's cost weights: product flops against the bytes of the
# tile extraction and reassembly copies, calibrated there against a TPU
# tile-size sweep. Kept unchanged so the port plans the same tiles.
_BYTES_TO_FLOPS = 10.0


def _axis_cost(t: int) -> float:
    """Per-sample product work of transforming one axis of length t,
    floored at 128 (the TPU's matrix unit width, as in the JAX package)."""
    return float(max(t, 128))


def untiled_shape(
    spatial: Tuple[int, ...],
    kernel: Tuple[int, ...],
    out_len: Tuple[int, ...],
) -> Tuple[int, ...]:
    """Per-axis length of the single transform covering all of out_len
    (even-rounded): the planner's untiled candidate AND the composed path's
    FFT shape for the same problem."""
    return tuple(
        (s + max(0, o - (s - k + 1)) + 1) // 2 * 2
        for s, k, o in zip(spatial, kernel, out_len)
    )


@lru_cache(maxsize=None)
def plan_tiles(
    spatial: Tuple[int, ...],
    kernel: Tuple[int, ...],
    out_len: Tuple[int, ...],
    channels: Tuple[int, int, int],
) -> Tuple[Tuple[int, ...], float, float]:
    """Chooses per-axis tile FFT sizes minimizing the modeled cost.

    Returns (tile_shape, tiled_cost, whole_cost); tile_shape[i] is the
    whole-axis FFT length when tiling that axis doesn't pay. Costs compare
    plans of the same problem only.

    spatial: padded signal spatial shape; kernel: dilated kernel spatial
    shape; out_len: required output samples per axis; channels:
    (batch, cin, cout).
    """
    b, cin, cout = channels
    n = len(spatial)
    # the untiled candidate covers ALL requested outputs in one transform:
    # past the natural valid size (the transposed conv's zero extension)
    # it is longer, exactly the composed path's FFT length
    whole = untiled_shape(spatial, kernel, out_len)

    def plan_cost(ts: Sequence[int]) -> float:
        nt = []
        for t, k, v in zip(ts, kernel, out_len):
            vt = t - k + 1
            if vt < 1:
                return float("inf")
            nt.append(-(-v // vt))
        ntiles = int(np.prod(nt))
        tvol = int(np.prod(ts))
        # spectra memory guard: split re/im f32 spectra for all tiles of
        # both operands must stay well under device memory
        if ntiles * tvol * b * (cin + cout) * 8 > 2 * 2**30:
            return float("inf")
        # forward transforms on cin instances + inverse on cout, each axis a
        # product contracting T_i over the tile volume
        flops = b * (cin + cout) * ntiles * tvol * sum(_axis_cost(t) for t in ts)
        # MAC: one complex multiply-accumulate per bin per (b, cout, cin_g)
        flops += 8 * b * cout * cin * ntiles * tvol // 2
        # tile extraction + one spectra round trip + reassembly, f32
        tiled_bytes = 4 * ntiles * tvol * b * 2 * (cin + cout)
        return flops + tiled_bytes * _BYTES_TO_FLOPS

    whole_cost = plan_cost(whole)
    best = whole
    best_cost = whole_cost
    # greedy per-axis refinement around the cross product (converges for
    # this separable-ish cost and avoids the full candidate^n sweep)
    cands = [
        sorted(
            {t for t in _TILE_CANDIDATES if kernel[i] < t < whole[i]}
            | {whole[i]}
        )
        for i in range(n)
    ]
    cur = list(whole)
    for _ in range(3):
        changed = False
        for i in range(n):
            for t in cands[i]:
                trial = cur.copy()
                trial[i] = t
                c = plan_cost(trial)
                if c < best_cost:
                    best, best_cost = tuple(trial), c
                    cur = trial
                    changed = True
        if not changed:
            break
    return best, best_cost, whole_cost


def _window_axis(x: torch.Tensor, axis: int, tile: int, valid: int, nt: int) -> torch.Tensor:
    """Split ``axis`` into (nt, tile) overlapping windows: window j covers
    [j*valid, j*valid + tile), zero-padded past the end (the zero extension
    the transposed caller relies on). The axis is cut or right-padded to
    (nt-1)*valid + tile, then ``unfold`` takes the windows as a view; one
    tile when nt == 1, and any overlap, tile > 2*valid included."""
    need = (nt - 1) * valid + tile
    s = x.shape[axis]
    if need > s:
        x = F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [0, need - s])
    elif need < s:
        x = x.narrow(axis, 0, need)
    return x.unfold(axis, tile, valid).movedim(-1, axis + 1)


def _stack_tiles(
    x: torch.Tensor,
    tile: Sequence[int],
    valid: Sequence[int],
    nt: Sequence[int],
) -> torch.Tensor:
    """(B, C, *S) -> (B, C, *nt, *tile): overlapping windows, axis by axis."""
    n = len(tile)
    for i in range(n):
        x = _window_axis(x, 2 + 2 * i, tile[i], valid[i], nt[i])
    # (B, C, nt1, T1, nt2, T2, ...) -> (B, C, nt..., T...)
    perm = (0, 1) + tuple(2 + 2 * i for i in range(n)) + tuple(3 + 2 * i for i in range(n))
    return x.permute(perm)


def _tiled_mac(sr, si, kr, ki, groups: int, n_tile_dims: int):
    """Grouped per-bin MAC with conjugated kernel, broadcast over the tile
    dims: out = sig * conj(ker) summed over Cin/g."""
    b, cin = sr.shape[0], sr.shape[1]
    cout = kr.shape[0]
    cin_g, cout_g = cin // groups, cout // groups
    freq = sr.shape[2:]
    fbins = kr.shape[2:]
    ones = (1,) * n_tile_dims

    def xs(a):
        return a.reshape(b, groups, 1, cin_g, *freq)

    def ks(a):
        return a.reshape(1, groups, cout_g, cin_g, *ones, *fbins)

    xr, xi = xs(sr), xs(si)
    wr, wi = ks(kr), ks(ki)
    out_r = (xr * wr + xi * wi).sum(dim=3).reshape(b, cout, *freq)
    out_i = (xi * wr - xr * wi).sum(dim=3).reshape(b, cout, *freq)
    return out_r, out_i


def tiled_valid_corr(
    signal: torch.Tensor,
    kernel: torch.Tensor,
    groups: int = 1,
    out_len: Optional[Tuple[int, ...]] = None,
    tile: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Valid-region cross-correlation via overlap-save DFT-matmul tiles.

    signal (B, Cin, *S) and kernel (Cout, Cin/g, *K) are already dilated and
    padded by the caller. Returns (B, Cout, *out_len), out_len defaulting to
    the valid size S-K+1; a larger out_len treats the signal as
    zero-extended (the transposed conv's crop past the valid region).
    Inputs of another dtype are computed in float32 and cast back.
    """
    n = signal.ndim - 2
    k_sp = tuple(kernel.shape[2:])
    valid_nat = tuple(signal.shape[2 + i] - k_sp[i] + 1 for i in range(n))
    out_len = tuple(out_len) if out_len is not None else valid_nat

    in_dtype = signal.dtype
    if in_dtype != torch.float32:
        signal = signal.float()
        kernel = kernel.float()

    if tile is None:
        tile, _, _ = plan_tiles(
            tuple(signal.shape[2:]), k_sp, out_len,
            (signal.shape[0], signal.shape[1], kernel.shape[0]),
        )
    vt = tuple(t - k + 1 for t, k in zip(tile, k_sp))
    # the window count covers exactly the outputs the caller keeps
    nt = tuple(-(-o // v) for o, v in zip(out_len, vt))

    x = _stack_tiles(signal, tile, vt, nt)
    sr, si = rfftn_matmul(x, tile)
    kr, ki = rfftn_matmul(kernel, tile)
    or_, oi = _tiled_mac(sr, si, kr, ki, groups, n)
    y = irfftn_matmul(or_, oi, tile)  # (B, Cout, *nt, *tile)

    # each tile's leading valid samples, stitched:
    # (B, C, nt..., vt...) -> (B, C, nt1, vt1, nt2, vt2, ...) -> reshape
    y = y[(slice(None),) * (2 + n) + tuple(slice(0, v) for v in vt)]
    perm = (0, 1) + tuple(val for i in range(n) for val in (2 + i, 2 + n + i))
    y = y.permute(perm).reshape(y.shape[0], y.shape[1], *[nt[i] * vt[i] for i in range(n)])
    y = y[(slice(None), slice(None)) + tuple(slice(0, o) for o in out_len)]
    return y.to(in_dtype)

