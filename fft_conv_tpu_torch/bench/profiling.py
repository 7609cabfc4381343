"""Tracing and profiling helpers: the port's counterpart of
``fft_conv_tpu/bench/profiling.py``.

  * ``trace(log_dir)``: a ``torch.profiler`` trace of the block (CPU and,
    with a card, CUDA activity), written into ``log_dir`` as a Chrome trace.
  * ``cost_analysis(fn, *args)``: the flops and bytes of one call, counted
    from the aten ops it runs and the kernels' own cost records
    (``costs.record``), in place of XLA's compiled cost model.
  * ``roofline(fn, *args)``: the measured time against those counts, as
    fractions of the H100 SXM's data-sheet peaks (``costs.HBM_BYTES_PER_S``,
    ``costs.FP32_FLOPS_PER_S``).
"""

import contextlib
import math
import os
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import costs
from .harness import benchmark_chained

aten = torch.ops.aten
# the FFTs, counted at 2.5 n log2(n) per complex n-point transform, halved
# for the real-input and real-output ones
_FFTS = {aten._fft_c2c: 1.0, aten._fft_r2c: 0.5, aten._fft_c2r: 0.5}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profiles the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and writes the Chrome trace
    ``log_dir/trace.json``, which chrome://tracing or Perfetto reads."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _fft_flops(func, args, out) -> float:
    x, dims = args[0], args[1]
    sized = out if func._overloadpacket is aten._fft_c2r else x
    n = math.prod(sized.shape[d] for d in dims)
    if n <= 1:
        return 0.0
    transforms = sized.numel() // n
    return _FFTS[func._overloadpacket] * 2.5 * n * math.log2(n) * transforms


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.nbytes for t in leaves if isinstance(t, torch.Tensor))


class _AtenCounter(TorchDispatchMode):
    """Adds each aten op's flops and bytes to a tally, unless a kernel's
    record has paused it."""

    def __init__(self, tally: costs.Tally) -> None:
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.tally.paused:
            return out
        packet = func._overloadpacket
        if packet in _FFTS:
            self.tally.flops += _fft_flops(func, args, out)
        elif packet in flop_registry:
            self.tally.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.tally.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def cost_analysis(fn, *args, **kwargs) -> Dict[str, Any]:
    """Runs ``fn(*args, **kwargs)`` once and returns what it cost:
    ``"flops"`` and ``"bytes accessed"`` in all, and ``"kernels"``, the
    per-kernel records {name: {"calls", "flops", "bytes"}}.

    Counted: every aten op that runs outside the kernels, its flops by
    ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention) and the textbook 2.5 n log2(n) per complex
    n-point FFT (``_fft_c2c``; half that for ``_fft_r2c`` and ``_fft_c2r``),
    elementwise ops at no flops; its bytes as its inputs' plus its outputs'
    sizes, views at none. A fused kernel's call (B1 ... B6) counts as its
    record: the kernel's own flops and its inputs read once and outputs
    written once, the same on the card as on the CPU, where its plain
    version runs in its place and its aten ops are not counted. An unplanned
    call's kernel spectra are computed ahead of that record, so their
    transforms count as aten ops, on both devices. ``"calls"`` counts the
    wrapper's calls; a call it splits into several launches is one. The counts
    come from running the call, not from a model of the device: the bytes
    are what the ops name, not what reaches the card's memory past its
    caches. Do not call it while a CUDA graph is being captured."""
    with costs.tallying() as tally, _AtenCounter(tally):
        fn(*args, **kwargs)
    return {
        "flops": float(tally.flops),
        "bytes accessed": float(tally.bytes),
        "kernels": {name: dict(entry) for name, entry in tally.kernels.items()},
    }


def roofline(fn, *args, num_iterations: int = 8) -> Dict[str, Any]:
    """``fn(*args)``'s measured time (``benchmark_chained``) against its
    ``cost_analysis`` counts: achieved GB/s and GFLOP/s and, on the card,
    their fractions of the H100 SXM's peaks, ``hbm_fraction`` of
    ``costs.HBM_BYTES_PER_S`` and ``fp32_fraction`` of
    ``costs.FP32_FLOPS_PER_S``. On the CPU the fractions are None: a host
    time against the card's peaks means nothing. ``device`` names where the
    call ran (``args[0]``'s device)."""
    counts = cost_analysis(fn, *args)
    t = benchmark_chained(fn, *args, num_iterations=num_iterations)
    bytes_accessed, flops = counts["bytes accessed"], counts["flops"]
    out = {
        "time_s": t.mean,
        "bytes_accessed": bytes_accessed,
        "flops": flops,
        "achieved_gbps": bytes_accessed / t.mean / 1e9 if t.mean else 0.0,
        "achieved_gflops": flops / t.mean / 1e9 if t.mean else 0.0,
        "device": str(args[0].device),
    }
    on_card = args[0].is_cuda
    out["hbm_fraction"] = (out["achieved_gbps"] * 1e9 / costs.HBM_BYTES_PER_S
                           if on_card else None)
    out["fp32_fraction"] = (out["achieved_gflops"] * 1e9 / costs.FP32_FLOPS_PER_S
                            if on_card else None)
    return out
