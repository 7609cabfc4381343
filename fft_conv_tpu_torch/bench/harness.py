"""Benchmark and measurement harness: the port's counterpart of
``fft_conv_tpu/bench/harness.py`` and of the upstream reference's
``benchmark_utils`` (``fft_conv_pytorch/benchmark_utils.py:12-63``).

On the card:
  * ``measure`` brackets a block with ``torch.cuda.synchronize()`` and reads
    the CUDA allocator's peak (``torch.cuda.max_memory_allocated()`` after a
    reset), as the upstream reference's ``measure`` does;
  * ``benchmark_chained`` times each call with CUDA events;
  * ``benchmark_fori``, a device-side ``lax.fori_loop`` timer in JAX, is a
    CUDA-graph timer: the calls captured in one graph, the graph replayed,
    the median per call (``graph_seconds``), the card's own time with no
    host work in it. ``chip_smoke.py:device_ms`` is this timer.
On the CPU the memory reading is 0.0 and the timers are host clocks around
plain loops: a CPU number is never a device time.

``hlo_peak_gib`` (the compiled executable's footprint from XLA) has no torch
counterpart; ``peak_memory_gib`` reads the allocator alone.
"""

import gc
import statistics
import time
from contextlib import contextmanager
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

# graph_seconds' protocol: eager warm-up calls (which build the caches a
# graph cannot), then the graph replayed REPLAYS times
WARMUP, REPLAYS = 5, 30


class Benchmark(NamedTuple):
    mean: float
    std: float

    def __repr__(self):
        return f"BenchmarkResult(mean: {self.mean:.3e}, std: {self.std:.3e})"

    def __str__(self):
        return f"({self.mean:.3e} ± {self.std:.3e}) s"


def _peak_gib() -> float:
    """The CUDA allocator's peak since the last reset, in GiB; 0.0 without
    a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_memory_gib(fn: Callable, *args, **kwargs) -> Tuple[float, str]:
    """(peak GiB, "cuda_allocator") of one ``fn(*args, **kwargs)`` call after
    a reset of the allocator's peak. Raises RuntimeError without a card: the
    CPU has no allocator statistics to read."""
    if not torch.cuda.is_available():
        raise RuntimeError("peak_memory_gib reads the CUDA allocator; there is no CUDA device")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    return _peak_gib(), "cuda_allocator"


@contextmanager
def measure():
    """Times a block on the host clock between two
    ``torch.cuda.synchronize()`` (when a card is present) and records the
    allocator's peak GiB over the block (0.0 on the CPU): the upstream
    reference's ``measure`` (benchmark_utils.py:23-37)."""
    gc.collect()
    _sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    result = dict()
    begin = time.perf_counter()
    try:
        yield result
    finally:
        _sync()
    result["time"] = time.perf_counter() - begin
    result["memory"] = _peak_gib()


def benchmark(
    fn: Callable, *args, num_iterations: int = 10, **kwargs
) -> Tuple[Benchmark, Benchmark]:
    """Runs ``fn`` N times under ``measure``, drops iteration 0 as warm-up
    (kernel builds, caches), returns (time, memory) Benchmarks. Reference
    benchmark_utils.py:39-50."""
    times, memory = [], []
    for _ in range(num_iterations):
        with measure() as r:
            fn(*args, **kwargs)
        times.append(r.get("time"))
        memory.append(r.get("memory"))
    return (
        Benchmark(np.mean(times[1:]).item(), np.std(times[1:]).item()),
        Benchmark(np.mean(memory[1:]).item(), np.std(memory[1:]).item()),
    )


def benchmark_chained(
    fn: Callable,
    signal: torch.Tensor,
    *rest,
    num_iterations: int = 16,
    **kwargs,
) -> Benchmark:
    """Per-call time of ``fn(signal, *rest)``, each call's first argument
    perturbed by the previous output, as the JAX version does, so that no
    two calls see the same input. The perturbation ``out.real.ravel()[0] *
    0`` stays on the device (no host sync). On a CUDA signal each call is
    timed with CUDA events, so the time is the call's latency on the card's
    clock, host enqueue included; on the CPU with the host clock."""
    cuda = signal.is_cuda
    out = fn(signal, *rest, **kwargs)  # warm-up: kernel builds, caches
    _sync()
    times = []
    for i in range(num_iterations):
        sig_i = signal + 1e-7 * (i + 1) + out.real.ravel()[0] * 0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(sig_i, *rest, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(sig_i, *rest, **kwargs)
            times.append(time.perf_counter() - t0)
    return Benchmark(np.mean(times).item(), np.std(times).item())


def graph_seconds(call: Callable, calls: int) -> Tuple[float, float]:
    """The card's own time per ``call()``: (median, std) over REPLAYS
    replays of a CUDA graph of ``calls`` calls, per call, in seconds, after
    WARMUP eager calls. ``benchmark_fori``'s timer on the card, and
    ``chip_smoke.py:device_ms``'s."""
    for _ in range(WARMUP):
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    per_call = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / 1e3 / calls)
    return statistics.median(per_call), statistics.pstdev(per_call)


def benchmark_fori(
    fn: Callable,
    signal: torch.Tensor,
    *rest,
    num_iterations: int = 20,
    **kwargs,
) -> Benchmark:
    """The card's own time per call of ``fn(signal, *rest)``: the median
    (and spread) per call over replays of one CUDA graph holding
    ``num_iterations`` calls, after warm-up calls. The calls run back to
    back on one stream, so a replay's time is their device time with no
    host work in it. Nothing on the card caches a result, so the calls need
    none of the JAX loop's perturbation, and a replay has no dispatch jitter
    to outlast, so none of its re-measuring (``min_work_s``) either.

    On a CPU signal it is a plain loop on the host clock: the mean and
    spread of ``num_iterations`` calls after one warm-up call."""
    def call():
        return fn(signal, *rest, **kwargs)

    if signal.is_cuda:
        return Benchmark(*graph_seconds(call, num_iterations))
    call()
    times = []
    for _ in range(num_iterations):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return Benchmark(np.mean(times).item(), np.std(times).item())


def _assert_almost_equal(x, y) -> bool:
    """Two-threshold accuracy bar (reference benchmark_utils.py:53-57):
    mean |x - y| < 5e-5 and max |x - y| < 1e-4. Takes tensors (on any
    device) or arrays; raises AssertionError when a threshold is crossed."""
    abs_error = np.abs(_host(x) - _host(y))
    if not abs_error.mean().item() < 5e-5:
        raise AssertionError(f"mean abs err {abs_error.mean().item():.3e} >= 5e-5")
    if not abs_error.max().item() < 1e-4:
        raise AssertionError(f"max abs err {abs_error.max().item():.3e} >= 1e-4")
    return True


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gcd(x: int, y: int) -> int:
    """Reference benchmark_utils.py:60-63."""
    while y:
        x, y = y, x % y
    return x


def repo_cache_dir() -> str:
    """The directory the port's kernels are built into
    (``kernels/_build.py:BUILD_DIR``, under the git-ignored ``build/``), one
    definition for every tool that reads or clears it."""
    from ..kernels import _build

    return str(_build.BUILD_DIR)


def hbm_gbps(bytes_moved: int, seconds: float) -> float:
    """Achieved memory bandwidth for a measured op (roofline reporting)."""
    return bytes_moved / seconds / 1e9 if seconds > 0 else float("inf")


def fft_conv_bytes(signal_shape, kernel_shape, out_shape, dtype_bytes=4) -> int:
    """Minimum memory traffic of an ideally-fused FFT conv: read signal and
    kernel, write the output. The roofline denominator for GB/s reporting."""
    total = (
        int(np.prod(signal_shape))
        + int(np.prod(kernel_shape))
        + int(np.prod(out_shape))
    )
    return total * dtype_bytes
