"""Benchmark sweep: crossover curves of FFT convolution against direct
convolution, on the card.

The port of ``fft_conv_tpu/bench/generate_benchmark_plot.py``, which is the
counterpart of the upstream reference's sweep (reference
doc/scripts/generate_benchmark_plot.py:125-199): the same three configs (1D
L=32768, 2D 512^2, 3D 64^3; B=2, 8->8 channels), the same six methods, the
same rows (time mean and spread, peak device memory), the per-point atomic
checkpoint and the resume filter. What differs from the JAX sweep:

  * each point is timed by ``bench.harness.benchmark_fori``, a CUDA graph
    of ``num_iterations`` calls, and its memory read from the CUDA
    allocator (``peak_memory_gib``); on the CPU the times are host clocks
    and the memory 0.0 with source "cpu";
  * ``platform`` is the card's name (``torch.cuda.get_device_name()``), or
    "cpu";
  * the baselines are ``torch.nn.functional.conv{1,2,3}d`` and
    ``conv_transpose{1,2,3}d`` with TF32 off, each with the kernel as the
    sweep passes it, so ``naive_conv_transpose`` computes the same function
    as ``fft_conv_transpose`` (the JAX baseline leaves the kernel unflipped);
  * the fused wrappers raise where no plan fits; the sweep prints the point
    and records no row for it;
  * the TPU compile cache and backend-init retry are not carried.

Run:  python -m fft_conv_tpu_torch.bench.generate_benchmark_plot [--out DIR]
"""

import argparse
import dataclasses
import json
import os
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..utils.device import Device, resolve_device


@dataclasses.dataclass
class BenchConfig:
    """One sweep: mirrors reference generate_benchmark_plot.py:128-159."""

    label: str
    ndim: int
    input_size: int
    kernel_sizes: Tuple[int, ...]
    batch_size: int = 2
    in_channels: int = 8
    out_channels: int = 8
    num_iterations: int = 16


CONFIGS = [
    BenchConfig("1D", 1, 32768, (1, 256, 768, 1280, 1792, 2304, 2816, 3328, 3840)),
    BenchConfig("2D", 2, 512, (1, 4, 10, 16, 22, 28, 34, 40, 46)),
    BenchConfig("3D", 3, 64, (1, 2, 4, 6, 8)),
]


@contextmanager
def _fp32_library():
    """cuDNN and cuBLAS in FP32 (TF32 off), the caller's settings restored
    afterwards: the baselines compute what the FFT routes compute."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _naive(op: Callable) -> Callable:
    def f(sig, ker, bias):
        with _fp32_library():
            return op(sig, ker, bias)

    return f


def _methods(ndim) -> Dict[str, Callable]:
    from ..kernels.fused1d import fft_conv1d_fused, fft_conv_transpose1d_fused
    from ..kernels.fused2d import fft_conv2d_fused, fft_conv_transpose2d_fused
    from ..kernels.fused3d import fft_conv3d_fused, fft_conv_transpose3d_fused
    from ..ops.functional import fft_conv, fft_conv_transpose

    conv, conv_t = {
        1: (TF.conv1d, TF.conv_transpose1d),
        2: (TF.conv2d, TF.conv_transpose2d),
        3: (TF.conv3d, TF.conv_transpose3d),
    }[ndim]
    methods = {
        "fft_conv": lambda s, k, b: fft_conv(s, k, b),
        "fft_conv_transpose": lambda s, kt, b: fft_conv_transpose(s, kt, b),
        "naive_conv": _naive(conv),
        "naive_conv_transpose": _naive(conv_t),
    }
    # explicit labeled fused rows for every dimension; they raise where no
    # plan fits (the sweep then records no row)
    fused, fused_t = {
        1: (fft_conv1d_fused, fft_conv_transpose1d_fused),
        2: (fft_conv2d_fused, fft_conv_transpose2d_fused),
        3: (fft_conv3d_fused, fft_conv_transpose3d_fused),
    }[ndim]
    methods["fft_conv_fused"] = lambda s, k, b: fused(s, k, b)
    methods["fft_conv_transpose_fused"] = lambda s, kt, b: fused_t(s, kt, b)
    return methods


def run_sweep(
    configs: Optional[List[BenchConfig]] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    device: Device = None,
) -> List[dict]:
    """Sweeps every (config, kernel size, method) point on ``device``, the
    card unless ``device="cpu"`` is passed (RuntimeError without a card).

    ``checkpoint_path``: if given, the accumulated rows are re-written
    there after every point, so that a killed run keeps the points already
    measured.

    ``resume``: load ``checkpoint_path`` if present and skip every
    (config, method, kernel_size) already measured on the same platform."""
    from .harness import benchmark_fori, peak_memory_gib

    dev = resolve_device(device, "the sweep runs")
    platform = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    configs = configs or CONFIGS
    rng = np.random.default_rng(0)
    rows = []
    done = set()
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        try:
            with open(checkpoint_path) as f:
                rows = [
                    r for r in json.load(f)
                    if r.get("platform") == platform
                    # drop unmeasured (null-time) rows so resume retries them
                    and r.get("time_mean_s") is not None
                ]
            done = {
                (r["config"], r["method"], r["kernel_size"]) for r in rows
            }
            print(f"resuming: {len(done)} points already measured",
                  flush=True)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"resume load failed ({e}); starting fresh", flush=True)
            rows, done = [], set()

    def tensor(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    for cfg in configs:
        methods = _methods(cfg.ndim)
        for k in cfg.kernel_sizes:
            sig = tensor((cfg.batch_size, cfg.in_channels) + (cfg.input_size,) * cfg.ndim)
            ker = tensor((cfg.out_channels, cfg.in_channels) + (k,) * cfg.ndim)
            ker_t = ker.transpose(0, 1).contiguous()
            bias = tensor((cfg.out_channels,))
            for name, fn in methods.items():
                if (cfg.label, name, k) in done:
                    continue
                arg_k = ker_t if "transpose" in name else ker
                try:
                    t = benchmark_fori(
                        fn, sig, arg_k, bias, num_iterations=cfg.num_iterations,
                    )
                    if dev.type == "cuda":
                        mem, mem_src = peak_memory_gib(fn, sig, arg_k, bias)
                    else:
                        mem, mem_src = 0.0, "cpu"
                    row = {
                        "config": cfg.label,
                        "method": name,
                        "kernel_size": k,
                        "time_mean_s": t.mean,
                        "time_std_s": t.std,
                        "peak_mem_gib": mem,
                        "peak_mem_source": mem_src,
                        "platform": platform,
                    }
                    if not np.isfinite(t.mean) or t.mean <= 0:
                        # record the point as explicitly unmeasured rather
                        # than plotting an infinite-speedup artifact
                        row["time_mean_s"] = None
                        row["time_std_s"] = None
                        row["note"] = "non-positive time; unmeasurable"
                    rows.append(row)
                    shown = ("   (unmeasurable)" if row["time_mean_s"] is None
                             else f"{t.mean * 1e3:9.3f} ms ± {t.std * 1e3:.3f}")
                    print(
                        f"{cfg.label} k={k:5d} {name:22s} {shown}",
                        flush=True,
                    )
                except Exception as e:  # keep sweeping (reference :192-193)
                    print(f"{cfg.label} k={k} {name}: {type(e).__name__}: {e}", flush=True)
                if checkpoint_path:
                    # atomic: a kill mid-dump must not truncate the
                    # previously checkpointed rows
                    tmp = checkpoint_path + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(rows, f, indent=1)
                    os.replace(tmp, checkpoint_path)
    return rows


def plot(rows: List[dict], out_png: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    configs = sorted({r["config"] for r in rows})
    # two rows like the reference plot (reference generate_benchmark_plot.py:
    # 162-199): execution time on top, peak memory below
    fig, axes = plt.subplots(
        2, len(configs), figsize=(5 * len(configs), 8), squeeze=False
    )
    for col, cfg in enumerate(configs):
        ax_t, ax_m = axes[0][col], axes[1][col]
        for method in sorted({r["method"] for r in rows if r["config"] == cfg}):
            pts = sorted(
                (
                    r["kernel_size"],
                    r["time_mean_s"],
                    r["time_std_s"],
                    r.get("peak_mem_gib", 0.0),
                )
                for r in rows
                if r["config"] == cfg and r["method"] == method
                and r.get("time_mean_s") is not None  # unmeasured points
            )
            if not pts:
                continue
            ks, means, stds, mems = zip(*pts)
            ax_t.errorbar(ks, means, yerr=stds, label=method, marker="o", ms=3)
            if any(m > 0 for m in mems):
                ax_m.plot(ks, mems, label=method, marker="o", ms=3)
        ax_t.set_yscale("log")
        ax_t.set_title(f"{cfg} execution time")
        ax_t.set_xlabel("kernel size")
        ax_t.set_ylabel("time (s)")
        ax_t.legend(fontsize=7)
        ax_m.set_yscale("log")
        ax_m.set_title(f"{cfg} peak memory")
        ax_m.set_xlabel("kernel size")
        ax_m.set_ylabel("memory (GiB)")
        ax_m.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    print(f"wrote {out_png}")


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser()
    # not "doc": that directory holds the JAX package's results
    parser.add_argument("--out", default=os.path.join("doc", "torch"))
    parser.add_argument("--quick", action="store_true",
                        help="3 kernel sizes per config")
    parser.add_argument("--resume", action="store_true",
                        help="skip points already in the checkpoint JSON "
                             "(same platform); continue a killed sweep")
    args = parser.parse_args(argv)
    configs = CONFIGS
    if args.quick:
        # the JAX sweep's selection, so both packages sweep the same points
        configs = [
            dataclasses.replace(
                c, kernel_sizes=c.kernel_sizes[:: max(1, len(c.kernel_sizes) // 3)],
                num_iterations=24,
            )
            for c in CONFIGS
        ]
    os.makedirs(args.out, exist_ok=True)
    json_path = os.path.join(args.out, "benchmark_results.json")
    rows = run_sweep(configs, checkpoint_path=json_path, resume=args.resume)
    with open(json_path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {json_path}")
    plot(rows, os.path.join(args.out, "benchmark.png"))


if __name__ == "__main__":
    main()
