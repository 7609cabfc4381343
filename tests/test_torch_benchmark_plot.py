"""The port's benchmark sweep (``fft_conv_tpu_torch/bench/generate_benchmark_plot.py``)
against the JAX package's, on the CPU.

The configs, the ``--quick`` selection and the method names equal JAX's;
each method, at one tiny point per rank, is held to the JAX method of the
same name within the bar of ``helpers._assert_close_scaled``, except
``naive_conv_transpose``: the port's is ``conv_transpose{1,2,3}d``, the
same function as ``fft_conv_transpose``, where JAX's baseline leaves the
kernel unflipped (shown below). A CPU sweep over tiny configs checks the
rows, the missing fused rows, the checkpoint and the resume filter.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
from fft_conv_tpu.bench import generate_benchmark_plot as jax_gbp
from fft_conv_tpu_torch import fft_conv_transpose
from fft_conv_tpu_torch.bench import generate_benchmark_plot as gbp
from fft_conv_tpu_torch.bench import harness
from fft_conv_tpu_torch.kernels.fused1d import (
    choose_fft_size,
    fft_conv_transpose1d_fused_if_fits,
)
from fft_conv_tpu_torch.kernels.fused2d import (
    fft_conv2d_fused_if_fits,
    fft_conv_transpose2d_fused_if_fits,
)
from fft_conv_tpu_torch.kernels.fused3d import fft_conv3d_fused_if_fits
from fft_conv_tpu_torch.ops.functional import _fused_transpose
from fft_conv_tpu_torch.utils.shapes import to_ntuple

from helpers import _assert_close_scaled

# one tiny point per rank where every fused plan fits: (B, Cin, Cout, size, K)
POINTS = {1: (1, 2, 3, 600, 17), 2: (1, 2, 3, 24, 5), 3: (1, 2, 2, 10, 3)}
# the sweep's row keys (fft_conv_tpu/bench/generate_benchmark_plot.py:209-218)
ROW_KEYS = {"config", "method", "kernel_size", "time_mean_s", "time_std_s", "peak_mem_gib",
            "peak_mem_source", "platform"}
# tiny sweeps on the CPU; 1D K=8100 leaves no 128-sample block at any FFT
# size, so neither fused 1D row exists there
TINY = [
    gbp.BenchConfig("1D", 1, 8200, (1, 8100), batch_size=1, in_channels=2, out_channels=2,
                    num_iterations=2),
    gbp.BenchConfig("2D", 2, 16, (1, 5), batch_size=1, in_channels=2, out_channels=2,
                    num_iterations=2),
    gbp.BenchConfig("3D", 3, 8, (1, 3), batch_size=1, in_channels=2, out_channels=2,
                    num_iterations=2),
]


def _inputs(ndim):
    b, cin, cout, size, k = POINTS[ndim]
    rng = np.random.default_rng(ndim)
    sig = rng.standard_normal((b, cin) + (size,) * ndim).astype(np.float32)
    ker = rng.standard_normal((cout, cin) + (k,) * ndim).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return sig, ker, np.ascontiguousarray(np.swapaxes(ker, 0, 1)), bias


def _call(methods, name, sig, ker, ker_t, bias, torch_side):
    k = ker_t if "transpose" in name else ker
    if torch_side:
        return methods[name](*(torch.from_numpy(a) for a in (sig, k, bias))).numpy()
    return np.asarray(methods[name](*(jnp.asarray(a) for a in (sig, k, bias))))


def test_configs_equal_jax():
    assert [dataclasses.asdict(c) for c in gbp.CONFIGS] == [
        dataclasses.asdict(c) for c in jax_gbp.CONFIGS]
    assert [f.name for f in dataclasses.fields(gbp.BenchConfig)] == [
        f.name for f in dataclasses.fields(jax_gbp.BenchConfig)]


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_method_names_equal_jax(ndim):
    assert list(gbp._methods(ndim)) == list(jax_gbp._methods(ndim))


def _main_configs(module, argv, monkeypatch):
    """The configs ``main`` passes to ``run_sweep`` for ``argv``, with the
    sweep and the plot stubbed out."""
    seen = {}

    def sweep(configs, checkpoint_path=None, resume=False):
        seen.update(configs=configs, checkpoint_path=checkpoint_path, resume=resume)
        return []

    monkeypatch.setattr(module, "run_sweep", sweep)
    monkeypatch.setattr(module, "plot", lambda rows, out_png: seen.update(png=out_png))
    monkeypatch.setattr(sys, "argv", ["generate_benchmark_plot"] + argv)
    if module is gbp:
        module.main(argv)
    else:
        module.main()
    return seen


@pytest.mark.parametrize("argv", [[], ["--quick"], ["--quick", "--resume"]])
def test_main_selects_the_points_jax_selects(argv, tmp_path, monkeypatch):
    ours = _main_configs(gbp, argv + ["--out", str(tmp_path / "t")], monkeypatch)
    theirs = _main_configs(jax_gbp, argv + ["--out", str(tmp_path / "j")], monkeypatch)
    assert [dataclasses.asdict(c) for c in ours["configs"]] == [
        dataclasses.asdict(c) for c in theirs["configs"]]
    assert ours["resume"] == theirs["resume"] == ("--resume" in argv)
    assert ours["checkpoint_path"] == str(tmp_path / "t" / "benchmark_results.json")
    assert ours["png"] == str(tmp_path / "t" / "benchmark.png")


def test_default_out_is_not_the_jax_packages_doc(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = _main_configs(gbp, [], monkeypatch)
    assert seen["checkpoint_path"] == os.path.join("doc", "torch", "benchmark_results.json")
    assert sorted(p.name for p in (tmp_path / "doc").iterdir()) == ["torch"]
    assert json.loads((tmp_path / "doc" / "torch" / "benchmark_results.json").read_text()) == []


@pytest.mark.parametrize("name", ["fft_conv", "fft_conv_transpose", "naive_conv",
                                  "fft_conv_fused", "fft_conv_transpose_fused"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_method_matches_jax(ndim, name):
    arrays = _inputs(ndim)
    ours = _call(gbp._methods(ndim), name, *arrays, torch_side=True)
    theirs = _call(jax_gbp._methods(ndim), name, *arrays, torch_side=False)
    _assert_close_scaled(ours, theirs)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_naive_conv_transpose_is_fft_conv_transpose_in_both_packages(ndim):
    sig, _, ker_t, bias = _inputs(ndim)
    ours = _call(gbp._methods(ndim), "naive_conv_transpose", sig, None, ker_t, bias, True)
    _assert_close_scaled(ours, fft_conv_transpose(*(torch.from_numpy(a)
                                                    for a in (sig, ker_t, bias))).numpy())
    _assert_close_scaled(ours, np.asarray(fc.fft_conv_transpose(
        *(jnp.asarray(a) for a in (sig, ker_t, bias)))))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_jax_baseline_is_torchs_with_the_kernel_flipped(ndim):
    """JAX's ``naive_conv_transpose`` runs ``lax.conv_transpose`` without
    ``transpose_kernel=True``: it equals ``conv_transpose{1,2,3}d`` with
    the spatial taps flipped, and differs from it without the flip."""
    sig, _, ker_t, bias = _inputs(ndim)
    theirs = _call(jax_gbp._methods(ndim), "naive_conv_transpose", sig, None, ker_t, bias,
                   False)
    flipped = np.ascontiguousarray(np.flip(ker_t, axis=tuple(range(2, 2 + ndim))))
    methods = gbp._methods(ndim)
    _assert_close_scaled(theirs, _call(methods, "naive_conv_transpose", sig, None, flipped,
                                       bias, True))
    unflipped = _call(methods, "naive_conv_transpose", sig, None, ker_t, bias, True)
    assert np.abs(unflipped - theirs).max() > 1.0


def test_baselines_turn_tf32_off_and_restore_the_callers_setting(monkeypatch):
    seen = []
    calls = gbp._naive(lambda s, k, b: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    calls(None, None, None)
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def _fused_fits(ndim, transposed, sig, ker, ker_t):
    """The port's gate for a fused row: ``choose_fft_size`` in 1D, the
    ``_if_fits`` functions elsewhere."""
    if not transposed:
        if ndim == 1:
            return choose_fft_size(ker.shape[-1], sig.shape[-1], sig.shape[1], ker.shape[0],
                                   batch=sig.shape[0]) is not None
        gate = fft_conv2d_fused_if_fits if ndim == 2 else fft_conv3d_fused_if_fits
        return gate(sig, ker) is not None
    if ndim == 1:
        return fft_conv_transpose1d_fused_if_fits(sig, ker_t) is not None
    if ndim == 2:
        return fft_conv_transpose2d_fused_if_fits(sig, ker_t) is not None
    ones, zeros = to_ntuple(1, 3), to_ntuple(0, 3)
    return _fused_transpose(sig, ker_t, None, zeros, ones, ones, 1, zeros,
                            lambda x, w, g: fft_conv3d_fused_if_fits(x, w, groups=g)) is not None


@pytest.fixture(scope="module")
def tiny_sweep(tmp_path_factory):
    path = tmp_path_factory.mktemp("sweep") / "rows.json"
    return gbp.run_sweep(TINY, checkpoint_path=str(path), device="cpu"), path


def test_cpu_sweep_rows(tiny_sweep):
    rows, _ = tiny_sweep
    for row in rows:
        assert set(row) == ROW_KEYS
        assert row["platform"] == "cpu" and row["peak_mem_source"] == "cpu"
        assert row["peak_mem_gib"] == 0.0
        assert row["time_mean_s"] > 0 and row["time_std_s"] >= 0
    # the points the sweep draws, in its order, to ask the gates
    rng = np.random.default_rng(0)
    want = []
    for cfg in TINY:
        for k in cfg.kernel_sizes:
            sig, ker, bias = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                              for s in ((cfg.batch_size, cfg.in_channels)
                                        + (cfg.input_size,) * cfg.ndim,
                                        (cfg.out_channels, cfg.in_channels) + (k,) * cfg.ndim,
                                        (cfg.out_channels,)))
            ker_t = ker.transpose(0, 1).contiguous()
            for name in gbp._methods(cfg.ndim):
                if "fused" in name and not _fused_fits(cfg.ndim, "transpose" in name, sig,
                                                       ker, ker_t):
                    continue
                want.append((cfg.label, k, name))
    assert [(r["config"], r["kernel_size"], r["method"]) for r in rows] == want
    # the gate says no at 1D K=8100 only
    assert len(want) == 6 * 6 - 2
    assert ("1D", 8100, "fft_conv_fused") not in want


def test_checkpoint_holds_the_rows_and_resume_skips_them(tiny_sweep, monkeypatch, capsys):
    rows, path = tiny_sweep
    assert json.loads(path.read_text()) == rows

    def unmeasured(*args, **kwargs):
        raise AssertionError("a point already measured was timed again")

    monkeypatch.setattr(harness, "benchmark_fori", unmeasured)
    resumed = gbp.run_sweep(TINY, checkpoint_path=str(path), resume=True, device="cpu")
    assert resumed == rows
    assert f"resuming: {len(rows)} points already measured" in capsys.readouterr().out


def test_resume_retries_unmeasured_points_and_other_platforms(tiny_sweep, tmp_path,
                                                              monkeypatch):
    rows, _ = tiny_sweep
    kept = rows[1:3]
    old = [dict(rows[0], time_mean_s=None, time_std_s=None, note="unmeasurable"),
           *kept, dict(rows[3], platform="NVIDIA H100 80GB HBM3")]
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(old))
    timed = []

    def fake(fn, sig, *rest, num_iterations=16):
        timed.append(1)
        return harness.Benchmark(1e-3, 0.0)

    monkeypatch.setattr(harness, "benchmark_fori", fake)
    one = [dataclasses.replace(TINY[1], kernel_sizes=(1,))]
    resumed = gbp.run_sweep(one, checkpoint_path=str(path), resume=True, device="cpu")
    # rows[0:6] are 1D's; the 2D K=1 point's six methods are all timed anew
    assert resumed[:2] == kept and len(timed) == 6
    assert json.loads(path.read_text()) == resumed


def test_sweep_needs_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gbp.run_sweep(TINY)


def test_plot_writes_a_png(tiny_sweep, tmp_path):
    png = tmp_path / "benchmark.png"
    gbp.plot(tiny_sweep[0], str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_skips_without_matplotlib(tiny_sweep, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    gbp.plot(tiny_sweep[0], str(tmp_path / "benchmark.png"))
    assert capsys.readouterr().out == "matplotlib unavailable; skipping plot\n"
    assert not (tmp_path / "benchmark.png").exists()


def test_sweep_pulls_in_no_jax():
    code = (
        "import sys, fft_conv_tpu_torch.bench.generate_benchmark_plot as g; g._methods(1); "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fft_conv_tpu' or m.startswith('fft_conv_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
