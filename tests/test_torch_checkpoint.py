"""The port's checkpoints and profiling helpers on the CPU, against the JAX
package's (``tests/test_checkpoint.py``): the npz round trip, interop with
``torch.nn`` state dicts, checkpoints crossing between the two packages,
and ``cost_analysis`` / ``roofline``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu.utils import checkpoint as jax_ckpt
from fft_conv_tpu_torch.bench.profiling import cost_analysis, roofline
from fft_conv_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_torch,
    module_state,
    save_checkpoint,
    save_torch,
)

from helpers import _assert_almost_equal, _assert_close_scaled


def _layer(cls, *args, seed, **kw):
    return getattr(ft.nn, cls)(*args, device="cpu", generator=torch.Generator().manual_seed(seed),
                               **kw)


def test_npz_roundtrip(tmp_path):
    layer = _layer("FFTConv2d", 3, 8, 5, padding=2, seed=0)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, layer)
    fresh = _layer("FFTConv2d", 3, 8, 5, padding=2, seed=99)
    assert not torch.equal(fresh.weight, layer.weight)
    restored = load_checkpoint(path, fresh)
    assert restored is fresh  # loaded in place
    assert torch.equal(restored.weight, layer.weight)
    assert torch.equal(restored.bias, layer.bias)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(restored(x), layer(x))


def test_torch_save_roundtrip(tmp_path):
    layer = _layer("FFTConv1d", 4, 6, 9, seed=0)
    path = str(tmp_path / "ckpt.pt")
    save_torch(path, layer)
    fresh = load_torch(path, _layer("FFTConv1d", 4, 6, 9, seed=5))
    assert torch.equal(fresh.weight, layer.weight) and torch.equal(fresh.bias, layer.bias)


def test_load_checkpoint_checks_shapes(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, _layer("FFTConv1d", 4, 6, 9, seed=0))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, _layer("FFTConv1d", 4, 6, 7, seed=0))


def test_torch_checkpoint_interop(tmp_path):
    """A torch ConvTranspose1d state dict restores into FFTConvTranspose1d
    and produces its outputs; module_state gives the torch layout back bit
    for bit."""
    torch.manual_seed(0)
    torch_layer = torch.nn.ConvTranspose1d(4, 6, 7, stride=2)
    state = {k: v.detach().numpy() for k, v in torch_layer.state_dict().items()}
    np.savez(tmp_path / "torch.npz", **state)
    layer = _layer("FFTConvTranspose1d", 4, 6, 7, stride=2, seed=1)
    layer = load_checkpoint(str(tmp_path / "torch.npz"), layer)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 20)).astype(np.float32))
    with torch.no_grad():
        _assert_almost_equal(layer(x).numpy(), torch_layer(x).numpy())
    out_state = module_state(layer)
    assert np.array_equal(out_state["weight"], state["weight"])
    assert np.array_equal(out_state["bias"], state["bias"])


@pytest.mark.parametrize("cls,args,shape", [
    ("FFTConv1d", (3, 4, 9), (2, 3, 40)),
    ("FFTConv2d", (3, 4, 5), (2, 3, 16, 14)),
    ("FFTConvTranspose1d", (3, 4, 7), (2, 3, 20)),
])
def test_checkpoints_cross_between_the_packages(tmp_path, cls, args, shape):
    """An npz written by a JAX layer loads into the port's layer and gives
    the JAX layer's outputs, and the reverse."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jax_layer = getattr(fc.nn, cls)(*args, key=jax.random.key(4))
    path = str(tmp_path / "from_jax.npz")
    jax_ckpt.save_checkpoint(path, jax_layer)
    port = load_checkpoint(path, _layer(cls, *args, seed=7))
    with torch.no_grad():
        y = port(torch.from_numpy(x)).numpy()
    _assert_close_scaled(y, np.asarray(jax_layer(jnp.asarray(x))))

    port = _layer(cls, *args, seed=8)
    path = str(tmp_path / "from_port.npz")
    save_checkpoint(path, port)
    jax_back = jax_ckpt.load_checkpoint(path, getattr(fc.nn, cls)(*args, key=jax.random.key(5)))
    assert np.array_equal(np.asarray(jax_back.weight), port.weight.detach().numpy())
    with torch.no_grad():
        y = port(torch.from_numpy(x)).numpy()
    _assert_close_scaled(np.asarray(jax_back(jnp.asarray(x))), y)


def test_cost_analysis_reports_flops():
    sig, ker = torch.ones((1, 2, 256)), torch.ones((2, 2, 16))
    costs = cost_analysis(lambda s, k: ft.fft_conv(s, k), sig, ker)
    assert any("flops" in k for k in costs)
    assert costs["flops"] > 0 and costs["bytes accessed"] > 0


def test_roofline_runs():
    sig, ker = torch.ones((1, 2, 512)), torch.ones((2, 2, 16))
    out = roofline(lambda s, k: ft.fft_conv(s, k), sig, ker, num_iterations=3)
    assert out["time_s"] > 0
    assert out["achieved_gbps"] >= 0
    # a host time against the card's peaks would mean nothing
    assert out["device"] == "cpu"
    assert out["hbm_fraction"] is None and out["fp32_fraction"] is None
