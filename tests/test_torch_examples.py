"""The port's examples (``fft_conv_tpu_torch/examples/``) against the JAX
package's scripts (``examples/``), on the CPU at small sizes.

Each example's ``run(device="cpu", ...)`` is held to the JAX script's call
sequence through ``fft_conv_tpu`` on the same seeded inputs, with the JAX
layers' parameters carried across by ``state=``, within the bar of
``helpers._assert_close_scaled`` (err_mean < 2e-5·σ, err_max < 1.2e-4·σ,
σ = max(1, std(ref))). The JAX scripts' helpers are loaded from their files.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
from fft_conv_tpu.ops import (
    plan_fft_conv,
    plan_fft_conv_transpose,
    streaming_conv1d_init,
    streaming_conv1d_step,
)
from fft_conv_tpu_torch.examples import (
    image_filter_bank_2d,
    long_audio_filter,
    serving_plans,
    train_fft_cnn,
    volume_stencil_3d,
)

from helpers import _assert_close_scaled

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
NAMES = ("long_audio_filter", "serving_plans", "image_filter_bank_2d",
         "volume_stencil_3d", "train_fft_cnn")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _state(jax_module):
    return {k: np.asarray(v) for k, v in jax_module.state_dict().items()}


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("args", [(8, 31), (3, 9), (5, 6)])
def test_gabor_bank_equals_the_jax_scripts(args):
    jax_bank = _jax_script("image_filter_bank_2d").gabor_bank(*args)
    ours = image_filter_bank_2d.gabor_bank(*args)
    assert ours.dtype == jax_bank.dtype and np.array_equal(ours, jax_bank)


@pytest.mark.parametrize("args", [(4, 7), (4, 5), (2, 4)])
def test_gaussian_psf_equals_the_jax_scripts(args):
    jax_psf = _jax_script("volume_stencil_3d").gaussian_psf(*args)
    ours = volume_stencil_3d.gaussian_psf(*args)
    assert ours.dtype == jax_psf.dtype and np.array_equal(ours, jax_psf)


def test_long_audio_filter_matches_jax():
    b, c, length, taps, chunk = 2, 4, 4096, 65, 256
    r = long_audio_filter.run(device="cpu", batch=b, channels=c, length=length, taps=taps,
                              chunk_len=chunk)
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((b, c, length)), jnp.float32)
    fir = jnp.asarray(rng.standard_normal((c, c, taps)), jnp.float32) * (1.0 / taps)
    assert np.array_equal(_np(r["audio"]), np.asarray(audio))
    assert np.array_equal(_np(r["fir"]), np.asarray(fir))

    filtered = fc.fft_conv(audio, fir, padding=taps // 2)
    served = plan_fft_conv(fir, padding=taps // 2, signal_spatial=(length,))(audio)
    state = streaming_conv1d_init(b, c, taps)
    outs = []
    for start in range(0, length, chunk):
        y, state = streaming_conv1d_step(
            state, jax.lax.dynamic_slice_in_dim(audio, start, chunk, axis=2), fir)
        outs.append(y)
    assert r["chunks"] == length // chunk
    _assert_close_scaled(_np(r["filtered"]), np.asarray(filtered))
    _assert_close_scaled(_np(r["served"]), np.asarray(served))
    _assert_close_scaled(_np(r["streamed"]), np.asarray(jnp.concatenate(outs, axis=-1)))


def test_long_audio_filter_clamps_the_last_chunk_as_jax_does():
    """A length that is no multiple of the chunk: the JAX script's dynamic
    slice clamps the last start, so the last chunk overlaps the one before."""
    r = long_audio_filter.run(device="cpu", batch=1, channels=2, length=1000, taps=17,
                              chunk_len=300)
    assert r["chunks"] == 4 and r["streamed"].shape == (1, 2, 1200)
    audio, fir = r["audio"], r["fir"]
    state = streaming_conv1d_init(1, 2, 17)
    outs = []
    for start in range(0, 1000, 300):
        y, state = streaming_conv1d_step(
            state, jax.lax.dynamic_slice_in_dim(jnp.asarray(_np(audio)), start, 300, axis=2),
            jnp.asarray(_np(fir)))
        outs.append(y)
    _assert_close_scaled(_np(r["streamed"]), np.asarray(jnp.concatenate(outs, axis=-1)))


def test_serving_plans_match_jax():
    n, c, f, k, image, up_image = 4, 3, 8, 15, 64, 32
    r = serving_plans.run(device="cpu", batch=n, channels=c, features=f, kernel_size=k,
                          image=image, up_image=up_image)
    rng = np.random.default_rng(0)
    bank = jnp.asarray(rng.standard_normal((f, c, k, k)), jnp.float32)
    bias = jnp.asarray(rng.standard_normal((f,)), jnp.float32)
    conv = plan_fft_conv(bank, bias, padding=k // 2, signal_spatial=(image, image))
    images = jnp.asarray(rng.standard_normal((n, c, image, image)), jnp.float32)
    up_k = jnp.asarray(rng.standard_normal((f, c, 4, 4)), jnp.float32)
    up = plan_fft_conv_transpose(up_k, stride=2, padding=1,
                                 signal_spatial=(up_image, up_image))
    small = jnp.asarray(rng.standard_normal((n, f, up_image, up_image)), jnp.float32)
    for name, ref in (("bank", bank), ("bias", bias), ("images", images), ("up_k", up_k),
                      ("small", small)):
        assert np.array_equal(_np(r[name]), np.asarray(ref)), name

    @jax.jit
    def head(x):
        return up(jnp.tanh(conv(x))[:, :f, :up_image, :up_image])

    _assert_close_scaled(_np(r["feats"]), np.asarray(conv(images)))
    _assert_close_scaled(_np(r["big"]), np.asarray(up(small)))
    _assert_close_scaled(_np(r["head"]), np.asarray(head(images)))
    assert r["head"].shape == (n, c, 2 * up_image, 2 * up_image)


def test_serving_plans_reject_the_wrong_shape_as_jax_does():
    r = serving_plans.run(device="cpu", batch=1, image=64, up_image=16)
    assert r["rejected"] is not None and "(64, 64)" in r["rejected"]
    conv = plan_fft_conv(jnp.asarray(_np(r["bank"])), padding=7, signal_spatial=(64, 64))
    with pytest.raises(ValueError):
        conv(jnp.zeros((1, 3, 16, 16)))


def _jax_grads(layer, x):
    return jax.grad(lambda m, s: (m(s) ** 2).mean())(layer, x)


def test_image_filter_bank_matches_jax():
    b, size, nf, k = 2, 64, 8, 9
    jax_layer = fc.FFTConv2d(1, nf, k, padding=k // 2, key=jax.random.key(0))
    r = image_filter_bank_2d.run(device="cpu", batch=b, size=size, n_filters=nf,
                                 kernel_size=k, state=_state(jax_layer))
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((b, 1, size, size)), jnp.float32)
    bank = jnp.asarray(image_filter_bank_2d.gabor_bank(nf, k))
    assert np.array_equal(_np(r["images"]), np.asarray(images))
    _assert_close_scaled(_np(r["responses"]), np.asarray(fc.fft_conv(images, bank,
                                                                     padding=k // 2)))
    _assert_close_scaled(_np(r["y"]), np.asarray(jax_layer(images)))
    g = _jax_grads(jax_layer, images)
    _assert_close_scaled(_np(r["layer"].weight.grad), np.asarray(g.weight))
    _assert_close_scaled(_np(r["layer"].bias.grad), np.asarray(g.bias))


def test_volume_stencil_matches_jax():
    b, size, ch, k = 2, 16, 4, 5
    jax_layer = fc.FFTConv3d(1, ch, k, padding=k // 2, key=jax.random.key(0))
    r = volume_stencil_3d.run(device="cpu", batch=b, size=size, channels=ch, kernel_size=k,
                              state=_state(jax_layer))
    rng = np.random.default_rng(0)
    volumes = jnp.asarray(rng.standard_normal((b, 1, size, size, size)), jnp.float32)
    psf = jnp.asarray(volume_stencil_3d.gaussian_psf(ch, k))
    assert np.array_equal(_np(r["volumes"]), np.asarray(volumes))
    _assert_close_scaled(_np(r["smoothed"]), np.asarray(fc.fft_conv(volumes, psf,
                                                                    padding=k // 2)))
    _assert_close_scaled(_np(r["y"]), np.asarray(jax_layer(volumes)))
    g = _jax_grads(jax_layer, volumes)
    _assert_close_scaled(_np(r["layer"].weight.grad), np.asarray(g.weight))
    _assert_close_scaled(_np(r["layer"].bias.grad), np.asarray(g.bias))


def test_volume_example_shape_is_composed_under_auto_in_both_packages():
    """The example's padded 70^3 volume needs two W blocks, and "auto" fuses
    single-block plans only, in both packages."""
    from fft_conv_tpu.kernels.fused3d import plan_3d_blocked as jax_plan
    from fft_conv_tpu_torch.kernels.fused3d import plan_3d_blocked

    ours = plan_3d_blocked(1, 4, 70, 70, 70, 7, 7, 7)
    assert ours == jax_plan(1, 4, 70, 70, 70, 7, 7, 7)
    assert ours is not None and ours[1] == 2


def test_train_fft_cnn_matches_jax():
    b, length, k, steps = 4, 256, 9, 5
    k1, k2 = jax.random.split(jax.random.key(0))
    model = {
        "conv1": fc.FFTConv1d(3, 8, k, padding=k // 2, key=k1),
        "conv2": fc.FFTConv1d(8, 1, k, padding=k // 2, key=k2),
    }
    state = {f"{name}.{key}": value for name, layer in model.items()
             for key, value in _state(layer).items()}
    r = train_fft_cnn.run(device="cpu", batch=b, length=length, kernel_size=k, steps=steps,
                          state=state)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((b, 3, length)), jnp.float32)
    target = jnp.asarray(rng.standard_normal((b, 1, length)), jnp.float32)
    assert np.array_equal(_np(r["x"]), np.asarray(x))
    assert np.array_equal(_np(r["target"]), np.asarray(target))
    for key, value in state.items():
        assert np.array_equal(r["initial_state"][key], value), key

    def forward(m, x):
        return m["conv2"](jax.nn.relu(m["conv1"](x)))

    @jax.jit
    def train_step(m, x, y):
        loss, grads = jax.value_and_grad(lambda m_: jnp.mean((forward(m_, x) - y) ** 2))(m)
        return loss, jax.tree_util.tree_map(lambda p, g: p - 1e-2 * g, m, grads)

    losses = []
    for _ in range(steps):
        loss, model = train_step(model, x, target)
        losses.append(float(loss))
    # each step's loss and the trained parameters, within the bar
    _assert_close_scaled(np.asarray(r["losses"]), np.asarray(losses))
    assert losses[-1] < losses[0]
    trained = r["model"].state_dict()
    for name, layer in model.items():
        for key, value in _state(layer).items():
            _assert_close_scaled(_np(trained[f"{name}.{key}"]), value)


@pytest.mark.parametrize("name", ["image_filter_bank_2d", "volume_stencil_3d",
                                  "train_fft_cnn"])
def test_layers_take_the_ports_init_without_state(name):
    """Without ``state`` the layers come from the port's own init, the same
    for the same seed."""
    module = {"image_filter_bank_2d": image_filter_bank_2d,
              "volume_stencil_3d": volume_stencil_3d, "train_fft_cnn": train_fft_cnn}[name]
    small = {"image_filter_bank_2d": dict(size=16, kernel_size=5),
             "volume_stencil_3d": dict(size=8, kernel_size=3),
             "train_fft_cnn": dict(length=64, kernel_size=5, steps=1)}[name]
    first, second = (module.run(device="cpu", **small) for _ in range(2))
    key = "model" if name == "train_fft_cnn" else "layer"
    for (k, a), b in zip(first[key].state_dict().items(), second[key].state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_the_card_unless_the_cpu_is_asked_for(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = sys.modules[f"fft_conv_tpu_torch.examples.{name}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run()


def test_examples_pull_in_no_jax():
    code = (
        "import sys; "
        + "; ".join(f"import fft_conv_tpu_torch.examples.{n}" for n in NAMES)
        + "; bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fft_conv_tpu' or m.startswith('fft_conv_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
