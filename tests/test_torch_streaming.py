"""The port's streaming 1D convolution against the JAX package's
(``fft_conv_tpu/ops/streaming.py``) and the causal ``F.conv1d`` oracle, on
the CPU: the same numpy-seeded chunks through both steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fft_conv_tpu.ops import streaming as jax_streaming
from fft_conv_tpu_torch.ops import streaming_conv1d_init, streaming_conv1d_step

from helpers import _assert_almost_equal, _assert_close_scaled

B, CIN, COUT, K, T = 2, 4, 6, 9, 50


def _inputs(seed, groups, chunks=4, t=T):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, CIN, t)).astype(np.float32) for _ in range(chunks)]
    w = rng.standard_normal((COUT, CIN // groups, K)).astype(np.float32)
    b = rng.standard_normal((COUT,)).astype(np.float32)
    return xs, w, b


def _stream_port(xs, w, b, dilation, groups):
    state = streaming_conv1d_init(B, CIN, K, dilation, device="cpu")
    outs = []
    for c in xs:
        y, state = streaming_conv1d_step(state, torch.from_numpy(c), torch.from_numpy(w),
                                         torch.from_numpy(b), dilation=dilation, groups=groups)
        outs.append(y.numpy())
    return np.concatenate(outs, axis=-1), state


@pytest.mark.parametrize("dilation,groups", [(1, 1), (2, 1), (1, 2)])
def test_streaming_matches_jax(dilation, groups):
    xs, w, b = _inputs(0, groups)
    streamed, _ = _stream_port(xs, w, b, dilation, groups)
    state = jax_streaming.streaming_conv1d_init(B, CIN, K, dilation)
    outs = []
    for c in xs:
        y, state = jax_streaming.streaming_conv1d_step(
            state, jnp.asarray(c), jnp.asarray(w), jnp.asarray(b),
            dilation=dilation, groups=groups)
        outs.append(np.asarray(y))
    _assert_close_scaled(streamed, np.concatenate(outs, axis=-1))


@pytest.mark.parametrize("dilation,groups", [(1, 1), (2, 1), (1, 2)])
def test_streaming_matches_causal_conv(dilation, groups):
    xs, w, b = _inputs(1, groups)
    streamed, _ = _stream_port(xs, w, b, dilation, groups)
    x = np.concatenate(xs, axis=-1)
    k_dil = (K - 1) * dilation + 1
    x_pad = np.pad(x, ((0, 0), (0, 0), (k_dil - 1, 0)))
    y_ref = F.conv1d(torch.tensor(x_pad), torch.tensor(w), torch.tensor(b),
                     dilation=dilation, groups=groups).numpy()
    assert streamed.shape == y_ref.shape
    _assert_almost_equal(streamed, y_ref)


@pytest.mark.parametrize("dilation", [1, 2])
def test_final_state_is_the_last_samples_and_owns_its_storage(dilation):
    xs, w, b = _inputs(2, 1, chunks=3, t=7)  # chunks shorter than the state
    _, state = _stream_port(xs, w, b, dilation, 1)
    x = np.concatenate(xs, axis=-1)
    k_dil = (K - 1) * dilation + 1
    want = np.pad(x, ((0, 0), (0, 0), (k_dil - 1, 0)))[..., -(k_dil - 1):]
    assert np.array_equal(state.numpy(), want)
    assert state.is_contiguous()
    assert state.untyped_storage().nbytes() == state.numel() * state.element_size()


def test_state_validation():
    state = streaming_conv1d_init(1, 2, 5, device="cpu")
    with pytest.raises(ValueError):
        streaming_conv1d_step(state, torch.ones(1, 2, 8), torch.ones(3, 2, 9))


def test_weight_gradient_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 2, 5)).astype(np.float32)
    chunk = rng.standard_normal((1, 2, 20)).astype(np.float32)
    prev = rng.standard_normal((1, 2, 4)).astype(np.float32)

    def loss_jax(w_):
        y, _ = jax_streaming.streaming_conv1d_step(jnp.asarray(prev), jnp.asarray(chunk), w_)
        return (y ** 2).sum()

    g_jax = jax.grad(loss_jax)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    y, _ = streaming_conv1d_step(torch.from_numpy(prev), torch.from_numpy(chunk), wt)
    (y ** 2).sum().backward()
    _assert_close_scaled(wt.grad.numpy(), np.asarray(g_jax))


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfied")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_conv1d_init(1, 2, 5)
