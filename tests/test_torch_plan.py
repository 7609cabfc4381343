"""The port's serving plans against the JAX package's (``ops/plan.py`` and the
fused plans ``plan_fft_conv{1,2,3}d``), the cases of ``tests/test_plan.py``.

Each test runs one kernel and one signal, seeded numpy arrays, through the
JAX plan (on the CPU: its matmul-DFT or ``jnp.fft`` tier, and the fused
plans in Pallas interpret mode) and through the port's plan built with
``device="cpu"`` (its ``torch.fft`` tier, and the fused plans through the
kernels' plain versions), and holds them with
``helpers._assert_close_scaled``. The port has no matmul-DFT tier: where the
JAX package serves a config through it, the port's ``torch.fft`` tier
computes the same function. Plans on the card are tested in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu.ops.spectral as jax_spectral
import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused1d as jax_fused1d
from fft_conv_tpu.kernels import fused2d as jax_fused2d
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu.ops import plan_fft_conv as jax_plan
from fft_conv_tpu.ops import plan_fft_conv_transpose as jax_plan_t
from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d
from fft_conv_tpu_torch.ops import functional as F
from fft_conv_tpu_torch.ops import plan_fft_conv, plan_fft_conv_transpose

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.fixture
def force_matmul_dft(monkeypatch):
    """The JAX package's matmul-DFT tier on the CPU (tests/test_plan.py)."""
    monkeypatch.setattr(jax_spectral, "use_matmul_dft", lambda fft_shape, platform=None: True)


@pytest.fixture
def spectra_calls(monkeypatch):
    """Counts the calls of every function that computes kernel spectra for
    the fused kernels or their plain versions."""
    calls = []
    for module, name in ((fused1d, "kernel_spectra_one_sided"), (fused1d, "kernel_spectrum"),
                         (fused2d, "kernel_spectra_2d"), (fused2d, "kernel_spectra_2d_planes"),
                         (fused3d, "kernel_spectra_3d"), (fused3d, "kernel_spectra_tap")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


def _signal_grad(fn, x):
    xt = torch.from_numpy(x).requires_grad_()
    fn(xt).sum().backward()
    return xt.grad.numpy()


# ---------------------------------------------------------------------------
# plan_fft_conv


def test_plan_2d_matches_jax_matmul_tier(force_matmul_dft):
    w, b, sig = _arrays(0, (6, 4, 5, 5), (6,), (3, 4, 40, 40))
    kw = dict(stride=2, padding=2, signal_spatial=(40, 40))
    want = jax_plan(jnp.asarray(w), jnp.asarray(b), **kw)(jnp.asarray(sig))
    plan = plan_fft_conv(*_t(w, b), device="cpu", **kw)
    _assert_close_scaled(plan(torch.from_numpy(sig)).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="plan serves spatial shape"):
        plan(torch.ones(1, 4, 32, 32))


def test_plan_3d_grouped_dilated_matches_jax_matmul_tier(force_matmul_dft):
    w, sig = _arrays(1, (4, 2, 3, 3, 3), (1, 4, 12, 12, 12))
    kw = dict(groups=2, dilation=2, signal_spatial=(12, 12, 12))
    want = jax_plan(jnp.asarray(w), **kw)(jnp.asarray(sig))
    got = plan_fft_conv(torch.from_numpy(w), device="cpu", **kw)(torch.from_numpy(sig))
    _assert_close_scaled(got.numpy(), np.asarray(want))


def test_plan_long_axis_matches_jax():
    w, sig = _arrays(2, (2, 2, 9), (1, 2, 4096))
    want = jax_plan(jnp.asarray(w), signal_spatial=(4096,))(jnp.asarray(sig))
    plan = plan_fft_conv(torch.from_numpy(w), signal_spatial=(4096,), device="cpu")
    _assert_close_scaled(plan(torch.from_numpy(sig)).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="plan serves spatial shape"):
        plan(torch.ones(1, 2, 100))


def test_plan_full_arg_surface_matches_jax():
    w, b, sig = _arrays(3, (4, 2, 7), (4,), (2, 4, 4096))
    kw = dict(stride=3, padding=5, dilation=2, groups=2, signal_spatial=(4096,))
    want = jax_plan(jnp.asarray(w), jnp.asarray(b), **kw)(jnp.asarray(sig))
    got = plan_fft_conv(*_t(w, b), device="cpu", **kw)(torch.from_numpy(sig))
    _assert_close_scaled(got.numpy(), np.asarray(want))
    y_ref = torch.nn.functional.conv1d(*_t(sig, w, b), stride=3, padding=5, dilation=2,
                                       groups=2)
    _assert_close_scaled(got.numpy(), y_ref.numpy())


@pytest.mark.parametrize("mode", ["reflect", "circular"])
def test_plan_padding_modes_match_fft_conv(mode):
    w, b, sig = _arrays(4, (3, 2, 5, 4), (3,), (2, 2, 30, 26))
    kw = dict(padding=(2, 3), padding_mode=mode)
    plan = plan_fft_conv(*_t(w, b), signal_spatial=(30, 26), device="cpu", **kw)
    want = ft.fft_conv(*_t(sig, w, b), impl="xla", **kw)
    assert torch.equal(plan(torch.from_numpy(sig)), want)


def test_plan_validates():
    with pytest.raises(ValueError):
        plan_fft_conv(torch.ones(2, 2, 3, 3), signal_spatial=(16,), device="cpu")  # rank
    with pytest.raises(ValueError):
        plan_fft_conv(torch.ones(1, 1, 9), signal_spatial=(4,), device="cpu")  # K > input
    with pytest.raises(ValueError):
        plan_fft_conv(torch.ones(1, 1, 9, 9), signal_spatial=(4, 4), device="cpu")
    with pytest.raises(ValueError):
        jax_plan(jnp.ones((1, 1, 9)), signal_spatial=(4,))


def test_plan_lives_on_its_device(monkeypatch):
    plan = plan_fft_conv(torch.ones(1, 1, 3), signal_spatial=(16,), device="cpu")
    with pytest.raises(ValueError, match="plan lives on cpu"):
        plan(torch.ones(1, 1, 16, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: plan_fft_conv(torch.ones(1, 1, 3), signal_spatial=(16,)),
                  lambda: plan_fft_conv_transpose(torch.ones(1, 1, 3), signal_spatial=(16,)),
                  lambda: fused1d.plan_fft_conv1d(torch.ones(1, 1, 3), signal_length=600),
                  lambda: fused2d.plan_fft_conv2d(torch.ones(1, 1, 3, 3), signal_hw=(20, 20)),
                  lambda: fused3d.plan_fft_conv3d(torch.ones(1, 1, 3, 3, 3),
                                                  signal_dhw=(8, 8, 8))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_tier_one_needs_a_cuda_device():
    """On the CPU every config takes the torch.fft tier, as the JAX package
    takes its composed tiers off the TPU; its result is the composed
    path's, bit for bit."""
    w, sig = _arrays(5, (3, 2, 9, 11), (1, 2, 60, 70))
    plan = plan_fft_conv(torch.from_numpy(w), padding=(4, 5), signal_spatial=(60, 70),
                         device="cpu")
    assert plan.__qualname__.startswith("plan_fft_conv.")
    want = ft.fft_conv(*_t(sig, w), padding=(4, 5), impl="xla")
    assert torch.equal(plan(torch.from_numpy(sig)), want)


# ---------------------------------------------------------------------------
# the fused plans (tier 1), on the CPU through the kernels' plain versions


def test_fused_plan_1d_matches_jax(spectra_calls):
    w, b, sig = _arrays(10, (3, 2, 33), (3,), (4, 2, 1000))
    want = jax_fused1d.plan_fft_conv1d(jnp.asarray(w), jnp.asarray(b), padding=2,
                                       signal_length=1000, max_batch=4)(jnp.asarray(sig))
    plan = fused1d.plan_fft_conv1d(*_t(w, b), padding=2, signal_length=1000, max_batch=4,
                                   device="cpu")
    spectra_calls.clear()
    y = plan(torch.from_numpy(sig))
    assert spectra_calls == []
    _assert_close_scaled(y.numpy(), np.asarray(want))
    assert torch.equal(y, fused1d.fft_conv1d_fused(*_t(sig, w, b), padding=2))
    with pytest.raises(ValueError, match="plan serves spatial shape"):
        plan(torch.ones(4, 2, 999))
    g_ref = _signal_grad(lambda x: ft.fft_conv(x, *_t(w, b), padding=2, impl="xla"), sig)
    _assert_close_scaled(_signal_grad(plan, sig), g_ref)


def test_fused_plan_1d_batch_past_the_budget_takes_the_composed_path(monkeypatch):
    """A call whose batch busts the planned FFT size's scratch budget runs
    the composed path, as the JAX plan's runtime batch check does."""
    w, b, sig = _arrays(11, (3, 2, 33), (3,), (6, 2, 1000))
    want = jax_fused1d.plan_fft_conv1d(jnp.asarray(w), jnp.asarray(b), signal_length=1000,
                                       max_batch=2)(jnp.asarray(sig))
    plan = fused1d.plan_fft_conv1d(*_t(w, b), signal_length=1000, max_batch=2, device="cpu")
    n = fused1d.choose_fft_size(33, 1000, 2, 3, batch=2)
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET", fused1d._scratch_bytes_per_block(n, 4, 2))
    assert fused1d.cell_fits(n, 2, 2, 3) and not fused1d.cell_fits(n, 6, 2, 3)
    calls = []
    real = fused1d._fused_forward_reference
    monkeypatch.setattr(fused1d, "_fused_forward_reference",
                        lambda *a: calls.append(1) or real(*a))
    y = plan(torch.from_numpy(sig))
    assert calls == []
    assert torch.equal(y, ft.fft_conv(*_t(sig, w, b), impl="xla"))
    _assert_close_scaled(y.numpy(), np.asarray(want))
    plan(torch.from_numpy(sig[:2]))
    assert calls == [1]


def test_fused_plan_2d_matches_jax_and_follows_the_switch(spectra_calls):
    w, b, sig = _arrays(20, (3, 2, 9, 11), (3,), (1, 2, 60, 70))
    jplan = jax_fused2d.plan_fft_conv2d(jnp.asarray(w), jnp.asarray(b), padding=(4, 5),
                                        signal_hw=(60, 70))
    want = np.asarray(jplan(jnp.asarray(sig)))
    plan = fused2d.plan_fft_conv2d(*_t(w, b), padding=(4, 5), signal_hw=(60, 70), device="cpu")
    spectra_calls.clear()
    y = plan(torch.from_numpy(sig))
    _assert_close_scaled(y.numpy(), want)
    # the schedule is read at call time: B5's plain version on the same spectra
    calls = []
    real = fused2d._fused2d_forward_reference_v3
    try:
        fused2d._fused2d_forward_reference_v3 = lambda *a: calls.append(1) or real(*a)
        fused2d.set_fused2d_kernel("v3")
        y3 = plan(torch.from_numpy(sig))
    finally:
        fused2d._fused2d_forward_reference_v3 = real
        fused2d.set_fused2d_kernel("v2")
    assert calls == [1] and spectra_calls == []
    _assert_close_scaled(y3.numpy(), want)
    with pytest.raises(ValueError, match="plan serves spatial shape"):
        plan(torch.zeros(1, 2, 64, 64))
    g = jax.grad(lambda s: jplan(s).sum())(jnp.asarray(sig))
    _assert_close_scaled(_signal_grad(plan, sig), np.asarray(g))


@pytest.mark.parametrize("kd", [4, 11])
def test_fused_plan_3d_matches_jax(spectra_calls, kd):
    """v4 (KD <= 9, kernel B3) and tap (KD > 9, kernel B4)."""
    w, b, sig = _arrays(21 + kd, (2, 2, kd, 5, 3), (2,), (1, 2, 30, 24, 20))
    assert fused3d.plan_3d(2, 2, 32, 26, 22, kd, 5, 3)[0] == ("v4" if kd <= 9 else "tap")
    jplan = jax_fused3d.plan_fft_conv3d(jnp.asarray(w), jnp.asarray(b), padding=1,
                                        signal_dhw=(30, 24, 20))
    plan = fused3d.plan_fft_conv3d(*_t(w, b), padding=1, signal_dhw=(30, 24, 20), device="cpu")
    spectra_calls.clear()
    y = plan(torch.from_numpy(sig))
    assert spectra_calls == []
    _assert_close_scaled(y.numpy(), np.asarray(jplan(jnp.asarray(sig))))
    with pytest.raises(ValueError, match="plan serves spatial shape"):
        plan(torch.zeros(1, 2, 8, 8, 8))
    g = jax.grad(lambda s: jplan(s).sum())(jnp.asarray(sig))
    _assert_close_scaled(_signal_grad(plan, sig), np.asarray(g))


def test_fused_plan_3d_w_blocked_and_packed_matches_jax():
    """W wider than 64 in W blocks that share the baked spectra; under "pk"
    the same plan packs the signal (B6's plain version) and agrees exactly."""
    w, b, sig = _arrays(11, (2, 2, 3, 3, 5), (2,), (1, 2, 12, 12, 100))
    assert fused3d.plan_3d(2, 2, 12, 12, 100, 3, 3, 5) is None
    assert fused3d.plan_3d_blocked(2, 2, 12, 12, 100, 3, 3, 5)[1] == 2
    want = jax_fused3d.plan_fft_conv3d(jnp.asarray(w), jnp.asarray(b),
                                       signal_dhw=(12, 12, 100))(jnp.asarray(sig))
    plan = fused3d.plan_fft_conv3d(*_t(w, b), signal_dhw=(12, 12, 100), device="cpu")
    y = plan(torch.from_numpy(sig))
    _assert_close_scaled(y.numpy(), np.asarray(want))
    try:
        fused3d.set_fused3d_xpack("pk")
        assert torch.equal(plan(torch.from_numpy(sig)), y)
    finally:
        fused3d.set_fused3d_xpack("h2")


def test_fused_plans_validate():
    with pytest.raises(ValueError, match="expects"):
        fused2d.plan_fft_conv2d(torch.ones(1, 1, 3), signal_hw=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="expects"):
        fused3d.plan_fft_conv3d(torch.ones(1, 1, 3, 3), signal_dhw=(8, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="no fused 2D configuration"):
        fused2d.plan_fft_conv2d(torch.ones(1, 1, 3, 250), signal_hw=(8, 400), device="cpu")
    with pytest.raises(ValueError, match="Kernel size"):
        fused3d.plan_fft_conv3d(torch.ones(1, 1, 9, 3, 3), signal_dhw=(8, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="no fused 3D configuration"):
        fused3d.plan_fft_conv3d(torch.ones(1, 1, 2, 2, 70), signal_dhw=(8, 8, 300),
                                device="cpu")
    # no fused size at this length: each call runs fft_conv1d_fused, which raises
    plan = fused1d.plan_fft_conv1d(torch.ones(1, 1, 8200), signal_length=9000, device="cpu")
    with pytest.raises(ValueError, match="no fused FFT configuration"):
        plan(torch.ones(1, 1, 9000))


# ---------------------------------------------------------------------------
# plan_fft_conv_transpose


def test_plan_transpose_2d_full_arg_surface_matches_jax(force_matmul_dft):
    w, b, sig = _arrays(30, (4, 2, 5, 5), (4,), (2, 4, 20, 18))
    kw = dict(stride=2, padding=2, output_padding=1, dilation=2, groups=2,
              signal_spatial=(20, 18))
    want = jax_plan_t(jnp.asarray(w), jnp.asarray(b), **kw)(jnp.asarray(sig))
    plan = plan_fft_conv_transpose(*_t(w, b), device="cpu", **kw)
    _assert_close_scaled(plan(torch.from_numpy(sig)).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="plan serves spatial shape"):
        plan(torch.ones(1, 4, 16, 16))
    with pytest.raises(ValueError, match="in_channels"):
        plan(torch.ones(1, 2, 20, 18))


@pytest.mark.parametrize("kw", [
    dict(stride=2, padding=3),
    dict(stride=3, padding=2, output_padding=2, dilation=2, groups=2),
])
def test_plan_transpose_1d_matches_jax(kw):
    w, b, sig = _arrays(31, (2, 3, 9), (6,), (1, 2, 2048))
    b = b[:3 * kw.get("groups", 1)]
    want = jax_plan_t(jnp.asarray(w), jnp.asarray(b), signal_spatial=(2048,),
                      **kw)(jnp.asarray(sig))
    got = plan_fft_conv_transpose(*_t(w, b), signal_spatial=(2048,), device="cpu",
                                  **kw)(torch.from_numpy(sig))
    _assert_close_scaled(got.numpy(), np.asarray(want))
    y_ref = torch.nn.functional.conv_transpose1d(*_t(sig, w, b), **kw)
    _assert_close_scaled(got.numpy(), y_ref.numpy())


def test_plan_transpose_3d_matches_jax(force_matmul_dft, monkeypatch):
    """Stride, dilation, groups and output_padding in 3D; the kernel-side
    transform runs once, when the plan is built."""
    w, b, sig = _arrays(32, (4, 1, 3, 2, 3), (2,), (1, 4, 6, 7, 5))
    kw = dict(stride=(2, 1, 3), padding=1, output_padding=(1, 0, 2), dilation=(1, 2, 1),
              groups=2, signal_spatial=(6, 7, 5))
    want = jax_plan_t(jnp.asarray(w), jnp.asarray(b), **kw)(jnp.asarray(sig))
    calls = []
    real = F._transpose_kernel_layout
    monkeypatch.setattr(F, "_transpose_kernel_layout", lambda *a: calls.append(1) or real(*a))
    plan = plan_fft_conv_transpose(*_t(w, b), device="cpu", **kw)
    y = plan(torch.from_numpy(sig))
    y = plan(torch.from_numpy(sig))
    assert calls == [1]
    _assert_close_scaled(y.numpy(), np.asarray(want))
    y_ref = ft.fft_conv_transpose(*_t(sig, w, b), impl="xla",
                                  **{k: v for k, v in kw.items() if k != "signal_spatial"})
    _assert_close_scaled(y.numpy(), y_ref.numpy())


def test_plan_transpose_validates():
    with pytest.raises(ValueError):
        plan_fft_conv_transpose(torch.ones(2, 2, 3, 3), signal_spatial=(16,), device="cpu")
    with pytest.raises(ValueError):
        plan_fft_conv_transpose(torch.ones(3, 2, 3), groups=2, signal_spatial=(16,),
                                device="cpu")
    with pytest.raises(ValueError, match="non-positive"):
        plan_fft_conv_transpose(torch.ones(1, 1, 3), padding=4, signal_spatial=(2,),
                                device="cpu")


def test_plans_are_exported_as_in_the_jax_package():
    from fft_conv_tpu_torch import kernels, ops

    assert ops.plan_fft_conv is plan_fft_conv
    assert ops.plan_fft_conv_transpose is plan_fft_conv_transpose
    assert kernels.plan_fft_conv1d is fused1d.plan_fft_conv1d
    assert kernels.plan_fft_conv2d is fused2d.plan_fft_conv2d
    assert kernels.plan_fft_conv3d is fused3d.plan_fft_conv3d
