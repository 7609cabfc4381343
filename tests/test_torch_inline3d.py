"""The 3D inline-spectra switch and kernel B7 against the JAX package's.

``set_fused3d_inline(True)`` makes an unplanned 'v4' call compute its kernel
spectra from the raw taps with kernel B7 (``fused3d._launch_spectra_v4`` on
the card, ``_spectra_v4_reference`` on the CPU) in place of
``kernel_spectra_3d``. Here the plain version is held to the complex128
spectra of a float64 kernel (``kernel_spectra_3d``) within 1e-5·max|ref|,
and so is the library call that ``chip_smoke.py`` times beside B7
(``torch.fft.fftn`` with the one-sided slice and the conjugate); the whole
route under inline to the JAX route under its inline switch, with
``helpers._assert_close_scaled``, on the inputs of
``tests/test_pallas3d.py::test_fused3d_inline_spectra_matches_loop``; and the
route's rules: off by default, never for plans or 'tap' calls. The CUDA
kernel itself is tested on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu_torch.kernels import fused3d
from fft_conv_tpu_torch.ops import plan_fft_conv

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def inline():
    """Both packages' inline switches on, restored after the test."""
    was, jax_was = fused3d._INLINE3D, jax_fused3d._INLINE3D
    fused3d.set_fused3d_inline(True)
    jax_fused3d.set_fused3d_inline(True)
    try:
        yield
    finally:
        fused3d.set_fused3d_inline(was)
        jax_fused3d.set_fused3d_inline(jax_was)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of B7's plain version."""
    calls = []
    real = fused3d._spectra_v4_reference

    def counted(kernel, hw):
        calls.append(hw)
        return real(kernel, hw)

    monkeypatch.setattr(fused3d, "_spectra_v4_reference", counted)
    return calls


# H (the dense H < 16, factored 16 and 20, 34 padded to Hw 36, 48 = 8 x 6, 82
# padded to 84, the dense 300), KD at 1, 5 and the largest v4 takes, groups
SPECTRA_H = (12, 16, 20, 34, 48, 82, 300)


def _kernel64(seed, groups, kd, h):
    rng = np.random.default_rng(seed)
    kh = min(h, 5)
    return torch.from_numpy(rng.standard_normal((4, 4 // groups, kd, kh, 7)))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("kd", [1, 5, 9])
@pytest.mark.parametrize("h", SPECTRA_H)
def test_plain_version_matches_complex128_spectra(h, kd, groups):
    """B7's plain version, FP32 from the taps, against the complex128
    spectra of the float64 kernel at the working length: within
    1e-5·max|ref|, in B3's layout (Cout, Cin/g, 16, Hw/2+1, 64)."""
    k = _kernel64(h * 10 + kd, groups, kd, h)
    hw = fused3d._h_work(h)[0]
    ref = fused3d.kernel_spectra_3d(k, hw)
    got = fused3d._spectra_v4_reference(k.float(), hw)
    assert ref.dtype == torch.complex128 and got.dtype == torch.complex64
    assert got.shape == ref.shape == (4, 4 // groups, 16, hw // 2 + 1, 64)
    err = float((got.to(torch.complex128) - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


@pytest.mark.parametrize("h", SPECTRA_H)
def test_fftn_is_the_same_function(h):
    """The library yardstick of B7 (chip_smoke.py's ``library_ms``): one
    ``torch.fft.fftn`` over (D, H, W) at (16, Hw, 64), cut to the Hw/2+1
    one-sided H bins and conjugated, is ``kernel_spectra_3d``: to float64
    rounding on the float64 kernel, within B7's bar on the float32 one."""
    k = _kernel64(h, 1, 9, h)
    hw = fused3d._h_work(h)[0]
    ref = fused3d.kernel_spectra_3d(k, hw)

    def fftn(t):
        return torch.fft.fftn(t, s=(16, hw, 64), dim=(2, 3, 4))[:, :, :, :hw // 2 + 1].conj()

    scale = float(ref.abs().max())
    assert float((fftn(k) - ref).abs().max()) <= 1e-12 * scale
    assert float((fftn(k.float()).to(torch.complex128) - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("groups", [1, 2])
def test_inline_matches_jax_inline(inline, groups):
    """The inputs of the JAX package's inline test, through both packages'
    fused 3D functions with their inline switches on; on the CPU the port
    runs B7's plain version and launches nothing."""
    sig, ker, bias = _arrays(29, (1, 4, 20, 16, 14), (4, 4 // groups, 5, 3, 3), (4,))
    assert jax_fused3d._inline_fits_v4(4, 4, 20, 16, 14, 5, 3, 3, groups)
    assert fused3d._inline_fits_v4(4, 4, 20, 16, 14, 5, 3, 3, groups)
    want = jax_fused3d.fft_conv3d_fused(jnp.asarray(sig), jnp.asarray(ker),
                                        jnp.asarray(bias), groups=groups)
    before = fused3d.launches_spectra
    got = fused3d.fft_conv3d_fused(torch.from_numpy(sig), torch.from_numpy(ker),
                                   torch.from_numpy(bias), groups=groups)
    assert fused3d.launches_spectra == before
    _assert_close_scaled(got.numpy(), np.asarray(want))


def test_inline_is_off_by_default():
    assert fused3d._INLINE3D is False and jax_fused3d._INLINE3D is False
    fused3d.set_fused3d_inline(True)
    try:
        assert fused3d._INLINE3D is True
    finally:
        fused3d.set_fused3d_inline(False)
    assert fused3d._INLINE3D is False


def test_inline_route_on_the_cpu(inline, plain_calls):
    """An unplanned 'v4' call runs the plain version once and equals the
    call with the switch off; a 'tap' call and a serving plan never take it;
    no B7 launch is counted on the CPU."""
    x, k, xt, kt = (torch.from_numpy(a) for a in _arrays(
        3, (2, 3, 13, 18, 20), (4, 3, 3, 4, 5), (1, 2, 14, 8, 8), (2, 2, 11, 3, 3)))
    before = fused3d.launches_spectra
    y = ft.fft_conv(x, k, impl="fused")
    assert plain_calls == [18]
    fused3d.set_fused3d_inline(False)
    y_off = ft.fft_conv(x, k, impl="fused")
    fused3d.set_fused3d_inline(True)
    _assert_close_scaled(y.numpy(), y_off.numpy())

    assert fused3d.plan_3d(2, 2, 14, 8, 8, 11, 3, 3)[0] == "tap"
    assert not fused3d._inline_fits_v4(2, 2, 14, 8, 8, 11, 3, 3)
    ft.fft_conv(xt, kt, impl="fused")
    plan = plan_fft_conv(k, signal_spatial=(13, 18, 20), device="cpu")
    assert fused3d.plan_3d(3, 4, 13, 18, 20, 3, 4, 5)[0] == "v4"
    _assert_close_scaled(plan(x).numpy(), y_off.numpy())
    planned = fused3d.plan_fft_conv3d(k, signal_dhw=(13, 18, 20), device="cpu")
    _assert_close_scaled(planned(x).numpy(), y_off.numpy())
    assert plain_calls == [18] and fused3d.launches_spectra == before


def test_inline_takes_w_blocks_pk_and_the_transposed_route(inline, plain_calls):
    """W cut into blocks (the blocks share one set of spectra), "pk" (B6
    ahead of B3) and the fused transposed route (a 'v4' plan on the stuffed
    signal) each take inline once and equal their calls with the switch
    off."""
    x, k, xs, ks = (torch.from_numpy(a) for a in _arrays(
        5, (1, 2, 10, 12, 150), (2, 2, 3, 3, 7), (1, 2, 6, 7, 8), (2, 3, 3, 3, 3)))
    calls = [
        lambda: fused3d.fft_conv3d_fused(x, k),
        lambda: ft.fft_conv_transpose(xs, ks, stride=2, padding=1, impl="fused"),
    ]
    assert fused3d.plan_3d_blocked(2, 2, 10, 12, 150, 3, 3, 7)[1] == 3
    for i, call in enumerate(calls):
        y = call()
        assert len(plain_calls) == i + 1
        fused3d.set_fused3d_inline(False)
        _assert_close_scaled(y.numpy(), call().numpy())
        fused3d.set_fused3d_inline(True)
    was = fused3d._XPACK3D
    fused3d.set_fused3d_xpack("pk")
    try:
        y = calls[0]()
    finally:
        fused3d.set_fused3d_xpack(was)
    assert len(plain_calls) == 3
    _assert_close_scaled(y.numpy(), calls[0]().numpy())


def test_inline_gradients_match_composed(inline, plain_calls):
    """The backward stays the composed path: gradients under inline equal
    those of impl="xla"."""
    x0, k0, b0 = _arrays(7, (2, 2, 12, 16, 12), (3, 2, 4, 3, 3), (3,))
    grads = []
    for impl in ("fused", "xla"):
        x, k, b = (torch.from_numpy(a).requires_grad_() for a in (x0, k0, b0))
        (ft.fft_conv(x, k, b, impl=impl) ** 2).sum().backward()
        grads.append((x.grad, k.grad, b.grad))
    assert plain_calls == [16]
    for got, want in zip(*grads):
        _assert_close_scaled(got.numpy(), want.numpy())


def test_spectra_launcher_raises_on_the_cpu():
    """The kernel's wrapper launches or raises: a CPU tensor is refused,
    and nothing is counted."""
    before = fused3d.launches_spectra
    with pytest.raises(ValueError, match="CUDA device"):
        fused3d._launch_spectra_v4(torch.ones(2, 2, 3, 3, 3), 16)
    assert fused3d.launches_spectra == before


def test_gate_follows_the_v4_plan():
    """The gate is B3's 'v4' plan (W blocks included) and B7's shared
    memory: refused where the plan is 'tap', where none fits and where a
    pair's taps do not fit a block."""
    assert fused3d._inline_fits_v4(8, 8, 64, 64, 64, 8, 8, 8)
    assert fused3d._inline_fits_v4(8, 8, 78, 78, 78, 8, 8, 8)           # 2 W blocks
    assert not fused3d._inline_fits_v4(8, 8, 64, 64, 64, 10, 10, 10)   # 'tap'
    assert not fused3d._inline_fits_v4(16, 16, 64, 64, 64, 3, 3, 3)    # no plan
    assert fused3d._spectra_smem_bytes(8, 8, 8) == (8 * 64 + 8 * 8 + 8 * 8 * 64) * 8 + 512 * 4
    # the taps of a pair share the block's shared memory: H = 300 with KH =
    # 300 and KW = 64 plans 'v4' (spectra 4.6 MB) but its 691 KB of taps do not fit
    assert fused3d.plan_3d(1, 1, 10, 300, 64, 9, 300, 64)[0] == "v4"
    assert not fused3d._inline_fits_v4(1, 1, 10, 300, 64, 9, 300, 64)
    assert fused3d._inline_fits_v4(1, 1, 10, 300, 64, 9, 40, 64)
