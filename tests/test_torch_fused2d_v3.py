"""The port's v3 2D schedule (kernel B5's plain version) against the JAX
package's, and against the v2 schedule and the composed path.

On the CPU, under ``set_fused2d_kernel("v3")``, the port's wrapper runs
``_fused2d_forward_reference_v3``; the JAX wrapper, under its own
``set_fused2d_kernel("v3")``, runs the Pallas v3 kernel in interpret mode, as
``tests/test_pallas2d.py`` runs it. The JAX switch is set in ``try/finally``
and restored. Kernel B5 itself is tested on the card in
``test_torch_cuda.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused2d as jax_fused2d
from fft_conv_tpu_torch.kernels import fused2d

from helpers import _assert_close_scaled
from test_torch_fused2d import PARITY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def v3():
    """Both packages on the v3 schedule for the test's duration."""
    was, was_jax = fused2d._KERNEL2D_VERSION, jax_fused2d._KERNEL2D_VERSION
    fused2d.set_fused2d_kernel("v3")
    try:
        jax_fused2d.set_fused2d_kernel("v3")
        yield
    finally:
        jax_fused2d.set_fused2d_kernel(was_jax)
        fused2d.set_fused2d_kernel(was)


@pytest.mark.parametrize("t1,t2,v1", [(128, 128, 112), (256, 128, 184), (128, 256, 88),
                                      (384, 128, 184)])
def test_mats_v3_match_jax_without_the_padded_rows(t1, t2, v1):
    nb1 = t1 // 2 + 1
    nb1p = -(-nb1 // 8) * 8
    f2, wr, wi, ur, ui, cz1, cz2 = fused2d._mats_2d_v3(t1, nb1, t2, v1)
    jf2, jwr, jwi, jur, jui, jcz1, jcz2 = jax_fused2d._mats_2d_v3(t1, nb1, nb1p, t2, v1)
    rows = np.r_[0:nb1, nb1p:nb1p + nb1]  # the JAX rows that are not padding
    pairs = [(f2, jf2[rows]), (wr, jwr), (wi, jwi), (ur, jur), (ui, jui),
             (cz1, jcz1[:, rows]), (cz2, jcz2[:, rows])]
    for a, b in pairs:
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6
    # the padding the port drops is zero in the JAX factors
    assert not jf2[nb1:nb1p].any() and not jcz1[:, nb1:nb1p].any()
    f2_64 = fused2d._mats_2d_v3(t1, nb1, t2, v1, np.float64)[0]
    assert f2_64.dtype == np.float64 and np.abs(f2_64 - f2).max() < 1e-6


# every plan tile_plan_2d admits, each at V1 = T1 - 15 and T1 - 33 (odd, so
# the last row pair of the W c2r has one row)
PLANS = [(128, 128), (256, 128), (384, 128), (128, 256)]


@pytest.mark.parametrize("t1,t2,v1", [(t1, t2, t1 - c) for t1, t2 in PLANS for c in (15, 33)])
def test_folded_inverse_equals_dense_v3_inverse_in_float64(t1, t2, v1):
    """B5's folded H-first inverse (the column-pair spectra S, one T1-point
    inverse each on the V1 rows, then the W c2r on row pairs) equals the
    dense v3 inverse cz1·Y·ur - cz2·Y·ui for a Y that is not Hermitian."""
    nb1 = t1 // 2 + 1
    yr, yi = np.random.default_rng(t1 + t2 + v1).standard_normal((2, 2, nb1, t2))
    _, _, _, ur, ui, cz1, cz2 = fused2d._mats_2d_v3(t1, nb1, t2, v1, np.float64)
    y2 = np.concatenate([yr, yi], axis=-2)
    want = (cz1 @ y2) @ ur - (cz2 @ y2) @ ui
    got = fused2d._v3_inverse(torch.from_numpy(yr), torch.from_numpy(yi), v1)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("t1,t2", PLANS)
def test_packed_column_forward_equals_dense_v3_forward_in_float64(t1, t2):
    """B5's H-first forward on packed column pairs equals the dense v3
    forward: [hr; hi] = f2·a, dr = hr·wr - hi·wi, di = hr·wi + hi·wr."""
    nb1 = t1 // 2 + 1
    a = np.random.default_rng(t1 * t2).standard_normal((2, t1, t2))
    f2, wr, wi = fused2d._mats_2d_v3(t1, nb1, t2, 1, np.float64)[:3]
    b2 = f2 @ a
    hr, hi = b2[:, :nb1], b2[:, nb1:]
    want = hr @ wr - hi @ wi, hr @ wi + hi @ wr
    got = fused2d._v3_forward(torch.from_numpy(a))
    scale = max(np.abs(m).max() for m in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-12 * scale


# every plan at an odd V1, so that the W c2r's last row pair holds one row
ODD_V1 = [(t1, t2, t1 - c) for (t1, t2), c in zip(PLANS, (15, 33, 31, 17))]


@pytest.mark.parametrize("t1,t2,v1", ODD_V1)
def test_tensor_core_order_equals_dense_v3_in_float64(t1, t2, v1):
    """The order of B5's tensor-core route, which ``_v3_forward`` and
    ``_v3_inverse`` run when a mode's product is passed as ``dot`` (here the
    exact float64 ``torch.matmul``): the W DFT on T1/2 rows, rows 0 and T1/2
    packed as one complex row and split into D's rows 0 and T1/2, and the W
    c2r of row pairs (at an odd V1 the last pair has one row), equal the
    dense v3 forward and inverse of ``_mats_2d_v3``, as the unpacked order
    does."""
    nb1 = t1 // 2 + 1
    rng = np.random.default_rng(t1 + t2 + v1)
    a = rng.standard_normal((2, t1, t2))
    yr, yi = rng.standard_normal((2, 2, nb1, t2))
    f2, wr, wi, ur, ui, cz1, cz2 = fused2d._mats_2d_v3(t1, nb1, t2, v1, np.float64)
    b2 = f2 @ a
    hr, hi = b2[:, :nb1], b2[:, nb1:]
    want = hr @ wr - hi @ wi, hr @ wi + hi @ wr
    got = fused2d._v3_forward(torch.from_numpy(a), torch.matmul)
    scale = max(np.abs(m).max() for m in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-12 * scale
    y2 = np.concatenate([yr, yi], axis=-2)
    want = (cz1 @ y2) @ ur - (cz2 @ y2) @ ui
    got = fused2d._v3_inverse(torch.from_numpy(yr), torch.from_numpy(yi), v1, torch.matmul)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("shape,k,groups", [
    ((2, 3, 140, 170), (4, 3, 16, 16), 1),
    ((1, 4, 150, 160), (6, 2, 9, 7), 2),     # groups
    ((1, 2, 140, 300), (2, 2, 12, 100), 1),  # T2 = 256
])
def test_plain_v3_matches_plain_v2(shape, k, groups):
    """The two schedules' plain versions agree in float32 on the same inputs."""
    x, w = (torch.from_numpy(a) for a in _arrays(sum(k) + groups, shape, k))
    y = fused2d._fused2d_forward_reference_v3(x, w, groups)
    assert y.dtype == torch.float32
    _assert_close_scaled(y.numpy(), fused2d._fused2d_forward_reference(x, w, groups).numpy())


@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups,stride,dilation,padding,mode", PARITY)
def test_plain_v3_matches_jax_fused_v3(v3, b, cin, cout, h, w, k1, k2, groups, stride,
                                       dilation, padding, mode):
    x, k, bias = _arrays(h + w + k1, (b, cin, h, w), (cout, cin // groups, k1, k2), (cout,))
    kw = dict(padding=padding, padding_mode=mode, stride=stride, dilation=dilation,
              groups=groups)
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw)
    before = fused2d.launches, fused2d.launches_v3
    y = fused2d.fft_conv2d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw)
    assert (fused2d.launches, fused2d.launches_v3) == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


@pytest.mark.parametrize("shape,k,groups", [
    ((2, 4, 300, 260), (4, 4, 16, 16), 1),    # 3 x 3 tiles, partial last ones
    ((2, 4, 160, 150), (6, 2, 9, 7), 2),      # groups
    ((1, 4, 130, 400), (6, 2, 12, 100), 2),   # T2 = 256
    ((1, 2, 300, 140), (2, 2, 70, 5), 1),     # T1 = 256
    ((1, 1, 400, 60), (2, 1, 200, 9), 1),     # T1 = 384
])
def test_plain_v3_is_exact_in_float64(shape, k, groups):
    """The v3 schedule in float64 equals the v2 schedule and the composed
    path to float64 rounding: stacking re and im into rows and running the
    inverse H first change nothing but the order of the arithmetic."""
    x, w = _arrays(sum(shape) + 1, shape, k)
    xt = torch.from_numpy(x).double()
    wt = torch.from_numpy(w).double()
    y = fused2d._fused2d_forward_reference_v3(xt, wt, groups)
    assert y.dtype == torch.float64
    assert (y - fused2d._fused2d_forward_reference(xt, wt, groups)).abs().max() < 1e-9
    assert (y - ft.fft_conv(xt, wt, groups=groups, impl="xla")).abs().max() < 1e-9


def test_fft_conv_under_v3_matches_jax(v3):
    """The public entry point on both sides under "v3"; CPU "auto" stays the
    composed path on both."""
    x, k, bias = _arrays(7, (2, 3, 140, 170), (4, 3, 16, 16), (4,))
    xt, kt, bt = map(torch.from_numpy, (x, k, bias))
    y = ft.fft_conv(xt, kt, bt, padding=2, impl="fused")
    y_jax = jax_fused2d.fft_conv2d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                         padding=2)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))
    before = fused2d.launches, fused2d.launches_v3
    y_auto = ft.fft_conv(xt, kt, bt, padding=2)
    assert torch.equal(y_auto, ft.fft_conv(xt, kt, bt, padding=2, impl="xla"))
    assert (fused2d.launches, fused2d.launches_v3) == before


def test_v3_gradients_match_composed(v3):
    x, w = _arrays(3, (2, 4, 140, 150), (4, 2, 9, 11))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    kw = dict(padding=(2, 3), groups=2)
    (fused2d.fft_conv2d_fused(xt, wt, **kw) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv(xt, wt, impl="xla", **kw) ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_switch_validates_and_is_read_at_call_time():
    was = fused2d._KERNEL2D_VERSION
    assert was == "v2"  # the default, as in the JAX package
    with pytest.raises(ValueError, match="unknown fused2d kernel version"):
        fused2d.set_fused2d_kernel("v4")
    with pytest.raises(ValueError, match="unknown fused2d kernel version"):
        jax_fused2d.set_fused2d_kernel("v4")
    assert fused2d._KERNEL2D_VERSION == was
    x, w = (torch.from_numpy(a).double() for a in _arrays(9, (1, 2, 150, 140), (2, 2, 9, 7)))
    calls = []
    real = fused2d._fused2d_forward_reference_v3
    try:
        fused2d._fused2d_forward_reference_v3 = lambda *a: calls.append(1) or real(*a)
        ft.fft_conv(x, w, impl="fused")
        assert not calls
        fused2d.set_fused2d_kernel("v3")
        y = ft.fft_conv(x, w, impl="fused")
        assert calls == [1]
    finally:
        fused2d._fused2d_forward_reference_v3 = real
        fused2d.set_fused2d_kernel(was)
    assert fused2d._KERNEL2D_VERSION == "v2"
    _assert_close_scaled(y.numpy(), ft.fft_conv(x, w, impl="xla").numpy())


def test_environment_variable_selects_v3_at_import():
    code = ("from fft_conv_tpu_torch.kernels import fused2d; "
            "print(fused2d._KERNEL2D_VERSION)")
    env = {**os.environ, "FFTCONV_2D_KERNEL": "v3"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "v3"


@pytest.mark.parametrize("t2", [128, 256])
def test_v3_shared_memory_fits_where_v2_does(t2):
    """B5 accepts every tile plan that B2 does, and no other, so the switch
    never changes routing (``tile_plan_2d`` has one gate)."""
    for t1 in range(128, 1025, 128):
        nb1 = t1 // 2 + 1
        assert ((fused2d._smem_bytes(nb1, t2) <= fused2d._SMEM_LIMIT)
                == (fused2d._smem_bytes_v3(nb1, t2) <= fused2d._SMEM_LIMIT)), t1
    # the largest plan: T1 = 384 at T2 = 128, and T1 = 128 at T2 = 256
    assert fused2d._smem_bytes_v3(193, 128) == 226816
    assert fused2d._smem_bytes_v3(65, 256) == 169408
    assert fused2d._smem_bytes_v3(65, 128) == 101760


def test_v3_kernel_wrapper_takes_only_cuda_tensors():
    plan = fused2d.tile_plan_2d(5, 5, 2, 2)
    spectra = fused2d.kernel_spectra_2d_planes(torch.zeros(2, 2, 5, 5), plan[0], plan[2], plan[3])
    assert spectra.shape == (2, 2, 2, plan[2], plan[3]) and spectra.dtype == torch.float32
    with pytest.raises(ValueError, match="CUDA"):
        fused2d._launch_fused2d_v3(torch.zeros(1, 2, 40, 40), spectra, plan, 1, (5, 5))
