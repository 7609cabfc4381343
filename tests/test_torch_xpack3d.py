"""The 3D x-pack switch and kernel B6 against the JAX package's.

``set_fused3d_xpack("pk")`` makes a 'v4' plan pack the signal with kernel B6
(``fused3d._launch_pack3d`` on the card, ``_pack3d_reference`` on the CPU)
and run B3 on the packed layout. Here the plain version of B6 is held to the
JAX package's ``_pack3d_call`` in interpret mode, exactly, on the same
padded and W-blocked input; the whole route under "pk" to the JAX route under
its "pk", with ``helpers._assert_close_scaled``. The CUDA kernel itself is
tested on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu_torch.kernels import fused3d

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def pk():
    """Both packages under "pk", restored after the test."""
    was, jax_was = fused3d._XPACK3D, jax_fused3d._XPACK3D
    fused3d.set_fused3d_xpack("pk")
    jax_fused3d.set_fused3d_xpack("pk")
    try:
        yield
    finally:
        fused3d.set_fused3d_xpack(was)
        jax_fused3d.set_fused3d_xpack(jax_was)


def _jax_packed_input(x, pp, nwb, hop):
    """What the JAX wrapper hands ``_pack3d_call`` (fused3d.py:1443-1458,
    :1485-1492, :1505-1507): the W blocks stacked into the batch, D padded
    to 2·PP and W to 64, as (B', Cin·2PP, H, 64)."""
    b, cin, d, h, w = x.shape
    if w > 64:
        x = np.stack([x[..., s:s + 64] for s in (min(i * hop, w - 64) for i in range(nwb))],
                     axis=1).reshape(b * nwb, cin, d, h, 64)
    x = np.pad(x, ((0, 0), (0, 0), (0, 2 * pp - d), (0, 0), (0, 64 - x.shape[-1])))
    return x.reshape(x.shape[0], cin * 2 * pp, h, 64)


# (B, Cin, D, H, W, (KD, KH, KW), groups): D < 2PP with W < 64, W > 64 in two
# W blocks (the clamped last block starts off 16 B alignment), groups = 2 at
# W = 64, and W > 64 in three blocks
PACK_CASES = [
    (1, 2, 20, 16, 14, (5, 3, 3), 1),
    (2, 3, 12, 6, 78, (3, 3, 8), 1),
    (1, 4, 9, 5, 64, (2, 3, 3), 2),
    (1, 2, 16, 4, 130, (9, 2, 7), 1),
]


@pytest.mark.parametrize("b,cin,d,h,w,k,groups", PACK_CASES)
def test_pack_reference_equals_jax_pack_call(b, cin, d, h, w, k, groups):
    (x,) = _arrays(d + h + w, (b, cin, d, h, w))
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cin, d, h, w, *k, groups)
    assert plan[0] == "v4" and 2 * plan[3] >= d
    pp = plan[3]
    xj = _jax_packed_input(x, pp, nwb, hop)
    want = np.asarray(jax_fused3d._pack3d_call(b * nwb, cin, pp, h, True)(jnp.asarray(xj)))
    got = fused3d._pack3d_reference(torch.from_numpy(x), pp, nwb, hop)
    assert tuple(got.shape) == want.shape == (b * nwb, h, cin * pp, 128)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("groups", [1, 2])
def test_pk_matches_jax_pk(pk, groups):
    """The cases of tests/test_pallas3d.py::test_fused3d_xpack_matches_torch
    under "pk" in both packages."""
    x, k, bias = _arrays(31, (1, 4, 20, 16, 14), (4, 4 // groups, 5, 3, 3), (4,))
    assert fused3d.plan_3d(4, 4, 20, 16, 14, 5, 3, 3, groups)[0] == "v4"
    y_jax = jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                         groups=groups)
    y = fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), groups=groups)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


@pytest.mark.parametrize("b,cin,d,h,w,k,groups", PACK_CASES)
def test_pk_equals_direct_read_exactly(b, cin, d, h, w, k, groups):
    """B3's packed read and its direct read see the same values in the same
    order, so on the CPU the two plain versions agree bit for bit."""
    x, kern = _arrays(7, (b, cin, d, h, w), (cin, cin // groups) + k)
    xt, kt = torch.from_numpy(x), torch.from_numpy(kern)
    direct = fused3d._fused3d_forward_reference(xt, kt, groups)
    packed = fused3d._fused3d_forward_reference(xt, kt, groups, packed=True)
    assert torch.equal(direct, packed)
    was = fused3d._XPACK3D
    try:
        fused3d.set_fused3d_xpack("pk")
        assert torch.equal(fused3d.fft_conv3d_fused(xt, kt, groups=groups), direct)
    finally:
        fused3d.set_fused3d_xpack(was)


def test_switch_is_read_at_call_time_and_skips_tap_plans(monkeypatch):
    """Under "pk" a 'v4' plan packs (B6's plain version runs once a call);
    under the TPU layout names and on a 'tap' plan nothing is packed, as
    the JAX package forces "h" on its tap path. On the CPU the launch
    counters stay where they were."""
    calls = []
    real = fused3d._pack3d_reference
    monkeypatch.setattr(fused3d, "_pack3d_reference",
                        lambda *a: calls.append(a[1:]) or real(*a))
    x, kv, kt = (torch.from_numpy(a) for a in
                 _arrays(3, (1, 2, 30, 16, 12), (2, 2, 4, 3, 3), (2, 2, 11, 3, 3)))
    assert fused3d.plan_3d(2, 2, 30, 16, 12, 4, 3, 3)[0] == "v4"
    assert fused3d.plan_3d(2, 2, 30, 16, 12, 11, 3, 3)[0] == "tap"
    counters = fused3d.launches, fused3d.launches_tap, fused3d.launches_pack
    was = fused3d._XPACK3D
    assert was == "h2"  # the default, as in the JAX package
    try:
        for mode in ("h", "h2", "d2", "d0"):
            fused3d.set_fused3d_xpack(mode)
            ft.fft_conv(x, kv, impl="fused")
        assert calls == []
        fused3d.set_fused3d_xpack("pk")
        y_tap = ft.fft_conv(x, kt, impl="fused")
        assert calls == []
        y = ft.fft_conv(x, kv, impl="fused")
        assert calls == [(fused3d.plan_3d(2, 2, 30, 16, 12, 4, 3, 3)[3], 1, 10)]  # PP, nwb, hop
    finally:
        fused3d.set_fused3d_xpack(was)
    assert (fused3d.launches, fused3d.launches_tap, fused3d.launches_pack) == counters
    _assert_close_scaled(y.numpy(), ft.fft_conv(x, kv, impl="xla").numpy())
    _assert_close_scaled(y_tap.numpy(), ft.fft_conv(x, kt, impl="xla").numpy())


def test_unknown_mode_raises():
    was = fused3d._XPACK3D
    with pytest.raises(ValueError, match="unknown fused 3D x-pack mode"):
        fused3d.set_fused3d_xpack("h3")
    with pytest.raises(ValueError, match="unknown fused 3D x-pack mode"):
        jax_fused3d.set_fused3d_xpack("h3")
    assert fused3d._XPACK3D == was
    assert ft.kernels.set_fused3d_xpack is fused3d.set_fused3d_xpack


def test_pk_gradients_match_composed(pk):
    x, w = _arrays(17, (1, 4, 14, 12, 10), (4, 2, 3, 3, 3))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (fused3d.fft_conv3d_fused(xt, wt, groups=2) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv(xt, wt, groups=2, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_pack_wrapper_takes_only_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        fused3d._launch_pack3d(torch.zeros(1, 1, 4, 4, 4), 2, 1, 4)
