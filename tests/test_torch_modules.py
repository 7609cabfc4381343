"""The port's layers against the JAX package's, with one set of weights.

Parameters go from the JAX module to the port's through
``fft_conv_tpu_torch.utils.convert``; inputs are seeded numpy arrays. The
fused runs compare the port's plain version of the kernel with the JAX
package's Pallas kernel in interpret mode (``helpers._assert_close_scaled``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d
from fft_conv_tpu_torch.models.init import conv_fan_in
from fft_conv_tpu_torch.utils.convert import module_from_jax_state, params_from_jax

from helpers import _assert_almost_equal, _assert_close_scaled


def _state(jax_module):
    return {k: np.asarray(v) for k, v in jax_module.state_dict().items()}


def _pair(cls_name, *args, impl, **kw):
    """(JAX layer, port layer on the CPU) with the JAX layer's parameters."""
    jax_layer = getattr(fc.nn, cls_name)(*args, key=jax.random.key(3), impl=impl, **kw)
    torch_layer = getattr(ft.nn, cls_name)(*args, impl=impl, device="cpu", **kw)
    module_from_jax_state(torch_layer, _state(jax_layer))
    return jax_layer, torch_layer


def test_slice_forward_matches_jax():
    """The whole slice: FFTConv1d forward through the fused route on both
    sides, L=4096, K=256, C=4."""
    jax_layer, torch_layer = _pair("FFTConv1d", 4, 4, 256, padding=3, impl="fused")
    (x,) = [np.random.default_rng(0).standard_normal((2, 4, 4096)).astype(np.float32)]
    y_jax = jax_layer(jnp.asarray(x))
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_gradients_match_jax():
    jax_layer, torch_layer = _pair("FFTConv1d", 4, 6, 200, padding=4, groups=2, impl="fused")
    x = np.random.default_rng(1).standard_normal((2, 4, 3000)).astype(np.float32)

    def loss(layer, s):
        return (layer(s) ** 2).mean()

    g_layer, g_x = jax.grad(loss, argnums=(0, 1))(jax_layer, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss(torch_layer, xt).backward()
    _assert_close_scaled(torch_layer.weight.grad.numpy(), np.asarray(g_layer.weight))
    _assert_close_scaled(torch_layer.bias.grad.numpy(), np.asarray(g_layer.bias))
    _assert_close_scaled(xt.grad.numpy(), np.asarray(g_x))


def test_2d_slice_forward_matches_jax():
    """The 2D slice: FFTConv2d forward through the fused route on both sides
    (B2's plain version here, the Pallas kernel in interpret mode there)."""
    jax_layer, torch_layer = _pair("FFTConv2d", 3, 4, (16, 12), padding=(2, 1),
                                   padding_mode="reflect", impl="fused")
    x = np.random.default_rng(4).standard_normal((2, 3, 150, 140)).astype(np.float32)
    before = fused2d.launches
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    assert fused2d.launches == before
    _assert_close_scaled(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


def test_2d_gradients_match_jax():
    jax_layer, torch_layer = _pair("FFTConv2d", 4, 6, 9, padding=3, stride=2, groups=2,
                                   impl="fused")
    x = np.random.default_rng(5).standard_normal((2, 4, 130, 140)).astype(np.float32)

    def loss(layer, s):
        return (layer(s) ** 2).mean()

    g_layer, g_x = jax.grad(loss, argnums=(0, 1))(jax_layer, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss(torch_layer, xt).backward()
    _assert_close_scaled(torch_layer.weight.grad.numpy(), np.asarray(g_layer.weight))
    _assert_close_scaled(torch_layer.bias.grad.numpy(), np.asarray(g_layer.bias))
    _assert_close_scaled(xt.grad.numpy(), np.asarray(g_x))


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups",
                         [(1, 0, 0, 1, 1), (2, 1, 1, 2, 2), ((3, 2), (2, 1), (0, 1), 1, 1)])
def test_2d_transpose_layer_matches_jax(stride, padding, output_padding, dilation, groups):
    jax_layer, torch_layer = _pair(
        "FFTConvTranspose2d", 4, 6, (5, 3), stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation, groups=groups, impl="xla",
    )
    x = np.random.default_rng(6).standard_normal((2, 4, 13, 11)).astype(np.float32)
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    _assert_almost_equal(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


def test_3d_slice_forward_matches_jax():
    """The 3D slice: FFTConv3d forward through the fused route on both sides
    (B3's plain version here, the Pallas kernel in interpret mode there)."""
    jax_layer, torch_layer = _pair("FFTConv3d", 3, 4, (5, 3, 4), padding=(2, 1, 0),
                                   padding_mode="reflect", groups=1, impl="fused")
    x = np.random.default_rng(7).standard_normal((2, 3, 18, 16, 20)).astype(np.float32)
    before = fused3d.launches
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    assert fused3d.launches == before
    _assert_close_scaled(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


def test_3d_default_forward_matches_jax():
    """impl="auto" on a CPU signal: the composed path on both sides."""
    jax_layer, torch_layer = _pair("FFTConv3d", 4, 6, 3, stride=2, groups=2, impl="auto")
    x = np.random.default_rng(8).standard_normal((2, 4, 9, 10, 11)).astype(np.float32)
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    _assert_almost_equal(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups",
                         [(1, 0, 0, 1, 1), (2, 1, 1, 2, 2), ((3, 1, 2), (2, 0, 1), (0, 0, 1), 1, 1)])
def test_3d_transpose_layer_matches_jax(stride, padding, output_padding, dilation, groups):
    jax_layer, torch_layer = _pair(
        "FFTConvTranspose3d", 4, 6, (3, 2, 3), stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation, groups=groups, impl="xla",
    )
    x = np.random.default_rng(9).standard_normal((2, 4, 7, 6, 5)).astype(np.float32)
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    _assert_almost_equal(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


@pytest.mark.parametrize("kernel_size,stride,padding,output_padding,groups",
                         [((3, 2, 3), 2, 1, 1, 2), ((11, 3, 3), (1, 2, 1), (2, 0, 1), 0, 1)])
def test_3d_transpose_layer_fused_matches_jax(kernel_size, stride, padding, output_padding,
                                              groups):
    """FFTConvTranspose3d(impl="fused") on both sides: a v4 plan (B3's plain
    version here) and a tap plan (KD = 11, B4's)."""
    jax_layer, torch_layer = _pair(
        "FFTConvTranspose3d", 4, 6, kernel_size, stride=stride, padding=padding,
        output_padding=output_padding, groups=groups, impl="fused",
    )
    x = np.random.default_rng(10).standard_normal((2, 4, 7, 6, 5)).astype(np.float32)
    before = fused3d.launches, fused3d.launches_tap
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    assert (fused3d.launches, fused3d.launches_tap) == before
    _assert_close_scaled(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


@pytest.mark.parametrize("cls,kernel_size,stride,padding,output_padding,dilation,groups", [
    ("FFTConvTranspose1d", 9, 3, 2, 1, 2, 2),
    ("FFTConvTranspose1d", 40, 2, 0, 3, 1, 1),
    ("FFTConvTranspose2d", (5, 3), 2, 1, 1, 2, 2),
    ("FFTConvTranspose2d", (7, 4), (3, 1), (2, 0), (0, 1), 1, 1),
])
def test_1d_2d_transpose_layer_fused_matches_jax(cls, kernel_size, stride, padding,
                                                 output_padding, dilation, groups):
    """FFTConvTranspose1d/2d(impl="fused") on both sides: B1's and B2's plain
    versions on the stuffed signal here, the Pallas kernels in interpret mode
    there."""
    jax_layer, torch_layer = _pair(
        cls, 4, 6, kernel_size, stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation, groups=groups, impl="fused",
    )
    shape = (2, 4, 300) if cls.endswith("1d") else (2, 4, 23, 19)
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    before = fused1d.launches, fused2d.launches, fused2d.launches_v3
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    assert (fused1d.launches, fused2d.launches, fused2d.launches_v3) == before
    _assert_close_scaled(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


@pytest.mark.parametrize("cls", ["FFTConv3d", "FFTConvTranspose3d"])
def test_3d_state_dict_matches_jax(cls):
    jax_layer, torch_layer = _pair(cls, 4, 6, (3, 2, 5), groups=2, impl="xla")
    state = _state(jax_layer)
    assert set(torch_layer.state_dict()) == set(state) == {"weight", "bias"}
    for name, value in state.items():
        assert tuple(torch_layer.state_dict()[name].shape) == value.shape
        assert np.array_equal(torch_layer.state_dict()[name].numpy(), value)
    assert repr(torch_layer) == repr(jax_layer)


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups",
                         [(1, 0, 0, 1, 1), (2, 1, 1, 2, 2), (3, 2, 0, 1, 1)])
def test_transpose_layer_matches_jax(stride, padding, output_padding, dilation, groups):
    jax_layer, torch_layer = _pair(
        "FFTConvTranspose1d", 4, 6, 5, stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation, groups=groups, impl="xla",
    )
    x = np.random.default_rng(2).standard_normal((2, 4, 17)).astype(np.float32)
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    _assert_almost_equal(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


@pytest.mark.parametrize("padding_mode", ["zeros", "reflect", "replicate", "circular"])
def test_conv_layer_padding_modes_match_jax(padding_mode):
    jax_layer, torch_layer = _pair("FFTConv1d", 3, 2, 4, padding=2, stride=2,
                                   padding_mode=padding_mode, impl="xla")
    x = np.random.default_rng(3).standard_normal((2, 3, 21)).astype(np.float32)
    with torch.no_grad():
        y = torch_layer(torch.from_numpy(x))
    _assert_almost_equal(y.numpy(), np.asarray(jax_layer(jnp.asarray(x))))


def test_transpose_layer_runs_the_composed_path_by_default():
    """Every layer defaults to impl="auto", as the JAX layers do; on a CPU
    signal "auto" is the composed path, so a transposed layer's default
    forward there equals impl="xla" bit for bit and launches nothing."""
    for cls in ("FFTConv1d", "FFTConvTranspose1d", "FFTConv2d", "FFTConvTranspose2d",
                "FFTConv3d", "FFTConvTranspose3d"):
        assert getattr(ft.nn, cls)(2, 3, 4, device="cpu").impl == "auto"
        assert getattr(fc.nn, cls)(2, 3, 4).impl == "auto"
    layer = ft.FFTConvTranspose1d(2, 3, 4, stride=2, device="cpu")
    layer2 = ft.FFTConvTranspose2d(2, 3, 4, stride=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 2, 30)).astype(np.float32))
    before = fused1d.launches, fused2d.launches, fused2d.launches_v3
    with torch.no_grad():
        y = layer(x)
        y2 = layer2(x.reshape(2, 2, 5, 6))
        assert torch.equal(y, ft.fft_conv_transpose(x, layer.weight, layer.bias, stride=2,
                                                    impl="xla"))
        assert torch.equal(y2, ft.fft_conv_transpose(x.reshape(2, 2, 5, 6), layer2.weight,
                                                     layer2.bias, stride=2, impl="xla"))
    assert (fused1d.launches, fused2d.launches, fused2d.launches_v3) == before


@pytest.mark.parametrize("cls,shape,fan_in", [
    ("FFTConv1d", (6, 2, 5), 10),           # (Cout, Cin/g, K), groups=2
    ("FFTConvTranspose1d", (4, 3, 5), 15),  # (Cin, Cout/g, K), groups=2
    ("FFTConv2d", (6, 2, 5, 5), 50),
    ("FFTConvTranspose2d", (4, 3, 5, 5), 75),
    ("FFTConv3d", (6, 2, 5, 5, 5), 250),
    ("FFTConvTranspose3d", (4, 3, 5, 5, 5), 375),
])
def test_init_follows_torch(cls, shape, fan_in):
    layer = getattr(ft.nn, cls)(4, 6, 5, groups=2, device="cpu",
                                generator=torch.Generator().manual_seed(7))
    assert tuple(layer.weight.shape) == shape
    assert conv_fan_in(shape) == fan_in
    bound = 1 / fan_in ** 0.5
    assert layer.weight.abs().max() <= bound and layer.bias.abs().max() <= bound
    assert isinstance(layer.weight, torch.nn.Parameter)
    again = getattr(ft.nn, cls)(4, 6, 5, groups=2, device="cpu",
                                generator=torch.Generator().manual_seed(7))
    assert torch.equal(layer.weight, again.weight)
    other = getattr(ft.nn, cls)(4, 6, 5, groups=2, device="cpu",
                                generator=torch.Generator().manual_seed(8))
    assert not torch.equal(layer.weight, other.weight)


def test_init_statistics_match_torch_conv():
    layer = ft.FFTConv1d(16, 32, 9, device="cpu")
    ref = torch.nn.Conv1d(16, 32, 9)
    bound = 1 / (16 * 9) ** 0.5
    assert abs(layer.weight.std().item() - ref.weight.std().item()) < 0.1 * bound
    assert set(layer.state_dict()) == set(ref.state_dict()) == {"weight", "bias"}
    layer.load_state_dict(ref.state_dict())  # torch checkpoints load as they are


@pytest.mark.parametrize("cls,torch_cls", [("FFTConv2d", "Conv2d"),
                                           ("FFTConvTranspose2d", "ConvTranspose2d")])
def test_2d_init_and_state_dict_match_torch_conv(cls, torch_cls):
    layer = getattr(ft.nn, cls)(16, 32, (5, 3), device="cpu")
    ref = getattr(torch.nn, torch_cls)(16, 32, (5, 3))
    assert layer.weight.shape == ref.weight.shape
    bound = 1 / (ref.weight[0].numel()) ** 0.5
    assert layer.weight.abs().max() <= bound
    assert abs(layer.weight.std().item() - ref.weight.std().item()) < 0.1 * bound
    assert set(layer.state_dict()) == set(ref.state_dict()) == {"weight", "bias"}
    layer.load_state_dict(ref.state_dict())  # torch checkpoints load as they are
    assert torch.equal(layer.weight, ref.weight)


@pytest.mark.parametrize("cls,torch_cls", [("FFTConv3d", "Conv3d"),
                                           ("FFTConvTranspose3d", "ConvTranspose3d")])
def test_3d_init_and_state_dict_match_torch_conv(cls, torch_cls):
    layer = getattr(ft.nn, cls)(8, 12, (5, 3, 2), device="cpu")
    ref = getattr(torch.nn, torch_cls)(8, 12, (5, 3, 2))
    assert layer.weight.shape == ref.weight.shape
    bound = 1 / (ref.weight[0].numel()) ** 0.5
    assert layer.weight.abs().max() <= bound
    assert abs(layer.weight.std().item() - ref.weight.std().item()) < 0.1 * bound
    assert set(layer.state_dict()) == set(ref.state_dict()) == {"weight", "bias"}
    layer.load_state_dict(ref.state_dict())  # torch checkpoints load as they are
    assert torch.equal(layer.weight, ref.weight)


def test_layers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFTConv1d(2, 2, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFTConvTranspose1d(2, 2, 3, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFTConv2d(2, 2, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFTConvTranspose2d(2, 2, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFTConv3d(2, 2, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FFTConvTranspose3d(2, 2, 3)


@pytest.mark.parametrize("cls,args,kw,match", [
    ("FFTConv1d", (3, 4, 3), {"groups": 2}, "in_channels"),
    ("FFTConv1d", (4, 3, 3), {"groups": 2}, "out_channels"),
    ("FFTConv1d", (2, 2, 3), {"padding_mode": "bogus"}, "padding_mode"),
    ("FFTConvTranspose1d", (2, 2, 3), {"padding_mode": "reflect"}, "zeros"),
    ("FFTConv1d", (2, 2, 3), {"impl": "bogus"}, "impl"),
    ("FFTConv1d", (2, 2, (3, 3)), {}, "Cannot cast"),
])
def test_validation_matches_jax(cls, args, kw, match):
    with pytest.raises(ValueError, match=match):
        getattr(fc.nn, cls)(*args, **kw)
    with pytest.raises(ValueError, match=match):
        getattr(ft.nn, cls)(*args, device="cpu", **kw)


def test_input_rank_is_checked():
    layer = ft.FFTConv1d(2, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="3-d input"):
        layer(torch.zeros(2, 10))


def test_params_from_jax_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(np.ones((2, 3, 4)), np.zeros(2))


def test_repr_matches_jax():
    kw = dict(stride=2, padding=1, dilation=2, groups=2, bias=False, padding_mode="reflect")
    j = repr(fc.nn.FFTConv1d(4, 6, 3, **kw))
    t = repr(ft.nn.FFTConv1d(4, 6, 3, device="cpu", **kw))
    assert t == j


def test_convert_checks_names_and_shapes():
    w, b = params_from_jax(np.ones((2, 3, 4)), np.zeros(2), device="cpu")
    assert w.dtype == torch.float32 and tuple(w.shape) == (2, 3, 4) and b.shape == (2,)
    assert params_from_jax(np.ones((2, 3, 4)), None, device="cpu")[1] is None
    layer = ft.FFTConv1d(3, 2, 4, device="cpu")
    module_from_jax_state(layer, {"weight": np.ones((2, 3, 4)), "bias": np.zeros(2)})
    assert torch.equal(layer.weight.detach(), torch.ones(2, 3, 4))
    with pytest.raises(ValueError, match="names differ"):
        module_from_jax_state(layer, {"weight": np.ones((2, 3, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        module_from_jax_state(layer, {"weight": np.ones((2, 3, 5)), "bias": np.zeros(2)})

