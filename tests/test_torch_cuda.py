"""The port on a CUDA card: the fused 1D and 2D kernels against their plain
versions, and the routes that only a CUDA tensor takes.

Every test here is marked ``cuda`` and skips without a card. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import fft_conv_tpu_torch as ft
from fft_conv_tpu_torch.kernels import fused1d, fused2d

from helpers import _assert_close_scaled

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tensors(device, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
            for s in shapes]


@pytest.mark.parametrize("n,k,groups", [(2048, 256, 1), (4096, 1000, 2), (8192, 3840, 4)])
def test_kernel_matches_plain_version(cuda, n, k, groups):
    x, w = _tensors(cuda, n, (2, 8, 20000), (8, 8 // groups, k))
    before = fused1d.launches
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, n), n, groups, k)
    torch.cuda.synchronize()
    assert fused1d.launches == before + 1
    y_ref = fused1d._fused_forward_reference(x.cpu(), w.cpu(), n, groups)
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


def test_kernel_in_block_ranges(cuda, monkeypatch):
    x, w = _tensors(cuda, 1, (2, 4, 30000), (4, 4, 500))
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET",
                        2 * fused1d._scratch_bytes_per_block(2048, 2, 4))
    before = fused1d.launches
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, 2048), 2048, 1, 500)
    assert fused1d.launches - before > 1
    y_ref = fused1d._fused_forward_reference(x.cpu(), w.cpu(), 2048)
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


def test_auto_routes_1d_cuda_to_the_kernel(cuda):
    x, w, b = _tensors(cuda, 11, (2, 4, 5000), (6, 2, 300), (6,))
    kw = dict(padding=3, stride=2, dilation=2, groups=2, padding_mode="reflect")
    before = fused1d.launches
    y = ft.fft_conv(x, w, b, impl="auto", **kw)
    assert fused1d.launches > before
    y_ref = ft.fft_conv(x, w, b, impl="xla", **kw)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


def test_fused_gradients_on_cuda_match_composed(cuda):
    x, w = _tensors(cuda, 12, (2, 4, 6000), (4, 4, 700))
    x.requires_grad_()
    w.requires_grad_()
    (ft.fft_conv(x, w, impl="fused") ** 2).mean().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (ft.fft_conv(x, w, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.cpu().numpy(), x.grad.cpu().numpy())
    _assert_close_scaled(gw.cpu().numpy(), w.grad.cpu().numpy())


def test_auto_on_cuda_raises_for_unported_fused_routes(cuda):
    before = fused2d.launches
    y = ft.fft_conv(torch.zeros(1, 2, 8, 8, device=cuda), torch.zeros(2, 2, 3, 3, device=cuda))
    assert y.shape == (1, 2, 6, 6) and fused2d.launches == before + 1
    with pytest.raises(NotImplementedError, match="B3"):
        ft.fft_conv(torch.zeros(1, 2, 8, 8, 8, device=cuda),
                    torch.zeros(2, 2, 3, 3, 3, device=cuda))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.fft_conv_transpose(torch.zeros(1, 2, 20, device=cuda),
                              torch.zeros(2, 2, 3, device=cuda))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.fft_conv_transpose(torch.zeros(1, 2, 20, 20, device=cuda),
                              torch.zeros(2, 2, 3, 3, device=cuda))


# (B, Cin, Cout, H, W, K1, K2, groups): T2 = 128 with partial last tiles and
# nt2 > 2, T2 = 256 (K2 > 97), T1 = 256 (K1 > 65), and groups
FUSED2D = [
    (2, 8, 8, 300, 290, 16, 16, 1),
    (1, 3, 2, 129, 400, 7, 9, 1),
    (2, 4, 6, 200, 300, 12, 100, 2),
    (1, 2, 2, 300, 140, 70, 5, 1),
]


@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups", FUSED2D)
def test_2d_kernel_matches_plain_version(cuda, b, cin, cout, h, w, k1, k2, groups):
    x, k = _tensors(cuda, h + k2, (b, cin, h, w), (cout, cin // groups, k1, k2))
    k /= (cin // groups * k1 * k2) ** 0.5
    plan = fused2d.tile_plan_2d(k1, k2, cin // groups, cout)
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    before = fused2d.launches
    y = fused2d._launch_fused2d(x, spectra, plan, groups, (k1, k2))
    torch.cuda.synchronize()
    assert fused2d.launches == before + 1
    y_ref = fused2d._fused2d_forward_reference(x.cpu(), k.cpu(), groups)
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


@pytest.mark.parametrize("t1", [128, 256, 384])
@pytest.mark.parametrize("t2", [128, 256])
def test_2d_smem_formula_matches_kernel(cuda, t1, t2):
    """The tile plan's shared-memory gate is the kernel's own figure."""
    lib = fused2d._library()
    assert fused2d._smem_bytes(t1 // 2 + 1, t2) == lib.fused2d_smem_bytes(t1, t2)


def test_2d_kernel_in_tile_ranges(cuda, monkeypatch):
    x, k = _tensors(cuda, 2, (2, 4, 400, 300), (4, 4, 16, 16))
    plan = fused2d.tile_plan_2d(16, 16, 4, 4)
    monkeypatch.setattr(fused2d, "_SCRATCH_BUDGET",
                        2 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 4))
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    before = fused2d.launches
    y = fused2d._launch_fused2d(x, spectra, plan, 1, (16, 16))
    assert fused2d.launches - before > 1
    y_ref = fused2d._fused2d_forward_reference(x.cpu(), k.cpu())
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


def test_auto_routes_2d_cuda_to_the_kernel(cuda):
    x, w, b = _tensors(cuda, 14, (2, 4, 160, 150), (6, 2, 9, 7), (6,))
    kw = dict(padding=3, stride=(2, 3), dilation=2, groups=2, padding_mode="circular")
    before = fused2d.launches
    y = ft.fft_conv(x, w, b, impl="auto", **kw)
    assert fused2d.launches > before
    y_ref = ft.fft_conv(x, w, b, impl="xla", **kw)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


def test_fused2d_gradients_on_cuda_match_composed(cuda):
    x, w = _tensors(cuda, 15, (2, 4, 150, 170), (4, 2, 11, 13))
    x.requires_grad_()
    w.requires_grad_()
    (ft.fft_conv(x, w, padding=2, groups=2, impl="fused") ** 2).mean().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (ft.fft_conv(x, w, padding=2, groups=2, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.cpu().numpy(), x.grad.cpu().numpy())
    _assert_close_scaled(gw.cpu().numpy(), w.grad.cpu().numpy())


def test_2d_layer_on_cuda_launches_the_kernel(cuda):
    layer = ft.FFTConv2d(4, 4, 16, padding=1, generator=torch.Generator().manual_seed(0))
    assert layer.weight.is_cuda
    (x,) = _tensors(cuda, 16, (2, 4, 200, 180))
    before = fused2d.launches
    y = layer(x)
    assert fused2d.launches > before
    y_ref = ft.fft_conv(x, layer.weight, layer.bias, padding=1, impl="xla")
    _assert_close_scaled(y.detach().cpu().numpy(), y_ref.detach().cpu().numpy())
    transposed = ft.FFTConvTranspose2d(4, 4, 5)
    assert transposed.impl == "xla" and transposed(x).shape == (2, 4, 204, 184)


def test_layer_on_cuda_launches_the_kernel(cuda):
    layer = ft.FFTConv1d(4, 4, 256, generator=torch.Generator().manual_seed(0))
    assert layer.weight.is_cuda
    (x,) = _tensors(cuda, 13, (2, 4, 5000))
    before = fused1d.launches
    y = layer(x)
    assert fused1d.launches > before
    y_ref = ft.fft_conv(x, layer.weight, layer.bias, impl="xla")
    _assert_close_scaled(y.detach().cpu().numpy(), y_ref.detach().cpu().numpy())
    transposed = ft.FFTConvTranspose1d(4, 4, 16)
    assert transposed(x).shape == (2, 4, 5015)
