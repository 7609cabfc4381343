"""The port on a CUDA card: the fused 1D, 2D and 3D kernels (B1, B2, B5, B3,
B4, the x-pack kernel B6 and the spectra kernel B7) against their plain
versions, B1's and B2's tensor-core routes and B3's and B4's tensor-core
chains under each bf16 precision mode too, the serving
plans, and the routes that only a CUDA tensor takes. B1 is also held at the
edges of its blocking: V1 = 1, a single block, Cin = 3 with groups = 3 and
a stuffed transposed length. A stream of chunks launches B1 once per chunk,
and a checkpoint round trip on the card is exact. ``impl="tiled"`` runs its
DFT products in FP32 on the card, forward and backward, under a global TF32
setting too, and a tiled call replays in a CUDA graph.

Every test here is marked ``cuda`` and skips without a card. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import fft_conv_tpu_torch as ft
from fft_conv_tpu_torch.kernels import fused1d, fused2d, fused3d

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


# (B, Cin, Cout, L, K, N, groups): the three FFT sizes, then the edges of the
# blocking. Between them each phase runs at each N1 in both block sizes: 512
# threads where a phase's grid has no more blocks than the card has SMs (N =
# 4096 and 8192 at L = 20000, the single block, groups=3), else 256.
B1_CASES = [
    (2, 8, 8, 20000, 256, 2048, 1),
    (2, 8, 8, 20000, 1000, 4096, 2),
    (2, 8, 8, 20000, 3840, 8192, 4),
    (2, 8, 8, 20000, 2048 - 127, 2048, 1),   # V1 = 1 at N1 = 16
    (2, 8, 8, 20000, 8192 - 127, 8192, 1),   # V1 = 1 at N1 = 64
    (2, 8, 8, 1900, 256, 2048, 1),           # a single, partial block
    (2, 3, 6, 20000, 700, 4096, 3),          # Cin = 3, groups = 3
    (2, 8, 8, 33278, 256, 2048, 1),          # the stuffed signal of the K=256 transposed row
]


@pytest.mark.parametrize("b,cin,cout,l,k,n,groups", B1_CASES)
def test_kernel_matches_plain_version(cuda, b, cin, cout, l, k, n, groups):
    x, w = _tensors(cuda, n, (b, cin, l), (cout, cin // groups, k))
    before = fused1d.launches
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, n), n, groups, k)
    torch.cuda.synchronize()
    assert fused1d.launches == before + 1
    y_ref = fused1d._fused_forward_reference(x.cpu(), w.cpu(), n, groups)
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


@pytest.fixture
def precision():
    """Restores B1's default precision mode after the test."""
    yield fused1d.set_fused_precision
    fused1d.set_fused_precision("highest")


def _assert_bf16_kernel_close(y, y_ref):
    """The bar of the "bf16" tensor-core pair against its plain version:
    err_mean < 5e-4·σ and err_max < 2.5e-2·σ, σ = max(1, std(ref)). The two
    round the same operands to bf16, but their FP32 sums (tensor-core
    accumulation, FMAs) can differ in the last bit, which now and then flips
    an operand's rounding and moves that element by one bf16 step (2^-7 of
    it). On the CPU, rounding the plain version's sums from float64 instead
    moves it by up to err_mean 4.8e-5·σ and err_max 4.1e-3·σ over
    ``B1_CASES``; on an H100 the kernel was at most 2.0e-4·σ and 8.9e-3·σ
    from it, at the K=3840 row (N = 8192). The mean bar is a tenth of the JAX
    package's serving bar against the exact result, and the "bf16" mode's
    own error takes 3.6e-3·σ of that, so a kernel running another mode's
    arithmetic, or misplacing a product, fails it; the max bar is half the
    serving bar."""
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape
    sigma = max(1.0, float(y_ref.std()))
    err = np.abs(y - y_ref)
    assert err.mean() < 5e-4 * sigma and err.max() < 2.5e-2 * sigma, (
        f"mean {err.mean():.3e} max {err.max():.3e} sigma {sigma:.1f}")


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("b,cin,cout,l,k,n,groups", B1_CASES + [
    (2, 8, 8, 32768, 256, 2048, 1),    # the 1D benchmark rows
    (2, 8, 8, 32768, 1024, 4096, 1),
    (2, 8, 8, 32768, 3840, 8192, 1),
    (2, 8, 24, 20000, 1000, 4096, 2),  # Cout/g = 12: output-channel blocks of 8 and 4
    (3, 6, 10, 9000, 300, 2048, 1),    # Cout = 10 != Cin, blocks of 8 and 2, 3 batch rows
])
def test_tc_kernel_matches_plain_version(cuda, mode, b, cin, cout, l, k, n, groups):
    """B1's tensor-core route against its plain version of the same mode:
    "bf16x3" under the FP32 bar, "bf16" under ``_assert_bf16_kernel_close``."""
    x, w = _tensors(cuda, n, (b, cin, l), (cout, cin // groups, k))
    before = fused1d.launches, fused1d.launches_tc
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, n), n, groups, k, mode)
    torch.cuda.synchronize()
    assert (fused1d.launches, fused1d.launches_tc) == (before[0], before[1] + 1)
    y_ref = fused1d._fused_forward_reference(x.cpu(), w.cpu(), n, groups, mode=mode)
    check = _assert_close_scaled if mode == "bf16x3" else _assert_bf16_kernel_close
    check(y.cpu().numpy(), y_ref.numpy())


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_kernel_in_block_ranges(cuda, monkeypatch, mode):
    x, w = _tensors(cuda, 1, (2, 4, 30000), (4, 4, 500))
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET",
                        2 * fused1d._scratch_bytes_per_block(2048, 2, 4))
    before = fused1d.launches_tc
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, 2048), 2048, 1, 500,
                                mode)
    assert fused1d.launches_tc - before > 1
    y_ref = fused1d._fused_forward_reference(x.cpu(), w.cpu(), 2048, mode=mode)
    check = _assert_close_scaled if mode == "bf16x3" else _assert_bf16_kernel_close
    check(y.cpu().numpy(), y_ref.numpy())


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_kernel_block_ranges_count_y(cuda, monkeypatch, mode):
    """Under a scratch budget of three blocks of D and Y together (D alone
    would fit six), each launch takes three blocks: 12 blocks in 4 launches,
    the last MAC grid smaller than the first."""
    x, w = _tensors(cuda, 4, (2, 4, 18931), (4, 4, 500))
    n = 2048
    assert fused1d._blocking(n, 500, 18931)[2] == 12
    per = fused1d._scratch_bytes_per_block(n, 2, 8)
    monkeypatch.setattr(fused1d, "_SCRATCH_BUDGET", 3 * per)
    assert fused1d._tc_geometry(2, 4, 4, 1, n, 12, 132)[0] == 3
    before = fused1d.launches_tc
    y = fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, n), n, 1, 500, mode)
    torch.cuda.synchronize()
    assert fused1d.launches_tc - before == 4
    y_ref = fused1d._fused_forward_reference(x.cpu(), w.cpu(), n, mode=mode)
    check = _assert_close_scaled if mode == "bf16x3" else _assert_bf16_kernel_close
    check(y.cpu().numpy(), y_ref.numpy())


def test_tc_plane_rows_match_kernel(cuda):
    """The host's bound on a MAC block's rows (units x output channels,
    which ``_tc_geometry`` keeps under) is the kernel's own figure."""
    assert fused1d._TC_PLANE_ROWS == fused1d._library().fused1d_tc_plane_rows()


def test_tc_kernel_refuses_what_it_does_not_run(cuda):
    """An FFT size outside 2048, 4096, 8192 (N1 = 8 here), an unknown mode
    and float64 spectra raise; nothing is launched."""
    x, w = _tensors(cuda, 3, (1, 2, 3000), (2, 2, 100))
    before = fused1d.launches, fused1d.launches_tc
    with pytest.raises(ValueError, match="FFT size 1024"):
        fused1d._launch_fused1d(x, fused1d.kernel_spectra_one_sided(w, 1024), 1024, 1, 100,
                                "bf16")
    spectra = fused1d.kernel_spectra_one_sided(w, 2048)
    with pytest.raises(ValueError, match="precision mode"):
        fused1d._launch_fused1d(x, spectra, 2048, 1, 100, "fp8")
    with pytest.raises(ValueError, match="complex64"):
        fused1d._launch_fused1d(x, spectra.to(torch.complex128), 2048, 1, 100, "bf16x3")
    assert (fused1d.launches, fused1d.launches_tc) == before


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_modes_route_every_1d_path_on_cuda(cuda, precision, mode):
    """Under a bf16 mode a CUDA tensor's 1D calls (``fft_conv`` under "auto",
    a plan, the transposed route, ``FFTConv1d``, a stream step) launch the
    tensor-core route and not the FP32 pair, each within the mode's bar of the
    composed path; back under "highest" they launch the FP32 pair."""
    x, w, b = _tensors(cuda, 28, (2, 4, 9000), (4, 4, 300), (4,))
    layer = ft.FFTConv1d(4, 4, 256, generator=torch.Generator().manual_seed(0))
    plan = ft.ops.plan_fft_conv(w, b, signal_spatial=(9000,))
    state = ft.ops.streaming_conv1d_init(2, 4, 300)
    calls = [
        (lambda: ft.fft_conv(x, w, b), lambda: ft.fft_conv(x, w, b, impl="xla")),
        (lambda: plan(x), lambda: ft.fft_conv(x, w, b, impl="xla")),
        (lambda: ft.fft_conv_transpose(x, w, b, padding=2),
         lambda: ft.fft_conv_transpose(x, w, b, padding=2, impl="xla")),
        (lambda: layer(x), lambda: ft.fft_conv(x, layer.weight, layer.bias, impl="xla")),
        (lambda: ft.ops.streaming_conv1d_step(state, x, w, b)[0],
         lambda: ft.fft_conv(torch.nn.functional.pad(x, (299, 0)), w, b, impl="xla")),
    ]
    check = _assert_close_scaled if mode == "bf16x3" else _assert_bf16_kernel_close
    precision(mode)
    for fn, ref in calls:
        before = fused1d.launches, fused1d.launches_tc
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        assert fused1d.launches == before[0] and fused1d.launches_tc == before[1] + 1
        y_ref = ref().detach().cpu().numpy()
        if mode == "bf16x3":
            check(y.cpu().numpy(), y_ref)
        else:  # against the exact result, the JAX package's serving bar
            sigma = max(1.0, float(y_ref.std()))
            err = np.abs(y.cpu().numpy() - y_ref)
            assert err.mean() < 5e-3 * sigma and err.max() < 5e-2 * sigma
    precision("highest")
    before = fused1d.launches, fused1d.launches_tc
    plan(x)
    assert (fused1d.launches, fused1d.launches_tc) == (before[0] + 1, before[1])


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
    """Every fused route under ``auto`` on a CUDA signal launches its kernel,
    the 1D and 2D transposed routes included; nothing raises."""
    before = fused2d.launches
    y = ft.fft_conv(torch.zeros(1, 2, 8, 8, device=cuda), torch.zeros(2, 2, 3, 3, device=cuda))
    assert y.shape == (1, 2, 6, 6) and fused2d.launches == before + 1
    before = fused3d.launches
    y = ft.fft_conv(torch.zeros(1, 2, 8, 8, 8, device=cuda),
                    torch.zeros(2, 2, 3, 3, 3, device=cuda))
    assert y.shape == (1, 2, 6, 6, 6) and fused3d.launches == before + 1
    # KD = 11 plans 'tap': auto launches B4
    before = fused3d.launches, fused3d.launches_tap
    y = ft.fft_conv(torch.ones(1, 2, 30, 16, 12, device=cuda),
                    torch.ones(2, 2, 11, 3, 3, device=cuda))
    assert (fused3d.launches, fused3d.launches_tap) == (before[0], before[1] + 1)
    assert y.shape == (1, 2, 20, 14, 10)
    assert torch.allclose(y, torch.full_like(y, 2 * 11 * 3 * 3), rtol=1e-5)
    # the transposed routes: B1 in 1D, B2 in 2D
    before = fused1d.launches
    y = ft.fft_conv_transpose(torch.ones(1, 2, 20, device=cuda), torch.ones(2, 2, 3, device=cuda))
    assert y.shape == (1, 2, 22) and fused1d.launches == before + 1
    assert torch.allclose(y[:, :, 2:-2], torch.full_like(y[:, :, 2:-2], 2 * 3), rtol=1e-5)
    before = fused2d.launches
    y = ft.fft_conv_transpose(torch.ones(1, 2, 20, 20, device=cuda),
                              torch.ones(2, 2, 3, 3, device=cuda))
    assert y.shape == (1, 2, 22, 22) and fused2d.launches == before + 1
    assert torch.allclose(y[:, :, 2:-2, 2:-2], torch.full_like(y[:, :, 2:-2, 2:-2], 2 * 9),
                          rtol=1e-5)


@pytest.mark.parametrize("k,st,pad,op,dil,groups", [
    (5, 1, 0, 0, 1, 1), (7, 2, 1, 1, 2, 2), (4, 3, 2, 3, 1, 1),
])
def test_1d_2d_transpose_fused_on_cuda(cuda, k, st, pad, op, dil, groups):
    """fft_conv_transpose(impl="auto") on a CUDA signal launches B1 in 1D and
    B2 in 2D, and agrees with the composed path; so do the layers' default."""
    for n, (kern_mod, shape) in enumerate([(fused1d, (2, 4, 3000)), (fused2d, (2, 4, 60, 50))]):
        nd = n + 1
        x, w, b = _tensors(cuda, 30 + k + nd, shape, (4, 6 // groups) + (k,) * nd, (6,))
        kw = dict(stride=st, padding=pad, output_padding=op, dilation=dil, groups=groups)
        before = kern_mod.launches
        y = ft.fft_conv_transpose(x, w, b, **kw)
        assert kern_mod.launches == before + 1
        y_ref = ft.fft_conv_transpose(x, w, b, impl="xla", **kw)
        _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())
        layer = (ft.FFTConvTranspose1d, ft.FFTConvTranspose2d)[n](4, 6, k, **kw)
        assert layer.impl == "auto"
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.copy_(b)
            y = layer(x)
        assert kern_mod.launches == before + 2
        _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


# (B, Cin, Cout, H, W, K1, K2, groups): T2 = 128 with partial last tiles and
# nt2 > 2, T2 = 256 (K2 > 97), T1 = 256 (K1 > 65), T1 = 384 (K1 > 129), and
# groups: every plan tile_plan_2d admits
FUSED2D = [
    (2, 8, 8, 300, 290, 16, 16, 1),
    (1, 3, 2, 129, 400, 7, 9, 1),
    (2, 4, 6, 200, 300, 12, 100, 2),
    (1, 2, 2, 300, 140, 70, 5, 1),
    (1, 2, 2, 400, 150, 200, 9, 1),
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


def _assert_bf16_2d_kernel_close(y, y_ref, y_exact):
    """The bar of B2's "bf16" tensor-core route against its plain version
    ``y_ref``, with ``y_exact`` the result in float64: err_max < 2.5e-2·σ and
    err_mean < 2e-3·σ (σ = max(1, std(ref))), and the kernel's err_mean
    against ``y_exact`` within 1% of the plain version's. The two round the
    same operands to bf16 after FP32 sums of another order, and where one
    operand of a tile's first steps rounds the other way, the change moves
    later operands by a fraction of a bf16 step and flips some of their
    roundings too, through the eight rounding steps of a tile: whole tiles
    then differ. On an H100 (``survey_fused2d_bf16.py``, 32 calls) one call
    was 1.2e-3·σ from its plain version (past ``_assert_bf16_kernel_close``'s
    5e-4·σ, set for B1's fewer steps), while the two errors against float64
    stayed within 0.11% of each other. So the mean bar is 2e-3·σ, under the
    3.8e-3 to 4.4e-3·σ that a kernel running "bf16x3" arithmetic would be
    from the plain version, and the ratio tells the modes apart and catches
    a rounding added or left out, which moves the error by about 6% (one
    step in eight)."""
    y, y_ref, y_exact = (np.asarray(a, np.float64) for a in (y, y_ref, y_exact))
    assert y.shape == y_ref.shape == y_exact.shape
    sigma = max(1.0, float(y_ref.std()))
    err = np.abs(y - y_ref)
    assert err.mean() < 2e-3 * sigma and err.max() < 2.5e-2 * sigma, (
        f"mean {err.mean():.3e} max {err.max():.3e} sigma {sigma:.1f}")
    ours, plain = np.abs(y - y_exact).mean(), np.abs(y_ref - y_exact).mean()
    assert abs(ours / plain - 1) < 1e-2, f"err_mean vs float64 {ours:.4e}, plain {plain:.4e}"


def _assert_tc_2d_close(mode, y, x, k, groups=1, v3=False):
    """B2's (``v3``: B5's) tensor-core route's output ``y`` against its plain
    version of ``mode`` on the CPU: "bf16x3" under the FP32 bar, "bf16" under
    ``_assert_bf16_2d_kernel_close``."""
    plain = fused2d._fused2d_forward_reference_v3 if v3 else fused2d._fused2d_forward_reference
    y_ref = plain(x.cpu(), k.cpu(), groups, mode=mode).numpy()
    if mode == "bf16x3":
        _assert_close_scaled(y.cpu().numpy(), y_ref)
    else:
        exact = plain(x.cpu().double(), k.cpu().double(), groups)
        _assert_bf16_2d_kernel_close(y.cpu().numpy(), y_ref, exact.numpy())


def _counts_2d():
    """fused2d's launch counters: B2's FP32 pair, B2's tensor-core route,
    B5's FP32 pair, B5's tensor-core route."""
    return [fused2d.launches, fused2d.launches_tc, fused2d.launches_v3, fused2d.launches_v3_tc]


@pytest.fixture
def precision2d():
    """Restores B2's default precision mode and the "v2" schedule after the
    test."""
    yield fused2d.set_fused2d_precision
    fused2d.set_fused2d_precision("highest")
    fused2d.set_fused2d_kernel("v2")


# every tile plan (FUSED2D), the 2D benchmark rows and the MAC stage's
# geometry (fused2d._tc_geometry): 2 output channels a group, one channel a
# group, B = 3 (75 units: the last MAC block holds 3 of 8), 24 -> 24 channels
# in 3 groups, 15 channels (4 channel chunks, 2 output-channel passes), 100
# output channels (2 blocks of them)
TC_2D = FUSED2D + [
    (2, 8, 8, 512, 512, 16, 16, 1),
    (2, 8, 8, 512, 512, 34, 34, 1),
    (2, 6, 6, 300, 290, 16, 16, 3),
    (2, 4, 4, 300, 290, 16, 16, 4),
    (3, 8, 8, 512, 512, 16, 16, 1),
    (2, 24, 24, 200, 210, 9, 9, 3),
    (1, 15, 15, 200, 210, 9, 9, 1),
    (1, 1, 100, 300, 290, 16, 16, 1),
]


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups", TC_2D)
def test_tc_2d_kernel_matches_plain_version(cuda, mode, b, cin, cout, h, w, k1, k2, groups):
    """B2's tensor-core route against its plain version of the same mode at
    every tile shape (128 x 128, 256 x 128, 384 x 128, 128 x 256), the
    benchmark rows and the MAC stage's cases: "bf16x3" under the FP32 bar,
    "bf16" under ``_assert_bf16_2d_kernel_close``."""
    x, k = _tensors(cuda, h + k2, (b, cin, h, w), (cout, cin // groups, k1, k2))
    k /= (cin // groups * k1 * k2) ** 0.5
    plan = fused2d.tile_plan_2d(k1, k2, cin // groups, cout)
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    before = fused2d.launches, fused2d.launches_tc
    y = fused2d._launch_fused2d(x, spectra, plan, groups, (k1, k2), mode)
    torch.cuda.synchronize()
    assert (fused2d.launches, fused2d.launches_tc) == (before[0], before[1] + 1)
    _assert_tc_2d_close(mode, y, x, k, groups)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_2d_kernel_in_tile_ranges(cuda, monkeypatch, mode):
    """A budget of two tiles of D is one tile of D and Y: the 12 tiles run
    in 12 launches, and a budget under one tile still runs, a tile a
    launch."""
    x, k = _tensors(cuda, 2, (2, 4, 400, 300), (4, 4, 16, 16))
    plan = fused2d.tile_plan_2d(16, 16, 4, 4)
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    for budget in (2 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 4), 1):
        monkeypatch.setattr(fused2d, "_SCRATCH_BUDGET", budget)
        before = fused2d.launches_tc
        y = fused2d._launch_fused2d(x, spectra, plan, 1, (16, 16), mode)
        assert fused2d.launches_tc - before == 12
        _assert_tc_2d_close(mode, y, x, k)


def test_tc_2d_plane_bytes_match_kernel(cuda):
    """The host's MAC-stage plane (``_TC_PLANE_BYTES``, which
    ``_tc_geometry`` fills) is the kernel's own figure."""
    assert fused2d._TC_PLANE_BYTES == fused2d._library().fused2d_tc_plane_bytes()


def test_tc_2d_kernel_refuses_what_it_does_not_run(cuda, precision2d):
    """An unknown mode and complex128 spectra raise, and so does B5's
    tensor-core launcher under "highest" (B5's FP32 pair takes planes);
    nothing is launched."""
    x, w = _tensors(cuda, 3, (1, 2, 150, 140), (2, 2, 9, 9))
    plan = fused2d.tile_plan_2d(9, 9, 2, 2)
    spectra = fused2d.kernel_spectra_2d(w, plan[0], plan[2], plan[3])
    before = _counts_2d()
    with pytest.raises(ValueError, match="precision mode"):
        fused2d._launch_fused2d(x, spectra, plan, 1, (9, 9), "fp8")
    with pytest.raises(ValueError, match="complex64"):
        fused2d._launch_fused2d(x, spectra.to(torch.complex128), plan, 1, (9, 9), "bf16")
    with pytest.raises(ValueError, match="complex64"):
        fused2d._launch_fused2d_v3(x, spectra.to(torch.complex128), plan, 1, (9, 9), "bf16")
    with pytest.raises(ValueError, match="planes"):
        fused2d._launch_fused2d(x, spectra, plan, 1, (9, 9), "highest", v3=True)
    assert _counts_2d() == before


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_modes_route_every_2d_path_on_cuda(cuda, precision2d, mode):
    """Under a bf16 mode a CUDA tensor's 2D calls (``fft_conv`` under "auto",
    a plan, the transposed route, ``FFTConv2d``) launch B2's tensor-core route
    and neither its FP32 pair nor B5, each within the mode's bar of the
    composed path; back under "highest" they launch the FP32 pair."""
    x, w, b = _tensors(cuda, 29, (2, 4, 200, 180), (4, 4, 9, 7), (4,))
    layer = ft.FFTConv2d(4, 4, 11, padding=2, generator=torch.Generator().manual_seed(0))
    plan = ft.ops.plan_fft_conv(w, b, signal_spatial=(200, 180))
    calls = [
        (lambda: ft.fft_conv(x, w, b), lambda: ft.fft_conv(x, w, b, impl="xla")),
        (lambda: plan(x), lambda: ft.fft_conv(x, w, b, impl="xla")),
        (lambda: ft.fft_conv_transpose(x, w, b, padding=2),
         lambda: ft.fft_conv_transpose(x, w, b, padding=2, impl="xla")),
        (lambda: layer(x),
         lambda: ft.fft_conv(x, layer.weight, layer.bias, padding=2, impl="xla")),
    ]
    precision2d(mode)
    for fn, ref in calls:
        before = fused2d.launches, fused2d.launches_tc, fused2d.launches_v3
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        assert (fused2d.launches, fused2d.launches_tc, fused2d.launches_v3) == (
            before[0], before[1] + 1, before[2])
        y_ref = ref().detach().cpu().numpy()
        if mode == "bf16x3":
            _assert_close_scaled(y.cpu().numpy(), y_ref)
        else:  # against the exact result, the JAX package's serving bar
            sigma = max(1.0, float(y_ref.std()))
            err = np.abs(y.cpu().numpy() - y_ref)
            assert err.mean() < 5e-3 * sigma and err.max() < 5e-2 * sigma
    precision2d("highest")
    before = fused2d.launches, fused2d.launches_tc
    plan(x)
    assert (fused2d.launches, fused2d.launches_tc) == (before[0] + 1, before[1])


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups", TC_2D)
def test_tc_2d_v3_kernel_matches_plain_version(cuda, mode, b, cin, cout, h, w, k1, k2, groups):
    """B5's tensor-core route against its plain version of the same mode at
    B2's route's cases (every tile plan, T1 = 384 and T2 = 256 among them,
    groups, the MAC stage's geometry), the kernels random and so not
    symmetric: D written in another bin order than the spectra's would show.
    Neither FP32 pair nor B2's route runs."""
    x, k = _tensors(cuda, h + k2 + 2, (b, cin, h, w), (cout, cin // groups, k1, k2))
    k /= (cin // groups * k1 * k2) ** 0.5
    plan = fused2d.tile_plan_2d(k1, k2, cin // groups, cout)
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    before = _counts_2d()
    y = fused2d._launch_fused2d_v3(x, spectra, plan, groups, (k1, k2), mode)
    torch.cuda.synchronize()
    assert _counts_2d() == before[:3] + [before[3] + 1]
    _assert_tc_2d_close(mode, y, x, k, groups, v3=True)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_2d_v3_kernel_in_tile_ranges(cuda, monkeypatch, mode):
    """B5's route in tile ranges: a budget of one tile of D and Y runs the
    12 tiles in 12 launches, and so does a budget under one tile."""
    x, k = _tensors(cuda, 6, (2, 4, 400, 300), (4, 4, 16, 16))
    plan = fused2d.tile_plan_2d(16, 16, 4, 4)
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    for budget in (2 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 4), 1):
        monkeypatch.setattr(fused2d, "_SCRATCH_BUDGET", budget)
        before = fused2d.launches_v3_tc
        y = fused2d._launch_fused2d_v3(x, spectra, plan, 1, (16, 16), mode)
        assert fused2d.launches_v3_tc - before == 12
        _assert_tc_2d_close(mode, y, x, k, v3=True)


# B5's route at each tile shape with an odd V1 (tile_plan_2d's V1 is a
# multiple of 8): (B, Cin, Cout, H, W, K1, K2)
TC_2D_V3_ODD = [
    (2, 8, 8, 300, 290, 16, 16),   # T1 = 128, V1 = 111
    (2, 8, 8, 300, 280, 70, 5),    # T1 = 256, V1 = 183
    (1, 4, 4, 420, 150, 200, 9),   # T1 = 384, V1 = 183
    (2, 8, 8, 200, 400, 12, 100),  # T2 = 256, V1 = 111
]


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2", TC_2D_V3_ODD)
def test_tc_2d_v3_kernel_at_an_odd_v1(cuda, monkeypatch, mode, b, cin, cout, h, w, k1, k2):
    """B5's tensor-core route against its plain version with the tile
    plan's V1 one less, odd, on both sides (the plain version reads the
    plan through ``tile_plan_2d``), so that the W c2r's last row pair holds
    one valid row and its second row is zeros: "bf16x3" under the FP32
    bar, "bf16" under ``_assert_bf16_2d_kernel_close``."""
    plan_of = fused2d.tile_plan_2d

    def odd(*args):
        t1, v1, nb1, t2, v2 = plan_of(*args)
        return t1, v1 - 1, nb1, t2, v2

    monkeypatch.setattr(fused2d, "tile_plan_2d", odd)
    x, k = _tensors(cuda, h + k1, (b, cin, h, w), (cout, cin, k1, k2))
    k /= (cin * k1 * k2) ** 0.5
    plan = fused2d.tile_plan_2d(k1, k2, cin, cout)
    assert plan[1] % 2 == 1
    spectra = fused2d.kernel_spectra_2d(k, plan[0], plan[2], plan[3])
    before = _counts_2d()
    y = fused2d._launch_fused2d_v3(x, spectra, plan, 1, (k1, k2), mode)
    torch.cuda.synchronize()
    assert _counts_2d() == before[:3] + [before[3] + 1]
    _assert_tc_2d_close(mode, y, x, k, v3=True)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_modes_route_every_2d_path_on_cuda_under_v3(cuda, precision2d, mode):
    """Under "v3" and a bf16 mode a CUDA tensor's 2D calls (``fft_conv``
    under "auto", a plan, the transposed route, ``FFTConv2d``) launch B5's
    tensor-core route once each and neither FP32 pair nor B2's route, each
    within the mode's bar of the composed path; back under "highest" they
    launch B5's FP32 pair."""
    x, w, b = _tensors(cuda, 30, (2, 4, 200, 180), (4, 4, 9, 7), (4,))
    layer = ft.FFTConv2d(4, 4, 11, padding=2, generator=torch.Generator().manual_seed(1))
    plan = ft.ops.plan_fft_conv(w, b, signal_spatial=(200, 180))
    calls = [
        (lambda: ft.fft_conv(x, w, b), lambda: ft.fft_conv(x, w, b, impl="xla")),
        (lambda: plan(x), lambda: ft.fft_conv(x, w, b, impl="xla")),
        (lambda: ft.fft_conv_transpose(x, w, b, padding=2),
         lambda: ft.fft_conv_transpose(x, w, b, padding=2, impl="xla")),
        (lambda: layer(x),
         lambda: ft.fft_conv(x, layer.weight, layer.bias, padding=2, impl="xla")),
    ]
    fused2d.set_fused2d_kernel("v3")
    precision2d(mode)
    for fn, ref in calls:
        before = _counts_2d()
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        assert _counts_2d() == before[:3] + [before[3] + 1]
        y_ref = ref().detach().cpu().numpy()
        if mode == "bf16x3":
            _assert_close_scaled(y.cpu().numpy(), y_ref)
        else:  # against the exact result, the JAX package's serving bar
            sigma = max(1.0, float(y_ref.std()))
            err = np.abs(y.cpu().numpy() - y_ref)
            assert err.mean() < 5e-3 * sigma and err.max() < 5e-2 * sigma
    precision2d("highest")
    before = _counts_2d()
    plan(x)
    assert _counts_2d() == [before[0], before[1], before[2] + 1, before[3]]


@pytest.fixture
def v3():
    """Kernel B5 for the test's duration."""
    was = fused2d._KERNEL2D_VERSION
    fused2d.set_fused2d_kernel("v3")
    yield
    fused2d.set_fused2d_kernel(was)


@pytest.mark.parametrize("b,cin,cout,h,w,k1,k2,groups", FUSED2D)
def test_2d_v3_kernel_matches_plain_version(cuda, b, cin, cout, h, w, k1, k2, groups):
    x, k = _tensors(cuda, h + k2 + 1, (b, cin, h, w), (cout, cin // groups, k1, k2))
    k /= (cin // groups * k1 * k2) ** 0.5
    plan = fused2d.tile_plan_2d(k1, k2, cin // groups, cout)
    spectra = fused2d.kernel_spectra_2d_planes(k, plan[0], plan[2], plan[3])
    before = fused2d.launches, fused2d.launches_v3
    y = fused2d._launch_fused2d_v3(x, spectra, plan, groups, (k1, k2))
    torch.cuda.synchronize()
    assert (fused2d.launches, fused2d.launches_v3) == (before[0], before[1] + 1)
    y_ref = fused2d._fused2d_forward_reference_v3(x.cpu(), k.cpu(), groups)
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


@pytest.mark.parametrize("t1", [128, 256, 384])
@pytest.mark.parametrize("t2", [128, 256])
def test_2d_v3_smem_formula_matches_kernel(cuda, t1, t2):
    """B5's shared-memory figure in the host is the kernel's own."""
    lib = fused2d._library()
    assert fused2d._smem_bytes_v3(t1 // 2 + 1, t2) == lib.fused2d_v3_smem_bytes(t1, t2)


def test_2d_v3_kernel_in_tile_ranges(cuda, monkeypatch):
    x, k = _tensors(cuda, 5, (2, 4, 400, 300), (4, 4, 16, 16))
    plan = fused2d.tile_plan_2d(16, 16, 4, 4)
    monkeypatch.setattr(fused2d, "_SCRATCH_BUDGET",
                        2 * fused2d._scratch_bytes_per_tile(plan[2], plan[3], 2, 4))
    spectra = fused2d.kernel_spectra_2d_planes(k, plan[0], plan[2], plan[3])
    before = fused2d.launches_v3
    y = fused2d._launch_fused2d_v3(x, spectra, plan, 1, (16, 16))
    assert fused2d.launches_v3 - before > 1
    y_ref = fused2d._fused2d_forward_reference_v3(x.cpu(), k.cpu())
    _assert_close_scaled(y.cpu().numpy(), y_ref.numpy())


def test_auto_under_v3_routes_2d_cuda_to_b5(cuda, v3):
    x, w, b = _tensors(cuda, 24, (2, 4, 160, 150), (6, 2, 9, 7), (6,))
    kw = dict(padding=3, stride=(2, 3), dilation=2, groups=2, padding_mode="circular")
    before = fused2d.launches, fused2d.launches_v3
    y = ft.fft_conv(x, w, b, impl="auto", **kw)
    assert (fused2d.launches, fused2d.launches_v3) == (before[0], before[1] + 1)
    _assert_close_scaled(y.cpu().numpy(), ft.fft_conv(x, w, b, impl="xla", **kw).cpu().numpy())
    # the transposed route and a layer's forward and backward
    wt = _tensors(cuda, 25, (4, 3, 5, 6))[0]
    y = ft.fft_conv_transpose(x, wt, stride=2, padding=1)
    assert (fused2d.launches, fused2d.launches_v3) == (before[0], before[1] + 2)
    _assert_close_scaled(y.cpu().numpy(), ft.fft_conv_transpose(
        x, wt, stride=2, padding=1, impl="xla").cpu().numpy())
    layer = ft.FFTConv2d(4, 4, 11, padding=2, generator=torch.Generator().manual_seed(2))
    xg = x.clone().requires_grad_()
    (layer(xg) ** 2).mean().backward()
    assert (fused2d.launches, fused2d.launches_v3) == (before[0], before[1] + 3)
    gx, gw = xg.grad.clone(), layer.weight.grad.clone()
    xg.grad = layer.weight.grad = None
    (ft.fft_conv(xg, layer.weight, layer.bias, padding=2, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.cpu().numpy(), xg.grad.cpu().numpy())
    _assert_close_scaled(gw.cpu().numpy(), layer.weight.grad.cpu().numpy())


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
    before = fused2d.launches
    assert transposed.impl == "auto" and transposed(x).shape == (2, 4, 204, 184)
    assert fused2d.launches == before + 1


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
    before = fused1d.launches
    assert transposed(x).shape == (2, 4, 5015) and fused1d.launches == before + 1


# (B, Cin, Cout, D, H, W, KD, KH, KW, groups): the benchmark row (4 output
# channels a thread), groups with 1 and 2 output channels a thread, odd
# sizes, KD = 9 (the hop edge), W blocks of 64 (nwb = 4 and 2), and H past
# 256 for SB = 2 and SB = 1 in the dense H/W kernels (300, 460; and 454, where
# NBH = 228 is the first to take SB = 1). Then the factored H/W kernels at the
# constant splits' other H (16, 32, 128; 64 is the benchmark row's), at odd D
# and odd OD (the last slab paired with zeros in the forward, the inverse, or
# both), groups, and a clamped third W block; at mixed-radix working lengths
# (the stuffed 78 = 13 x 6, 48 = 8 x 6, 230 padded to 240, 226 padded to
# 240, 37 padded to 40, 200 padded to 208). Last the D kernel's edges: groups
# whose spectra a block stages in 3 and 2 chunks (8 channels a chunk at 8
# out-channels a block), KD = 9 at D = 10
FUSED3D = [
    (2, 8, 8, 64, 64, 64, 8, 8, 8, 1),
    (1, 6, 6, 20, 24, 30, 3, 3, 3, 2),
    (1, 6, 6, 20, 24, 30, 3, 3, 3, 3),
    (1, 2, 2, 17, 19, 21, 5, 7, 3, 1),
    (1, 1, 2, 26, 18, 18, 9, 3, 3, 1),
    (2, 4, 4, 20, 24, 200, 3, 5, 7, 1),
    (1, 1, 1, 8, 8, 122, 2, 2, 7, 1),
    (1, 1, 2, 10, 230, 20, 3, 3, 3, 1),
    (1, 1, 1, 9, 460, 8, 2, 2, 2, 1),
    (1, 2, 2, 12, 226, 64, 3, 3, 3, 1),
    (1, 2, 2, 12, 454, 64, 3, 3, 3, 1),
    (1, 2, 2, 12, 300, 64, 3, 3, 3, 1),
    (2, 4, 4, 14, 78, 78, 8, 8, 8, 1),
    (2, 4, 4, 12, 48, 48, 4, 5, 3, 2),
    (1, 2, 2, 11, 37, 45, 3, 5, 7, 1),
    (1, 2, 2, 10, 200, 20, 3, 3, 3, 1),
    (1, 2, 3, 13, 16, 20, 3, 3, 3, 1),
    (2, 4, 4, 18, 32, 40, 4, 5, 5, 2),
    (1, 2, 2, 11, 128, 64, 5, 7, 3, 1),
    (1, 2, 2, 9, 64, 150, 3, 3, 7, 1),
    (2, 24, 24, 20, 8, 20, 3, 3, 3, 1),
    (1, 48, 24, 12, 8, 24, 5, 3, 3, 3),
    (2, 4, 4, 10, 16, 12, 9, 3, 3, 1),
]


@pytest.mark.parametrize("b,cin,cout,d,h,w,kd,kh,kw,groups", FUSED3D)
def test_3d_kernel_matches_plain_version(cuda, b, cin, cout, d, h, w, kd, kh, kw, groups):
    x, k = _tensors(cuda, d + h + w, (b, cin, d, h, w), (cout, cin // groups, kd, kh, kw))
    k /= (cin // groups * kd * kh * kw) ** 0.5
    before = fused3d.launches
    hw = fused3d._h_work(h)[0]
    y = fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(k, hw), groups, (kd, kh, kw))
    torch.cuda.synchronize()
    assert fused3d.launches == before + 1
    y_ref = fused3d._fused3d_forward_reference(x, k, groups)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


@pytest.mark.parametrize("nbh", [10, 33, 113, 114, 227, 228, 454, 455])
def test_3d_smem_formula_matches_kernel(cuda, nbh):
    """The plan's shared-memory gate is the kernel's own figure."""
    assert fused3d._smem_bytes(nbh) == fused3d._library().fused3d_smem_bytes(nbh)


def test_3d_kernel_in_item_ranges(cuda, monkeypatch):
    x, k = _tensors(cuda, 3, (2, 4, 20, 24, 150), (4, 4, 3, 5, 7))
    nbh, nbd = 13, 3
    monkeypatch.setattr(fused3d, "_SCRATCH_BUDGET",
                        2 * fused3d._scratch_bytes_per_item(4, 4, 20, nbh, nbd, 18))
    before = fused3d.launches
    y = fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(k, 24), 1, (3, 5, 7))
    assert fused3d.launches - before == 3  # 2 x 3 W blocks, 2 a launch
    y_ref = fused3d._fused3d_forward_reference(x, k)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


# (taps, Hw): B7 at the 64^3 K=8 row (Hw 64), 48^3 (Hw 48), the stuffed 78^3
# of the transposed K=8 row (Hw 78), a dense H (12), the padded 82 -> 84 and
# the dense 300 (the largest H table a block stages here), groups = 2 and KD
# = 1 and 9
SPECTRA_V4 = [
    ((8, 8, 8, 8, 8), 64), ((8, 8, 8, 8, 8), 48), ((8, 8, 8, 8, 8), 78),
    ((4, 4, 3, 3, 3), 12), ((4, 2, 9, 5, 7), 84), ((2, 2, 1, 3, 64), 300),
]


@pytest.mark.parametrize("shape,hw", SPECTRA_V4)
def test_spectra_kernel_matches_plain_version(cuda, shape, hw):
    """B7 against its plain version on the card, and both against the
    complex128 spectra: within 1e-5·max|ref|."""
    (k,) = _tensors(cuda, hw, shape)
    before = fused3d.launches_spectra
    got = fused3d._launch_spectra_v4(k, hw)
    torch.cuda.synchronize()
    assert fused3d.launches_spectra == before + 1
    ref = fused3d._spectra_v4_reference(k, hw)
    oracle = fused3d.kernel_spectra_3d(k.double(), hw)
    assert got.shape == ref.shape == oracle.shape and got.dtype == torch.complex64
    scale = float(oracle.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert float((got.to(torch.complex128) - oracle).abs().max()) <= 1e-5 * scale


def test_inline_routes_3d_cuda_to_b7(cuda):
    """Under inline an unplanned 'v4' call launches B7 once ahead of B3 and
    matches the composed path; a 'tap' call and a serving plan launch no B7;
    a float64 kernel is taken as float32, as B3 takes it."""
    x, w, b, xt, wt = _tensors(cuda, 23, (2, 4, 18, 20, 16), (6, 2, 3, 3, 3), (6,),
                               (1, 2, 30, 16, 12), (2, 2, 11, 3, 3))
    plan = fused3d.plan_fft_conv3d(w[:, :2].repeat(1, 2, 1, 1, 1), signal_dhw=(18, 20, 16))
    fused3d.set_fused3d_inline(True)
    try:
        before = fused3d.launches, fused3d.launches_spectra
        y = ft.fft_conv(x, w, b, groups=2, impl="auto")
        y64 = ft.fft_conv(x.double(), w.double(), b.double(), groups=2, impl="auto")
        assert (fused3d.launches, fused3d.launches_spectra) == (before[0] + 2, before[1] + 2)
        ft.fft_conv(xt, wt, impl="fused")
        plan(x)
        assert fused3d.launches_spectra == before[1] + 2
    finally:
        fused3d.set_fused3d_inline(False)
    y_ref = ft.fft_conv(x, w, b, groups=2, impl="xla")
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())
    _assert_close_scaled(y64.cpu().numpy(), y_ref.cpu().numpy())


def test_auto_routes_3d_cuda_to_the_kernel(cuda):
    x, w, b = _tensors(cuda, 17, (2, 4, 18, 20, 16), (6, 2, 3, 3, 3), (6,))
    kw = dict(padding=2, stride=(2, 1, 3), dilation=2, groups=2, padding_mode="reflect")
    before = fused3d.launches
    y = ft.fft_conv(x, w, b, impl="auto", **kw)
    assert fused3d.launches == before + 1
    y_ref = ft.fft_conv(x, w, b, impl="xla", **kw)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())
    # a plan with W blocks runs the composed path under auto and B3 under fused
    x, w = _tensors(cuda, 18, (1, 2, 10, 8, 200), (3, 2, 2, 2, 7))
    before = fused3d.launches
    y = ft.fft_conv(x, w, impl="auto")
    assert fused3d.launches == before
    _assert_close_scaled(ft.fft_conv(x, w, impl="fused").cpu().numpy(), y.cpu().numpy())
    assert fused3d.launches == before + 1


def test_fused3d_gradients_on_cuda_match_composed(cuda):
    x, w = _tensors(cuda, 19, (2, 4, 16, 18, 20), (4, 2, 3, 5, 3))
    x.requires_grad_()
    w.requires_grad_()
    (ft.fft_conv(x, w, padding=1, groups=2, impl="fused") ** 2).mean().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (ft.fft_conv(x, w, padding=1, groups=2, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.cpu().numpy(), x.grad.cpu().numpy())
    _assert_close_scaled(gw.cpu().numpy(), w.grad.cpu().numpy())


def test_3d_layer_on_cuda_launches_the_kernel(cuda):
    layer = ft.FFTConv3d(4, 4, 5, padding=1, generator=torch.Generator().manual_seed(0))
    assert layer.weight.is_cuda
    (x,) = _tensors(cuda, 20, (2, 4, 20, 24, 22))
    before = fused3d.launches
    y = layer(x)
    assert fused3d.launches == before + 1
    y_ref = ft.fft_conv(x, layer.weight, layer.bias, padding=1, impl="xla")
    _assert_close_scaled(y.detach().cpu().numpy(), y_ref.detach().cpu().numpy())
    transposed = ft.FFTConvTranspose3d(4, 4, 3)  # 3D "auto" is the composed path
    before = fused3d.launches, fused3d.launches_tap
    assert transposed.impl == "auto" and transposed(x).shape == (2, 4, 22, 26, 24)
    assert (fused3d.launches, fused3d.launches_tap) == before


# (B, Cin, Cout, D, H, W, KD, KH, KW, groups): the B4 row (64^3, K=10, 4
# output channels a thread), groups with 1 and 2 output channels a thread,
# odd sizes with KD = 11, W blocks of 64 (nwb = 4) with KD = 12, and KD = 3
# where v4's spectra (69 MB) do not fit but the tap ones do; H = 300 and 454
# take SB = 2 and SB = 1 in the dense H/W kernels (226 is padded to 240).
# Then the factored H/W kernels at H = 16, 32, 128, at odd D and odd OD, and
# a clamped third W block; at the stuffed 82 padded to 84 (7 x 12) and at 70
# (7 x 10). Last the tap MAC's edges: (channel, tap) spectra a block stages in
# 2 chunks (128 entries at 4 out-channels a block), KD = 60 at D = 64, KD = D
FUSED3D_TAP = [
    (2, 8, 8, 64, 64, 64, 10, 10, 10, 1),
    (1, 6, 6, 26, 12, 10, 11, 3, 3, 2),
    (1, 6, 6, 26, 12, 10, 11, 3, 3, 3),
    (1, 2, 3, 25, 19, 21, 11, 5, 3, 1),
    (2, 4, 4, 24, 20, 200, 12, 3, 7, 1),
    (1, 16, 16, 20, 64, 64, 3, 3, 3, 1),
    (1, 2, 2, 16, 226, 64, 10, 3, 5, 1),
    (1, 2, 2, 14, 454, 64, 10, 3, 3, 1),
    (1, 2, 2, 14, 300, 64, 10, 3, 3, 1),
    (2, 4, 4, 20, 82, 82, 10, 10, 10, 1),
    (1, 2, 3, 24, 70, 30, 10, 5, 3, 1),
    (1, 2, 2, 21, 16, 12, 11, 3, 3, 1),
    (1, 2, 3, 24, 32, 30, 10, 5, 3, 1),
    (1, 2, 2, 13, 128, 20, 10, 5, 5, 1),
    (1, 2, 2, 20, 64, 150, 12, 3, 7, 1),
    (2, 16, 16, 14, 16, 12, 11, 3, 3, 1),
    (1, 4, 4, 64, 64, 64, 60, 3, 3, 1),
    (2, 4, 4, 20, 16, 12, 20, 3, 3, 1),
]


@pytest.mark.parametrize("b,cin,cout,d,h,w,kd,kh,kw,groups", FUSED3D_TAP)
def test_3d_tap_kernel_matches_plain_version(cuda, b, cin, cout, d, h, w, kd, kh, kw, groups):
    x, k = _tensors(cuda, d + h + w + 1, (b, cin, d, h, w), (cout, cin // groups, kd, kh, kw))
    k /= (cin // groups * kd * kh * kw) ** 0.5
    assert fused3d.plan_3d_blocked(cin, cout, d, h, w, kd, kh, kw, groups)[0][0] == "tap"
    before = fused3d.launches, fused3d.launches_tap
    y = fused3d._launch_fused3d_tap(x, fused3d.kernel_spectra_tap(k, fused3d._h_work(h)[0]), groups,
                                    (kd, kh, kw))
    torch.cuda.synchronize()
    assert (fused3d.launches, fused3d.launches_tap) == (before[0], before[1] + 1)
    y_ref = fused3d._fused3d_tap_reference(x, k, groups)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


def test_3d_tap_kernel_in_item_ranges(cuda, monkeypatch):
    x, k = _tensors(cuda, 4, (2, 4, 24, 20, 150), (4, 4, 10, 5, 7))
    monkeypatch.setattr(fused3d, "_SCRATCH_BUDGET",
                        2 * fused3d._tap_scratch_bytes_per_item(4, 4, 24, 11, 15))
    before = fused3d.launches_tap
    y = fused3d._launch_fused3d_tap(x, fused3d.kernel_spectra_tap(k, 20), 1, (10, 5, 7))
    assert fused3d.launches_tap - before == 3  # 2 x 3 W blocks, 2 a launch
    y_ref = fused3d._fused3d_tap_reference(x, k)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


def test_3d_tap_routes_on_cuda_launch_b4(cuda):
    x, w, b = _tensors(cuda, 21, (2, 4, 22, 20, 16), (6, 2, 6, 3, 3), (6,))
    kw = dict(padding=1, stride=(1, 2, 1), dilation=(2, 1, 1), groups=2, padding_mode="reflect")
    before = fused3d.launches_tap
    y = ft.fft_conv(x, w, b, impl="auto", **kw)  # KD = 6 dilates to 11
    assert fused3d.launches_tap == before + 1
    _assert_close_scaled(y.cpu().numpy(), ft.fft_conv(x, w, b, impl="xla", **kw).cpu().numpy())
    # forward and backward of a KD = 10 layer
    layer = ft.FFTConv3d(4, 4, 10, padding=1, generator=torch.Generator().manual_seed(1))
    xg = x.clone().requires_grad_()
    (layer(xg) ** 2).mean().backward()
    assert fused3d.launches_tap == before + 2
    gx, gw = xg.grad.clone(), layer.weight.grad.clone()
    xg.grad = layer.weight.grad = None
    (ft.fft_conv(xg, layer.weight, layer.bias, padding=1, impl="xla") ** 2).mean().backward()
    _assert_close_scaled(gx.cpu().numpy(), xg.grad.cpu().numpy())
    _assert_close_scaled(gw.cpu().numpy(), layer.weight.grad.cpu().numpy())


@pytest.mark.parametrize("k,st,pad,op,dil,groups", [
    (3, 2, 1, 1, 1, 2),    # v4: B3
    (4, 1, 0, 0, 3, 1),    # dilation 3 takes K = 4 to 10: tap, B4, two W blocks
])
def test_3d_transpose_fused_on_cuda(cuda, k, st, pad, op, dil, groups):
    x, w, b = _tensors(cuda, 22 + k, (2, 4, 12, 14, 60), (4, 6 // groups, k, k, k), (6,))
    kw = dict(stride=st, padding=pad, output_padding=op, dilation=dil, groups=groups)
    before = fused3d.launches, fused3d.launches_tap
    y = ft.fft_conv_transpose(x, w, b, impl="fused", **kw)
    rose = fused3d.launches - before[0], fused3d.launches_tap - before[1]
    assert rose == ((1, 0) if dil == 1 else (0, 1))
    y_ref = ft.fft_conv_transpose(x, w, b, impl="xla", **kw)
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())
    layer = ft.FFTConvTranspose3d(4, 6, k, impl="fused", **kw)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    _assert_close_scaled(layer(x).detach().cpu().numpy(), y_ref.cpu().numpy())


# (B, Cin, Cout, D, H, W, KD, KH, KW, groups): B3's and B4's tensor-core
# chains at the 3D rows, the dense H step (H = 12, and 13, odd), a padded
# working length (37 -> 40), the stuffed 78 (13 x 6) in two W blocks, H =
# 256, groups 2 and 3 and 3 output channels (4, 2 and 1 a block of
# d_mac_tc), a group staged in 3 chunks; then B4's at K=10, the stuffed 82
# (Hw 84), a dense H and groups 3; then the split (8, 6) of H = 48, 6
# output channels (2 a block of d_mac_tc, its blocking of 4 not filled), and
# one (item, D-block) pair at H = 64, fewer than d_mac_tc's warps. The twin
# of the cases of chip_smoke.py:check_fused3d_tc, which runs without the
# tests: a case added to one belongs in the other.
TC_3D = [
    (2, 8, 8, 64, 64, 64, 8, 8, 8, 1),
    (2, 4, 4, 14, 12, 20, 3, 3, 3, 2),
    (1, 6, 6, 13, 13, 30, 4, 3, 5, 3),
    (1, 2, 3, 11, 37, 45, 3, 5, 7, 1),
    (2, 4, 4, 14, 78, 78, 8, 8, 8, 1),
    (1, 2, 2, 10, 256, 20, 3, 3, 3, 1),
    (2, 24, 24, 20, 8, 20, 3, 3, 3, 1),
    (2, 8, 8, 64, 64, 64, 10, 10, 10, 1),
    (2, 4, 4, 20, 82, 82, 10, 10, 10, 1),
    (2, 4, 4, 24, 12, 20, 12, 3, 7, 1),
    (1, 6, 6, 21, 26, 12, 10, 3, 3, 3),
    (2, 4, 4, 18, 48, 48, 8, 8, 8, 1),
    (1, 4, 6, 16, 20, 20, 3, 3, 3, 1),
    (1, 2, 2, 10, 64, 20, 3, 3, 3, 1),
]


@pytest.fixture
def precision3d():
    """Restores B3's and B4's default precision mode and the x-pack and
    inline switches after the test."""
    yield fused3d.set_fused3d_precision
    fused3d.set_fused3d_precision("highest")
    fused3d.set_fused3d_xpack("h2")
    fused3d.set_fused3d_inline(False)


def _launch_tc_3d(x, k, groups, mode, packed=False):
    """One tensor-core chain of the shape's plan on the card and the counts
    it moved (B3, B4, B3 tensor-core, B4 tensor-core)."""
    counters = ("launches", "launches_tap", "launches_tc", "launches_tap_tc")
    before = [getattr(fused3d, c) for c in counters]
    hw = fused3d._h_work(x.shape[3])[0]
    if fused3d._plan_for(x.shape, k.shape, groups)[0][0] == "tap":
        y = fused3d._launch_fused3d_tap(x, fused3d.kernel_spectra_tap(k, hw), groups,
                                        tuple(k.shape[2:]), mode)
    else:
        y = fused3d._launch_fused3d(x, fused3d.kernel_spectra_3d(k, hw), groups,
                                    tuple(k.shape[2:]), packed, mode)
    torch.cuda.synchronize()
    return y, [getattr(fused3d, c) - b for c, b in zip(counters, before)]


def _assert_tc_3d_close(mode, y, x, k, groups=1):
    """A tensor-core chain's output ``y`` against its plain version of
    ``mode`` on the card: "bf16x3" under the FP32 bar, "bf16" under
    ``_assert_bf16_2d_kernel_close`` (ten rounding steps spread a flipped
    rounding as B2's eight do)."""
    tap = fused3d._plan_for(x.shape, k.shape, groups)[0][0] == "tap"
    ref = fused3d._fused3d_tap_reference if tap else fused3d._fused3d_forward_reference
    y_ref = ref(x, k, groups, mode=mode).cpu().numpy()
    if mode == "bf16x3":
        _assert_close_scaled(y.cpu().numpy(), y_ref)
    else:
        exact = ref(x.double(), k.double(), groups).cpu().numpy()
        _assert_bf16_2d_kernel_close(y.cpu().numpy(), y_ref, exact)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("b,cin,cout,d,h,w,kd,kh,kw,groups", TC_3D)
def test_tc_3d_kernel_matches_plain_version(cuda, mode, b, cin, cout, d, h, w, kd, kh, kw,
                                            groups):
    """B3's and B4's tensor-core chains against their plain versions of the
    same mode, each launched once and no FP32 chain."""
    x, k = _tensors(cuda, d + h + w + 2, (b, cin, d, h, w), (cout, cin // groups, kd, kh, kw))
    k /= (cin // groups * kd * kh * kw) ** 0.5
    y, rose = _launch_tc_3d(x, k, groups, mode)
    assert rose == ([0, 0, 0, 1] if kd > 9 else [0, 0, 1, 0])
    _assert_tc_3d_close(mode, y, x, k, groups)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_3d_kernel_packed_and_in_item_ranges(cuda, monkeypatch, mode):
    """B3's tensor-core chain on B6's packed layout ("pk"), and both chains
    with their items split over several launches."""
    x, k, kt = _tensors(cuda, 5, (2, 4, 20, 24, 150), (4, 4, 3, 5, 7), (4, 4, 10, 5, 7))
    y, rose = _launch_tc_3d(x, k / 20, 1, mode, packed=True)
    assert rose[2] == 1
    _assert_tc_3d_close(mode, y, x, k / 20)
    monkeypatch.setattr(fused3d, "_SCRATCH_BUDGET",
                        2 * fused3d._scratch_bytes_per_item(4, 4, 20, 13, 3, 18))
    y, rose = _launch_tc_3d(x, k / 20, 1, mode)
    assert rose[2] == 3  # 2 x 3 W blocks, 2 a launch
    _assert_tc_3d_close(mode, y, x, k / 20)
    monkeypatch.setattr(fused3d, "_SCRATCH_BUDGET",
                        2 * fused3d._tap_scratch_bytes_per_item(4, 4, 20, 13, 11))
    y, rose = _launch_tc_3d(x, kt / 40, 1, mode)
    assert rose[3] == 3
    _assert_tc_3d_close(mode, y, x, kt / 40)


def test_tc_3d_refuses_what_it_does_not_run(cuda, precision3d):
    """An unknown mode, complex128 spectra and, under a bf16 mode, an H past
    256 raise; nothing is launched."""
    x, w = _tensors(cuda, 3, (1, 2, 10, 260, 12), (2, 2, 3, 3, 3))
    counters = ("launches", "launches_tap", "launches_tc", "launches_tap_tc")
    before = [getattr(fused3d, c) for c in counters]
    spectra = fused3d.kernel_spectra_3d(w, 260)
    with pytest.raises(ValueError, match="precision mode"):
        fused3d._launch_fused3d(x, spectra, 1, (3, 3, 3), mode="fp8")
    with pytest.raises(ValueError, match="H <= 256"):
        fused3d._launch_fused3d(x, spectra, 1, (3, 3, 3), mode="bf16")
    with pytest.raises(ValueError, match="complex64"):
        fused3d._launch_fused3d(x[..., :20, :], fused3d.kernel_spectra_3d(w, 20).to(
            torch.complex128), 1, (3, 3, 3), mode="bf16")
    precision3d("bf16x3")
    with pytest.raises(ValueError, match="H <= 256"):
        ft.fft_conv(x, w)
    assert [getattr(fused3d, c) for c in counters] == before


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_tc_modes_route_every_3d_path_on_cuda(cuda, precision3d, mode):
    """Under a bf16 mode a CUDA tensor's 3D calls (``fft_conv`` under "auto",
    a plan, the fused transposed route, ``FFTConv3d``,
    ``FFTConvTranspose3d``, "pk", inline, a KD = 11 call) launch a
    tensor-core chain and no FP32 one, each within the mode's bar of the
    composed path; back under "highest" they launch the FP32 chains."""
    x, w, b, wt = _tensors(cuda, 31, (2, 4, 20, 24, 30), (4, 4, 5, 3, 3), (4,), (4, 4, 11, 3, 3))
    w, wt = w / 12, wt / 20
    layer = ft.FFTConv3d(4, 4, 3, padding=1, generator=torch.Generator().manual_seed(0))
    tlayer = ft.FFTConvTranspose3d(4, 4, 3, impl="fused",
                                   generator=torch.Generator().manual_seed(1))
    plan = ft.ops.plan_fft_conv(w, b, signal_spatial=(20, 24, 30))
    xla = dict(impl="xla")
    calls = [
        (lambda: ft.fft_conv(x, w, b), lambda: ft.fft_conv(x, w, b, **xla), 2),
        (lambda: plan(x), lambda: ft.fft_conv(x, w, b, **xla), 2),
        (lambda: ft.fft_conv_transpose(x, w, b, impl="fused"),
         lambda: ft.fft_conv_transpose(x, w, b, **xla), 2),
        (lambda: layer(x), lambda: ft.fft_conv(x, layer.weight, layer.bias, padding=1, **xla), 2),
        (lambda: tlayer(x), lambda: ft.fft_conv_transpose(x, tlayer.weight, tlayer.bias, **xla),
         2),
        (lambda: ft.fft_conv(x, wt, b), lambda: ft.fft_conv(x, wt, b, **xla), 3),
    ]
    counters = ("launches", "launches_tap", "launches_tc", "launches_tap_tc")

    def held(fn, ref, rises):
        before = [getattr(fused3d, c) for c in counters]
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        rose = [getattr(fused3d, c) - v for c, v in zip(counters, before)]
        assert rose == [int(i == rises) for i in range(4)], rose
        y_ref = ref().detach().cpu().numpy()
        if mode == "bf16x3":
            _assert_close_scaled(y.cpu().numpy(), y_ref)
        else:  # against the exact result, the JAX package's serving bar
            sigma = max(1.0, float(y_ref.std()))
            err = np.abs(y.cpu().numpy() - y_ref)
            assert err.mean() < 5e-3 * sigma and err.max() < 5e-2 * sigma

    precision3d(mode)
    for fn, ref, rises in calls:
        held(fn, ref, rises)
    for on in (lambda: fused3d.set_fused3d_xpack("pk"), lambda: fused3d.set_fused3d_inline(True)):
        on()
        held(*calls[0])
        fused3d.set_fused3d_xpack("h2")
        fused3d.set_fused3d_inline(False)
    precision3d("highest")
    before = fused3d.launches, fused3d.launches_tc
    plan(x)
    assert (fused3d.launches, fused3d.launches_tc) == (before[0] + 1, before[1])


# (B, Cin, D, H, W, (KD, KH, KW), groups): B6 at the benchmark row (PP = 40,
# D = 64 padded to 80), D < 2PP with W < 64, two W blocks whose clamped last
# block starts off 16 B alignment (the stuffed 78^3 volume's W), groups = 2,
# and H large enough for SB = 1 in B3; then an odd D at H = 32 with a clamped
# W block, for B3's factored H/W kernels, and H = 37, which they pad to 40
PACK3D = [
    (2, 8, 64, 64, 64, (8, 8, 8), 1),
    (1, 2, 20, 16, 14, (5, 3, 3), 1),
    (2, 3, 12, 6, 78, (3, 3, 8), 1),
    (1, 4, 9, 5, 64, (2, 3, 3), 2),
    (1, 1, 9, 460, 8, (2, 2, 2), 1),
    (1, 3, 15, 32, 70, (3, 3, 7), 1),
    (2, 4, 11, 37, 45, (3, 5, 7), 1),
]


@pytest.mark.parametrize("b,cin,d,h,w,k,groups", PACK3D)
def test_pack_kernel_equals_plain_version_and_pk_equals_direct(cuda, b, cin, d, h, w, k, groups):
    """B6 writes every element (the output starts as NaN) and equals its
    plain version exactly; B3 reading the packed layout gives B3's direct
    result bit for bit."""
    x, kern = _tensors(cuda, d + h + w, (b, cin, d, h, w), (cin, cin // groups) + k)
    kern /= (cin // groups * k[0] * k[1] * k[2]) ** 0.5
    plan, nwb, hop = fused3d.plan_3d_blocked(cin, cin, d, h, w, *k, groups)
    assert plan[0] == "v4"
    out = torch.full((b * nwb, h, cin * plan[3], 128), float("nan"), device=cuda)
    before = fused3d.launches_pack
    xp = fused3d._launch_pack3d(x, plan[3], nwb, hop, out=out)
    torch.cuda.synchronize()
    assert fused3d.launches_pack == before + 1 and xp.data_ptr() == out.data_ptr()
    assert torch.equal(xp, fused3d._pack3d_reference(x, plan[3], nwb, hop))
    spectra = fused3d.kernel_spectra_3d(kern, fused3d._h_work(h)[0])
    direct = fused3d._launch_fused3d(x, spectra, groups, k)
    packed = fused3d._launch_fused3d(x, spectra, groups, k, packed=True)
    torch.cuda.synchronize()
    assert fused3d.launches_pack == before + 2
    assert torch.equal(packed, direct)
    y_ref = fused3d._fused3d_forward_reference(x, kern, groups, packed=True)
    _assert_close_scaled(packed.cpu().numpy(), y_ref.cpu().numpy())


def test_pk_routes_on_cuda(cuda):
    """Under "pk" a 'v4' call of auto, of a layer and of the fused transposed
    route runs B6 and then B3; a 'tap' call runs B4 alone."""
    x, w, wt = _tensors(cuda, 23, (2, 4, 18, 20, 16), (6, 2, 3, 3, 3), (6, 2, 11, 3, 3))
    try:
        fused3d.set_fused3d_xpack("pk")
        before = fused3d.launches, fused3d.launches_tap, fused3d.launches_pack
        y = ft.fft_conv(x, w, groups=2, padding=1)
        assert (fused3d.launches, fused3d.launches_tap, fused3d.launches_pack) == (
            before[0] + 1, before[1], before[2] + 1)
        _assert_close_scaled(y.cpu().numpy(),
                             ft.fft_conv(x, w, groups=2, padding=1, impl="xla").cpu().numpy())
        y = ft.fft_conv(x, wt, groups=2)
        assert (fused3d.launches_tap, fused3d.launches_pack) == (before[1] + 1, before[2] + 1)
        _assert_close_scaled(y.cpu().numpy(),
                             ft.fft_conv(x, wt, groups=2, impl="xla").cpu().numpy())
        layer = ft.FFTConv3d(4, 4, 5, padding=1, generator=torch.Generator().manual_seed(2))
        xg = x.clone().requires_grad_()
        (layer(xg) ** 2).mean().backward()
        assert fused3d.launches_pack == before[2] + 2
        gx = xg.grad.clone()
        xg.grad = None
        (ft.fft_conv(xg, layer.weight, layer.bias, padding=1, impl="xla") ** 2).mean().backward()
        _assert_close_scaled(gx.cpu().numpy(), xg.grad.cpu().numpy())
        wtr = w[:4].reshape(4, 2, 3, 3, 3)  # (Cin, Cout, K, K, K)
        y = ft.fft_conv_transpose(x, wtr, stride=2, impl="fused")
        assert fused3d.launches_pack == before[2] + 3
        _assert_close_scaled(
            y.cpu().numpy(), ft.fft_conv_transpose(x, wtr, stride=2, impl="xla").cpu().numpy())
    finally:
        fused3d.set_fused3d_xpack("h2")


def _counting_spectra(monkeypatch):
    calls = []
    for module, name in ((fused1d, "kernel_spectra_one_sided"),
                         (fused2d, "kernel_spectra_2d"), (fused2d, "kernel_spectra_2d_planes"),
                         (fused3d, "kernel_spectra_3d"), (fused3d, "kernel_spectra_tap")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


@pytest.mark.parametrize("ndim,kernel_shape,counter", [
    (1, (4, 4, 300), (fused1d, "launches")),
    (2, (4, 4, 9, 7), (fused2d, "launches")),
    (3, (4, 4, 5, 3, 3), (fused3d, "launches")),
    (3, (4, 4, 11, 3, 3), (fused3d, "launches_tap")),
])
def test_plan_on_cuda_launches_its_kernel_once_per_call(cuda, monkeypatch, ndim, kernel_shape,
                                                        counter):
    """A plan on the card is tier 1: each call launches its kernel once and
    computes no spectra; the call is CUDA-graph capturable."""
    spatial = {1: (5000,), 2: (150, 140), 3: (20, 24, 18)}[ndim]
    x, w, b = _tensors(cuda, 24 + ndim, (2, 4) + spatial, kernel_shape, (4,))
    plan = ft.ops.plan_fft_conv(w, b, padding=1, signal_spatial=spatial)
    calls = _counting_spectra(monkeypatch)
    module, name = counter
    before = getattr(module, name)
    y = plan(x)
    torch.cuda.synchronize()
    assert getattr(module, name) == before + 1 and calls == []
    y_ref = ft.fft_conv(x, w, b, padding=1, impl="xla")
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph = plan(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y_graph, y)
    xg = x.clone().requires_grad_()
    plan(xg).sum().backward()
    g_ref = x.clone().requires_grad_()
    ft.fft_conv(g_ref, w, b, padding=1, impl="xla").sum().backward()
    _assert_close_scaled(xg.grad.cpu().numpy(), g_ref.grad.cpu().numpy())


def test_plans_on_cuda_follow_the_switches(cuda):
    x2, w2, x3, w3 = _tensors(cuda, 25, (2, 4, 150, 140), (4, 4, 9, 7), (1, 4, 20, 24, 18),
                              (4, 4, 5, 3, 3))
    plan2 = ft.ops.plan_fft_conv(w2, signal_spatial=(150, 140))
    plan3 = ft.ops.plan_fft_conv(w3, signal_spatial=(20, 24, 18))
    y2, y3 = plan2(x2), plan3(x3)
    try:
        fused2d.set_fused2d_kernel("v3")
        fused3d.set_fused3d_xpack("pk")
        before = fused2d.launches, fused2d.launches_v3, fused3d.launches_pack
        y2v3, y3pk = plan2(x2), plan3(x3)
        assert (fused2d.launches, fused2d.launches_v3, fused3d.launches_pack) == (
            before[0], before[1] + 1, before[2] + 1)
    finally:
        fused2d.set_fused2d_kernel("v2")
        fused3d.set_fused3d_xpack("h2")
    _assert_close_scaled(y2v3.cpu().numpy(), y2.cpu().numpy())
    assert torch.equal(y3pk, y3)
    with pytest.raises(ValueError, match="plan lives on"):
        plan2(x2.cpu())


def test_transposed_plans_on_cuda(cuda):
    """1D and 2D transposed plans run B1 and B2 on the stuffed signal; the
    3D one stays on the torch.fft tier."""
    x1, w1, x2, w2, x3, w3 = _tensors(cuda, 26, (2, 4, 3000), (4, 4, 200), (2, 4, 60, 50),
                                      (4, 4, 7, 9), (1, 4, 12, 14, 16), (4, 2, 3, 3, 3))
    for x, w, module, kw in ((x1, w1, fused1d, dict(stride=2, padding=3)),
                             (x2, w2, fused2d, dict(stride=(2, 1), output_padding=(1, 0))),
                             (x3, w3, fused3d, dict(stride=2, groups=2))):
        plan = ft.ops.plan_fft_conv_transpose(w, signal_spatial=x.shape[2:], **kw)
        before = module.launches
        y = plan(x)
        torch.cuda.synchronize()
        assert module.launches == before + (x.ndim != 5)
        y_ref = ft.fft_conv_transpose(x, w, impl="xla", **kw)
        _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


def test_streaming_on_cuda_launches_b1_per_chunk(cuda):
    """A 1D stream at the K=1024 benchmark row (B=2, 8 -> 8): 8 chunks of
    4096 samples, one B1 launch each; the joined outputs equal the one-shot
    call over the left-padded stream, and the final state the last K-1
    samples."""
    from fft_conv_tpu_torch.ops import streaming_conv1d_init, streaming_conv1d_step

    x, w, b = _tensors(cuda, 27, (2, 8, 32768), (8, 8, 1024), (8,))
    w = w / (8 * 1024) ** 0.5
    state = streaming_conv1d_init(2, 8, 1024)
    assert state.device.type == "cuda"
    before = fused1d.launches
    outs = []
    for i in range(8):
        y, state = streaming_conv1d_step(state, x[..., 4096 * i:4096 * (i + 1)], w, b)
        outs.append(y)
    torch.cuda.synchronize()
    assert fused1d.launches == before + 8
    y_ref = ft.fft_conv(torch.nn.functional.pad(x, (1023, 0)), w, b, impl="xla")
    _assert_close_scaled(torch.cat(outs, dim=-1).cpu().numpy(), y_ref.cpu().numpy())
    assert torch.equal(state, x[..., -1023:])


def test_checkpoint_round_trip_on_cuda(cuda, tmp_path):
    from fft_conv_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    layer = ft.FFTConv1d(8, 8, 1024, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, layer)
    fresh = load_checkpoint(path, ft.FFTConv1d(8, 8, 1024,
                                               generator=torch.Generator().manual_seed(1)))
    assert fresh.weight.device.type == "cuda"
    assert torch.equal(fresh.weight, layer.weight) and torch.equal(fresh.bias, layer.bias)
    (x,) = _tensors(cuda, 28, (2, 8, 32768))
    with torch.no_grad():
        assert torch.equal(fresh(x), layer(x))


def _launch_counts():
    torch.cuda.synchronize()
    return (fused1d.launches, fused2d.launches, fused2d.launches_v3, fused3d.launches,
            fused3d.launches_tap, fused3d.launches_pack)


_TF32_SETTINGS = {
    "allow_tf32": lambda m: setattr(m, "allow_tf32", True),
    "medium": lambda m: torch.set_float32_matmul_precision("medium"),
    "fp32_precision tf32": lambda m: setattr(m, "fp32_precision", "tf32"),
}


@pytest.fixture(params=list(_TF32_SETTINGS))
def tf32_allowed(request):
    """TF32 allowed globally through the legacy flag, the precision string
    or the newer per-backend flag; torch's defaults after."""
    m = torch.backends.cuda.matmul
    _TF32_SETTINGS[request.param](m)
    try:
        yield m
    finally:
        torch.set_float32_matmul_precision("highest")
        m.fp32_precision = "none"


@pytest.mark.parametrize("fn,shapes,kw", [
    ("fft_conv", ((2, 4, 256, 250), (4, 2, 9, 7), (4,)), dict(padding=2, stride=(1, 2), groups=2)),
    ("fft_conv_transpose", ((2, 4, 90, 84), (4, 3, 9, 7), (3,)),
     dict(stride=2, padding=1, output_padding=1)),
])
def test_tiled_on_cuda_runs_fp32_products_under_tf32(cuda, tf32_allowed, fn, shapes, kw):
    """A 2D tiled call (several tiles a dim) with TF32 allowed globally
    stays within the bar of the composed path, launches no fused kernel and
    leaves the caller's setting as it found it."""
    x, w, b = _tensors(cuda, 40, *shapes)
    y_ref = getattr(ft, fn)(x, w, b, impl="xla", **kw)
    before = _launch_counts()
    y = getattr(ft, fn)(x, w, b, impl="tiled", **kw)
    assert tf32_allowed.fp32_precision == "tf32"
    assert _launch_counts() == before
    _assert_close_scaled(y.cpu().numpy(), y_ref.cpu().numpy())


def test_tiled_call_replays_in_a_cuda_graph(cuda):
    x, w = _tensors(cuda, 41, (2, 8, 512, 512), (8, 8, 16, 16))
    y = ft.fft_conv(x, w, impl="tiled")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph = ft.fft_conv(x, w, impl="tiled")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y_graph, y)
    _assert_close_scaled(y.cpu().numpy(), ft.fft_conv(x, w, impl="xla").cpu().numpy())


def test_tiled_gradients_on_cuda_under_tf32(cuda, tf32_allowed):
    """The products' backward, which runs outside the forward's FP32 scope,
    enters its own: a tiled call's gradients stay within the bar of the
    composed path's with TF32 allowed globally."""
    x, w = _tensors(cuda, 42, (2, 4, 256, 250), (6, 4, 9, 7))  # tiles of 96 x 128
    grads = []
    for impl in ("tiled", "xla"):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        (ft.fft_conv(xg, wg, impl=impl) ** 2).sum().backward()
        grads.append((xg.grad, wg.grad))
    assert tf32_allowed.fp32_precision == "tf32"
    for got, want in zip(*grads):
        _assert_close_scaled(got.cpu().numpy(), want.cpu().numpy())
