"""The port's fused 3D path against the JAX package's.

On the CPU the port's wrapper runs the kernel's plain version
(``_fused3d_forward_reference``), and the JAX wrapper runs its Pallas kernel
in interpret mode with the bf16x3-exact split, as ``tests/test_pallas3d.py``
runs it. Both are held with ``helpers._assert_close_scaled``, the error model
of that precision. The CUDA kernel itself is tested on the card in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu_torch.kernels import fused3d

from helpers import _assert_close_scaled


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Cin, Cout, D, H, W, KD, KH, KW, groups, stride, dilation, padding, mode):
# the v4 rows of tests/test_pallas3d.py:CONFIGS (odd sizes, KD = 9 at the hop
# edge, the benchmark-like KD = 8), its stride/dilation cases, the three
# padding modes, groups (2, 3) and (3, 3), and both W-blocked shapes
PARITY = [
    (1, 2, 3, 20, 24, 16, 3, 5, 4, 1, 1, 1, 0, "constant"),
    (2, 4, 4, 32, 32, 32, 4, 4, 4, 1, 1, 1, 2, "constant"),
    (1, 1, 1, 10, 14, 12, 2, 3, 5, 1, 1, 1, 0, "constant"),
    (1, 2, 2, 17, 19, 21, 5, 7, 3, 1, 1, 1, 0, "constant"),
    (1, 1, 2, 24, 16, 16, 9, 3, 3, 1, 1, 1, 1, "constant"),
    (1, 2, 2, 40, 32, 32, 8, 5, 5, 1, 1, 1, 0, "constant"),
    (1, 2, 3, 18, 20, 16, 3, 3, 3, 1, 2, 1, 0, "constant"),
    (1, 2, 3, 18, 20, 16, 3, 3, 3, 1, 1, 2, 0, "constant"),
    (1, 2, 3, 18, 20, 16, 3, 3, 3, 1, (2, 1, 3), 1, 0, "constant"),
    (1, 2, 2, 12, 14, 12, 3, 3, 3, 1, 1, 1, 2, "reflect"),
    (1, 2, 2, 12, 14, 12, 3, 3, 3, 1, 1, 1, 2, "replicate"),
    (1, 2, 2, 12, 14, 12, 3, 3, 3, 1, 1, 1, 2, "circular"),
    (1, 6, 6, 10, 12, 10, 3, 3, 3, 2, 1, 1, 0, "constant"),
    (1, 6, 6, 10, 12, 10, 3, 3, 3, 3, 1, 1, 0, "constant"),
    (2, 2, 3, 10, 8, 200, 2, 2, 7, 1, 1, 1, 0, "constant"),   # nwb = 4
    (1, 1, 1, 8, 8, 122, 2, 2, 7, 1, 1, 1, 0, "constant"),    # nwb = 2, ow = 2 hops
]


@pytest.mark.parametrize(
    "b,cin,cout,d,h,w,kd,kh,kw,groups,stride,dilation,padding,mode", PARITY
)
def test_plain_version_matches_jax_fused(b, cin, cout, d, h, w, kd, kh, kw, groups,
                                         stride, dilation, padding, mode):
    x, k, bias = _arrays(d + h + w + kd, (b, cin, d, h, w),
                         (cout, cin // groups, kd, kh, kw), (cout,))
    kw_ = dict(padding=padding, padding_mode=mode, stride=stride, dilation=dilation,
               groups=groups)
    y_jax = jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k),
                                         jnp.asarray(bias), **kw_)
    before = fused3d.launches
    y = fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(bias), **kw_)
    assert fused3d.launches == before
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


def test_fft_conv_fused_3d_matches_jax():
    """The whole slice through the public entry point on both sides."""
    x, k, bias = _arrays(5, (2, 3, 20, 22, 18), (4, 3, 5, 4, 3), (4,))
    kw = dict(padding=(1, 2, 0), stride=(1, 2, 1), impl="fused")
    before = fused3d.launches
    y = ft.fft_conv(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias), **kw)
    assert fused3d.launches == before
    y_jax = fc.fft_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), **kw)
    _assert_close_scaled(y.numpy(), np.asarray(y_jax))


# (Cin, Cout, D, H, W, KD, KH, KW, groups): padded shapes of the cases above,
# the benchmark row, tap plans (KD > 9), W-blocked plans and shapes that fit
# neither
PLANS = [
    (2, 3, 20, 24, 16, 3, 5, 4, 1), (4, 4, 36, 36, 36, 4, 4, 4, 1),
    (2, 2, 17, 19, 21, 5, 7, 3, 1), (1, 2, 26, 18, 18, 9, 3, 3, 1),
    (8, 8, 64, 64, 64, 8, 8, 8, 1), (6, 6, 10, 12, 10, 3, 3, 3, 3),
    (2, 2, 30, 16, 12, 11, 3, 3, 1), (6, 6, 26, 12, 10, 11, 3, 3, 2),
    (2, 3, 10, 8, 200, 2, 2, 7, 1), (8, 8, 64, 64, 200, 8, 8, 8, 1),
    (1, 1, 8, 8, 122, 2, 2, 7, 1), (1, 1, 8, 8, 300, 2, 2, 70, 1),
    (3, 3, 6, 6, 6, 7, 3, 3, 1), (3, 4, 12, 12, 12, 3, 3, 3, 2),
]


@pytest.mark.parametrize("cin,cout,d,h,w,kd,kh,kw,groups", PLANS)
def test_plans_match_jax(cin, cout, d, h, w, kd, kh, kw, groups):
    args = (cin, cout, d, h, w, kd, kh, kw, groups)
    assert fused3d.plan_3d(*args) == jax_fused3d.plan_3d(*args)
    assert fused3d.plan_3d_blocked(*args) == jax_fused3d.plan_3d_blocked(*args)


def test_plan_fuses_the_benchmark_row():
    """64^3, K=8, 8 -> 8 channels: one W block, the JAX geometry, and spectra
    of 17.3 MB, past the 1D/2D kernels' 16 MiB budget but inside this one."""
    assert fused3d.plan_3d_blocked(8, 8, 64, 64, 64, 8, 8, 8) == (
        ("v4", 33, 40, 40, 8, 32), 1, 57)
    spectra = 16 * 8 * 8 * 33 * 64 * 8
    assert 16 * 2**20 < spectra <= fused3d._SPECTRA_BUDGET
    assert fused3d._slabs_per_block(33) == 4 and fused3d._smem_bytes(33) == 67584
    assert fused3d._scratch_bytes_per_item(8, 8, 64, 33, 8, 57) <= fused3d._SCRATCH_BUDGET


def test_budgets_differ_from_jax_where_intended():
    """ROADMAP §C: the kernel's own budgets replace the TPU's. The port's v4
    plan fits wherever the JAX one does, and also where only the TPU's
    limits refused it."""
    # the TPU kernel unrolls (Cin/g) x Cout MAC statements, at most 128
    assert jax_fused3d.plan_3d(16, 16, 16, 16, 16, 3, 3, 3)[0] == "tap"
    assert fused3d.plan_3d(16, 16, 16, 16, 16, 3, 3, 3)[0] == "v4"
    # the TPU's 96 MiB whole-volume cell; here the scratch of one item counts
    assert jax_fused3d.plan_3d(1, 4, 64, 200, 8, 3, 3, 3)[0] == "tap"
    assert fused3d.plan_3d(1, 4, 64, 200, 8, 3, 3, 3)[0] == "v4"
    assert jax_fused3d.plan_3d(1, 8, 128, 200, 8, 3, 3, 3) is None
    assert fused3d.plan_3d(1, 8, 128, 200, 8, 3, 3, 3)[0] == "v4"
    # the stuffed 78^3 volume of a transposed conv at the benchmark row
    assert jax_fused3d.plan_3d_blocked(8, 8, 78, 78, 78, 8, 8, 8) == (("tap", 40, 40, 48), 2, 57)
    assert fused3d.plan_3d_blocked(8, 8, 78, 78, 78, 8, 8, 8) == (("v4", 40, 40, 40, 9, 40), 2, 57)
    assert fused3d._scratch_bytes_per_item(1, 1, 2048, 129, 256, 2046) > fused3d._SCRATCH_BUDGET
    assert fused3d._plan_v4(1, 1, 2048, 256, 64, 3, 3, 3) is None
    # spectra counted at NBH x 64 bins in L2, not NBHP x 128 lanes of VMEM
    assert jax_fused3d.plan_3d(10, 10, 16, 48, 16, 3, 3, 3)[0] == "tap"
    assert fused3d.plan_3d(10, 10, 16, 48, 16, 3, 3, 3)[0] == "v4"
    assert fused3d._plan_v4(16, 16, 16, 64, 16, 3, 3, 3) is None  # 69 MB of spectra
    # shared memory: SB = 4, 2, 1 slabs a block, no plan past NBH = 454
    assert [fused3d._slabs_per_block(n) for n in (113, 114, 227, 228, 454, 455)] == \
        [4, 2, 2, 1, 1, None]
    assert fused3d._plan_v4(1, 1, 9, 908, 8, 3, 3, 3) is None
    # the tap plan keeps the JAX budgets until B4 is ported
    assert fused3d._plan_tap(8, 8, 64, 64, 64, 11, 8, 8) == \
        jax_fused3d._plan_tap(8, 8, 64, 64, 64, 11, 8, 8)
    # no fallback: the port raises where the JAX function takes the composed path
    x, k = np.zeros((1, 1, 8, 8, 300), np.float32), np.zeros((1, 1, 2, 2, 70), np.float32)
    assert jax_fused3d.fft_conv3d_fused(jnp.asarray(x), jnp.asarray(k)).shape == (1, 1, 7, 7, 231)
    with pytest.raises(ValueError, match="no fused 3D FFT configuration"):
        fused3d.fft_conv3d_fused(torch.from_numpy(x), torch.from_numpy(k))


@pytest.mark.parametrize("h,vh", [(64, 57), (19, 13), (200, 194)])
def test_mats_match_jax(h, vh):
    ours = fused3d._mats_3d(h, vh)
    fr, fi, bwr, bwi, bur, bui, cr, ci = jax_fused3d._mats_3d(h, vh)
    theirs = (fr, fi, bwr[:64, :64], bwi[:64, :64], bur[:64, :64], bui[:64, :64], cr, ci)
    for a, b in zip(ours[:6] + ours[10:], theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("shape,h", [((4, 4, 8, 8, 8), 64), ((6, 2, 5, 7, 3), 19),
                                     ((2, 3, 9, 3, 3), 16)])
def test_kernel_spectra_match_jax(shape, h):
    """The JAX package packs two D-bins into 128 lanes, fd = f8 + 8 s; the port
    keeps (Cout, Cin/g, 16, NBH, 64)."""
    cout, cpg = shape[:2]
    (k,) = _arrays(sum(shape), shape)
    k /= np.sqrt(k[0].size)
    nbh = h // 2 + 1
    nbhp = -(-nbh // 8) * 8
    kr, ki = jax_fused3d._kernel_spectra_v4(jnp.asarray(k), h, nbh, nbhp)

    def unpack(a):  # (f8, c, o, NBHP, s * 64 + z) -> (o, c, f8 + 8 s, n, z)
        a = np.asarray(a).reshape(8, cpg, cout, nbhp, 2, 64)[:, :, :, :nbh]
        return a.transpose(2, 1, 4, 0, 3, 5).reshape(cout, cpg, 16, nbh, 64)

    spectra = fused3d.kernel_spectra_3d(torch.from_numpy(k), h)
    assert spectra.dtype == torch.complex64 and spectra.shape == (cout, cpg, 16, nbh, 64)
    assert np.abs(spectra.real.numpy() - unpack(kr)).max() < 2e-5
    assert np.abs(spectra.imag.numpy() - unpack(ki)).max() < 2e-5


@pytest.mark.parametrize("shape,k,groups", [
    ((2, 4, 20, 24, 30), (4, 2, 5, 3, 4), 2),   # one W block, 3 D blocks
    ((1, 2, 12, 9, 150), (3, 2, 9, 4, 7), 1),   # 3 W blocks, odd H, KD = 9
])
def test_plain_version_is_exact_in_float64(shape, k, groups):
    """The blocked pipeline in float64 against the composed path: agreement to
    float64 rounding shows the D blocks, the one-sided rows, the irfft
    weights, the W blocks and the valid-region crop are exact."""
    x, w = _arrays(sum(shape), shape, k)
    xt = torch.from_numpy(x).double()
    wt = torch.from_numpy(w).double()
    y = fused3d._fused3d_forward_reference(xt, wt, groups)
    y_ref = ft.fft_conv(xt, wt, groups=groups, impl="xla")
    assert y.dtype == torch.float64 and y.shape == y_ref.shape
    assert (y - y_ref).abs().max() < 1e-9


def test_tap_plan_raises_naming_b4():
    """KD = 11 plans the JAX package's tap kernel (B4), which is not ported:
    the fused routes raise, on the CPU as on the card; auto on a CPU signal
    is the composed path."""
    x, k = _arrays(11, (1, 2, 30, 16, 12), (2, 2, 11, 3, 3))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    assert fused3d.plan_3d(2, 2, 30, 16, 12, 11, 3, 3)[0] == "tap"
    with pytest.raises(NotImplementedError, match="B4"):
        fused3d.fft_conv3d_fused(xt, kt)
    with pytest.raises(NotImplementedError, match="B4"):
        ft.fft_conv(xt, kt, impl="fused")
    with pytest.raises(NotImplementedError, match="B4"):
        fused3d._fused3d_forward(xt, kt)
    y = ft.fft_conv(xt, kt, impl="auto")
    assert torch.equal(y, ft.fft_conv(xt, kt, impl="xla"))


def test_fused3d_gradients_match_composed():
    x, w = _arrays(3, (2, 4, 14, 12, 16), (4, 2, 3, 5, 3))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    kw = dict(padding=(1, 2, 0), groups=2)
    (fused3d.fft_conv3d_fused(xt, wt, **kw) ** 2).mean().backward()
    gx, gw = xt.grad.clone(), wt.grad.clone()
    xt.grad = wt.grad = None
    (ft.fft_conv(xt, wt, impl="xla", **kw) ** 2).mean().backward()
    _assert_close_scaled(gx.numpy(), xt.grad.numpy())
    _assert_close_scaled(gw.numpy(), wt.grad.numpy())


def test_fused3d_validation():
    x = torch.zeros(1, 4, 10, 10, 10)
    with pytest.raises(ValueError, match="expects"):
        fused3d.fft_conv3d_fused(x[0], torch.zeros(2, 4, 3, 3, 3))
    with pytest.raises(ValueError, match="groups"):
        fused3d.fft_conv3d_fused(x, torch.zeros(2, 3, 3, 3, 3), groups=2)
    with pytest.raises(ValueError, match="divisible"):
        fused3d.fft_conv3d_fused(x, torch.zeros(3, 2, 3, 3, 3), groups=2)
    with pytest.raises(ValueError, match="greater than"):
        fused3d.fft_conv3d_fused(x, torch.zeros(2, 4, 11, 3, 3))
    wide = (torch.zeros(1, 1, 8, 8, 300), torch.zeros(1, 1, 2, 2, 70))
    assert fused3d.fft_conv3d_fused_if_fits(*wide) is None
    with pytest.raises(ValueError, match="no fused 3D FFT configuration"):
        ft.fft_conv(*wide, impl="fused")
    # auto fuses single-block plans only
    blocked = (torch.zeros(1, 1, 8, 8, 200), torch.zeros(1, 1, 2, 2, 7))
    assert fused3d.fft_conv3d_fused_if_fits(*blocked, w_blocks=False) is None
    assert fused3d.fft_conv3d_fused_if_fits(*blocked).shape == (1, 1, 7, 7, 194)


def test_kernel_wrapper_takes_only_cuda_tensors():
    spectra = fused3d.kernel_spectra_3d(torch.zeros(2, 2, 3, 3, 3), 10)
    with pytest.raises(ValueError, match="CUDA"):
        fused3d._launch_fused3d(torch.zeros(1, 2, 10, 10, 10), spectra, 1, (3, 3, 3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused3d._fused3d_forward(torch.zeros(1, 2, 10, 10, 10, device="meta"),
                                 torch.zeros(2, 2, 3, 3, 3, device="meta"))
