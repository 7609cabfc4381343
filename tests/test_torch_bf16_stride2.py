"""The bf16 precision modes on transposed calls with stride 2, dilation 2 and
groups, the port's and the JAX package's, each against float64.

At these calls the errors against torch's float64 ``conv_transpose{2,3}d``
reach the bars that hold at the forward rows (``test_bf16_meets_the_serving_bar``
in ``test_torch_fused{2,3}d_precision.py``), and at the 3D cases they pass them
in both packages. So the port is held to JAX's error at the same inputs: its
err_mean and err_max at most ``FACTOR`` times JAX's. The port runs its plain
versions (``fft_conv_transpose(impl="fused")`` on the CPU), JAX its Pallas
kernels in interpret mode (its "bf16x3" as the exact split ``bf16x3_exact``).

Measured on the CPU at numpy seeds 0-3 (2D) and 0-2 (3D), the port's error
over JAX's: err_mean 1.17-1.24x (2D), 1.53-1.59x and 0.66-0.80x (3D);
err_max 1.06-1.34x, 0.94-1.46x and 1.09-1.34x. The port's factored DFT
steps round their operands twice per axis where JAX's dense products round
once. The tests run seed 0, which JAX's interpret mode keeps under a minute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import fft_conv_tpu as fc
import fft_conv_tpu_torch as ft
from fft_conv_tpu.kernels import fused2d as jax_fused2d
from fft_conv_tpu.kernels import fused3d as jax_fused3d
from fft_conv_tpu_torch.kernels import set_fused2d_precision, set_fused3d_precision

# the port's err_mean and err_max, each at most this many times JAX's
FACTOR = 1.6

# (x shape, kernel shape (Cin, Cout/g, K...), keywords): ROADMAP §C item 1's
# three cases
CASES = [
    ((2, 4, 100, 150), (4, 2, 21, 8),
     dict(stride=2, dilation=2, groups=2, output_padding=1)),
    ((1, 2, 31, 16, 12), (2, 3, 5, 2, 2),
     dict(stride=2, padding=1, dilation=2, groups=2, output_padding=1)),
    ((2, 4, 20, 12, 31), (4, 3, 11, 3, 2),
     dict(stride=2, padding=2, dilation=2, groups=2)),
]


def _err(y, y_ref):
    """(err_mean, err_max) in units of sigma = max(1, std(ref))."""
    sigma = max(1.0, float(np.std(y_ref)))
    err = np.abs(np.asarray(y, np.float64) - y_ref)
    return err.mean() / sigma, err.max() / sigma


@pytest.fixture
def modes():
    """Sets the mode of the case's rank in both packages: ``modes(ndim,
    mode)``; restores the defaults ("highest" here, "bf16x3" in JAX)."""
    def set_modes(ndim, mode):
        if ndim == 2:
            set_fused2d_precision(mode)
            jax_fused2d.set_fused2d_precision(mode)
        else:
            set_fused3d_precision(mode)
            jax_fused3d.set_fused3d_precision(mode)

    try:
        yield set_modes
    finally:
        set_fused2d_precision("highest")
        set_fused3d_precision("highest")
        jax_fused2d.set_fused2d_precision("bf16x3")
        jax_fused3d.set_fused3d_precision("bf16x3")


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("xs,ws,kw", CASES)
def test_transposed_stride2_error_within_factor_of_jax(modes, mode, xs, ws, kw):
    ndim = len(xs) - 2
    rng = np.random.default_rng(0)
    x, w, bias = (rng.standard_normal(s).astype(np.float32)
                  for s in (xs, ws, (ws[1] * kw["groups"],)))
    conv = TF.conv_transpose2d if ndim == 2 else TF.conv_transpose3d
    y_ref = conv(*(torch.from_numpy(a).double() for a in (x, w, bias)), **kw).numpy()
    modes(ndim, mode)
    y = ft.fft_conv_transpose(*map(torch.from_numpy, (x, w, bias)), impl="fused", **kw)
    y_jax = fc.fft_conv_transpose(*map(jnp.asarray, (x, w, bias)), impl="fused", **kw)
    assert y.shape == y_jax.shape == y_ref.shape
    ours, theirs = _err(y.numpy(), y_ref), _err(np.asarray(y_jax), y_ref)
    assert ours[0] <= FACTOR * theirs[0] and ours[1] <= FACTOR * theirs[1], (ours, theirs)
