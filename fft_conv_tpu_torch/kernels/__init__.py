"""The port's kernels: the fused 1D (B1, its DFT products bf16 tensor-core
products under ``set_fused_precision("bf16x3")`` or ``("bf16")``), 2D (B2,
the same under ``set_fused2d_precision``, and B5 on the "v3" schedule that
``set_fused2d_kernel`` selects), 3D
overlap-save-D (B3, reading a signal packed by the x-pack kernel B6 under
``set_fused3d_xpack("pk")``, and spectra computed from the raw taps by
kernel B7 under ``set_fused3d_inline(True)``) and 3D tap (B4) kernels (B3's
and B4's DFT products bf16 tensor-core products under
``set_fused3d_precision("bf16x3")`` or ``("bf16")``), their wrappers, the
fused transposed routes in 1D, 2D and 3D, and the serving plans with baked
spectra."""

from .fourstep import four_step_fft, four_step_ifft, kernel_spectrum
from .fused1d import (
    choose_fft_size,
    fft_conv1d_fused,
    fft_conv_transpose1d_fused,
    plan_fft_conv1d,
    set_fused_precision,
)
from .fused2d import (
    fft_conv2d_fused,
    fft_conv_transpose2d_fused,
    fused2d_fits,
    plan_fft_conv2d,
    set_fused2d_kernel,
    set_fused2d_precision,
    tile_plan_2d,
)
from .fused3d import (
    fft_conv3d_fused,
    fft_conv_transpose3d_fused,
    plan_3d,
    plan_3d_blocked,
    plan_fft_conv3d,
    set_fused3d_inline,
    set_fused3d_precision,
    set_fused3d_xpack,
)

__all__ = [
    "fft_conv1d_fused",
    "fft_conv2d_fused",
    "fft_conv3d_fused",
    "fft_conv_transpose1d_fused",
    "fft_conv_transpose2d_fused",
    "fft_conv_transpose3d_fused",
    "set_fused_precision",
    "set_fused2d_kernel",
    "set_fused2d_precision",
    "set_fused3d_xpack",
    "set_fused3d_inline",
    "set_fused3d_precision",
    "plan_fft_conv1d",
    "plan_fft_conv2d",
    "plan_fft_conv3d",
    "choose_fft_size",
    "fused2d_fits",
    "tile_plan_2d",
    "plan_3d",
    "plan_3d_blocked",
    "four_step_fft",
    "four_step_ifft",
    "kernel_spectrum",
]
