"""The port's kernels: the fused 1D (B1), 2D (B2) and 3D overlap-save-D (B3)
kernels so far; the 3D tap kernel, B2's alternate schedule and the 3D x-pack
kernel are listed in ROADMAP.md §B."""

from .fourstep import four_step_fft, four_step_ifft, kernel_spectrum
from .fused1d import choose_fft_size, fft_conv1d_fused
from .fused2d import fft_conv2d_fused, fused2d_fits, tile_plan_2d
from .fused3d import fft_conv3d_fused, plan_3d, plan_3d_blocked

__all__ = [
    "fft_conv1d_fused",
    "fft_conv2d_fused",
    "fft_conv3d_fused",
    "choose_fft_size",
    "fused2d_fits",
    "tile_plan_2d",
    "plan_3d",
    "plan_3d_blocked",
    "four_step_fft",
    "four_step_ifft",
    "kernel_spectrum",
]
