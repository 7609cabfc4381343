"""The port's kernels: the fused 1D (B1) and 2D (B2) kernels so far; the 3D
kernels and B2's alternate schedule are listed in ROADMAP.md §B."""

from .fourstep import four_step_fft, four_step_ifft, kernel_spectrum
from .fused1d import choose_fft_size, fft_conv1d_fused
from .fused2d import fft_conv2d_fused, fused2d_fits, tile_plan_2d

__all__ = [
    "fft_conv1d_fused",
    "fft_conv2d_fused",
    "choose_fft_size",
    "fused2d_fits",
    "tile_plan_2d",
    "four_step_fft",
    "four_step_ifft",
    "kernel_spectrum",
]
