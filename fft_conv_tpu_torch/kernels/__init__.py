"""The port's kernels. Only the fused 1D kernel (B1) is ported so far; the 2D
and 3D kernels are listed in ROADMAP.md §B."""

from .fourstep import four_step_fft, four_step_ifft, kernel_spectrum
from .fused1d import choose_fft_size, fft_conv1d_fused

__all__ = [
    "fft_conv1d_fused",
    "choose_fft_size",
    "four_step_fft",
    "four_step_ifft",
    "kernel_spectrum",
]
