"""Version info of the PyTorch package (kept in step with fft_conv_tpu's)."""

VERSION = (0, 1, 0)
__version__ = ".".join(map(str, VERSION))
