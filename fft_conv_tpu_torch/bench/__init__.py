"""Measurement: the timing harness (``harness``, aliased as
``fft_conv_tpu_torch.benchmark_utils``) and the profiling helpers
(``profiling``), the port's counterparts of ``fft_conv_tpu/bench/``. The
kernels' cost counts that ``profiling.cost_analysis`` reads live beside the
kernels, in ``kernels/costs.py``. The JAX package's benchmark plot
generator is not ported."""
