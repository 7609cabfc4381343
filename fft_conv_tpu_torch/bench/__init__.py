"""Measurement: the timing harness (``harness``, aliased as
``fft_conv_tpu_torch.benchmark_utils``), the profiling helpers
(``profiling``) and the crossover sweep (``generate_benchmark_plot``), the
port's counterparts of ``fft_conv_tpu/bench/``. The kernels' cost counts
that ``profiling.cost_analysis`` reads live beside the kernels, in
``kernels/costs.py``."""
