"""The JAX package's five example scripts (``examples/``), ported.

Each module has ``run(device=None, ..., seed=0)``, which makes the script's
inputs from ``np.random.default_rng(seed)`` in the script's order, runs its
calls on ``device`` (the card unless ``device="cpu"``) and returns a dict
of the inputs and results, and ``main()``, which calls ``run()`` on the card
and prints the script's lines. Run one as

    python -m fft_conv_tpu_torch.examples.<name>

with ``<name>`` one of ``long_audio_filter``, ``serving_plans``,
``image_filter_bank_2d``, ``volume_stencil_3d`` and ``train_fft_cnn``.
"""
