"""Example: filtering a long audio stream three ways.

Shows the three execution modes on the library's headline use case
(long-1D-signal convolution, reference README.md:29-30):

  1. one-shot  — fft_conv, impl="auto" (kernel B1 on the card)
  2. planned   — plan_fft_conv, kernel spectrum baked for serving (B1)
  3. streaming — chunked causal convolution with carried state (B1 once
     per chunk)

The port of ``examples/long_audio_filter.py``.

Run: python -m fft_conv_tpu_torch.examples.long_audio_filter
"""

import numpy as np
import torch

from fft_conv_tpu_torch import fft_conv
from fft_conv_tpu_torch.ops import (
    plan_fft_conv,
    streaming_conv1d_init,
    streaming_conv1d_step,
)
from fft_conv_tpu_torch.utils.device import Device, resolve_device


def run(device: Device = None, batch: int = 2, channels: int = 4, length: int = 1 << 18,
        taps: int = 513, chunk_len: int = 1024, seed: int = 0) -> dict:
    """The script's three modes on ``device`` (the card unless
    ``device="cpu"``): the inputs ("audio", "fir") and the outputs
    ("filtered", "served", "streamed") and the number of stream steps
    ("chunks")."""
    dev = resolve_device(device, "the example runs")
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(
        rng.standard_normal((batch, channels, length)).astype(np.float32)).to(dev)
    fir = rng.standard_normal((channels, channels, taps)).astype(np.float32)
    fir = torch.from_numpy(fir * np.float32(1.0 / taps)).to(dev)

    # 1. one-shot
    filtered = fft_conv(audio, fir, padding=taps // 2)

    # 2. planned (serve many buffers with one kernel)
    plan = plan_fft_conv(fir, padding=taps // 2, signal_spatial=(length,), device=dev)
    served = plan(audio)

    # 3. streaming (causal) over chunk_len-sample chunks; a start past the
    # last whole chunk is clamped, as the JAX script's dynamic slice does
    state = streaming_conv1d_init(batch, channels, taps, device=dev)
    outs = []
    for start in range(0, length, chunk_len):
        start = min(start, length - chunk_len)
        y, state = streaming_conv1d_step(state, audio[..., start:start + chunk_len], fir)
        outs.append(y)
    streamed = torch.cat(outs, dim=-1)
    return {"audio": audio, "fir": fir, "filtered": filtered, "served": served,
            "streamed": streamed, "chunks": len(outs)}


def main():
    r = run()
    filtered, served, streamed = r["filtered"], r["served"], r["streamed"]
    print(f"one-shot:  {tuple(filtered.shape)} on {torch.cuda.get_device_name(filtered.device)}")
    print(f"planned:   {tuple(served.shape)}, max diff vs one-shot "
          f"{float((served - filtered).abs().max()):.2e}")
    print(f"streaming: {tuple(streamed.shape)} ({r['chunks']} chunks, causal)")


if __name__ == "__main__":
    main()
