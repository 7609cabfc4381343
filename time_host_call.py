#!/usr/bin/env python3
"""Times the host's share of one eager call of the port on one NVIDIA GPU,
at the 1D benchmark row (B=2, 8 -> 8 channels, L=32768, K=1024, float32,
inputs from a torch.Generator seeded with 0): the serving plan
(``ops.plan_fft_conv``, kernel B1 with its spectra baked) and the unplanned
``fft_conv(impl="auto")``.

    python3 time_host_call.py [--root DIR] [--rounds N]

Each round makes CALLS calls back to back and synchronizes once at its end;
the round's wall time over CALLS is the time per call. Both calls enqueue
slower than the card runs them (the card's time is a fraction of the
call's latency at this row), so this is the host's time per call, the
launch and the Python around it. Prints one JSON line per call with the
median and the least of the rounds, in microseconds.

``--root`` is the checkout whose ``fft_conv_tpu_torch`` is timed (default:
the directory of this script), so that two trees can be compared in one
run on one card, for example a ``git archive`` of the parent commit
unpacked under ``build/``: run parent, change, change, parent.
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, CIN, COUT, L, K = 2, 8, 8, 32768, 1024
# calls per round: each round lasts tens of milliseconds
CALLS = {"plan": 2000, "auto": 200}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--rounds", type=int, default=25)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.kernels import fused1d
    from fft_conv_tpu_torch.ops import plan_fft_conv

    if not torch.cuda.is_available():
        sys.exit("time_host_call.py needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, CIN, L, device=dev, generator=gen)
    w = torch.randn(COUT, CIN, K, device=dev, generator=gen) / K ** 0.5
    planned = plan_fft_conv(w, signal_spatial=(L,), max_batch=B)
    calls = {"plan": lambda: planned(x), "auto": lambda: fft_conv(x, w, impl="auto")}
    for what, fn in calls.items():
        n = CALLS[what]
        for _ in range(20):  # warm-up: the build, the caches, the allocator
            fn()
        torch.cuda.synchronize()
        before = fused1d.launches
        rounds = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / n * 1e6)
        launched = fused1d.launches - before
        if launched != args.rounds * n:
            sys.exit(f"{what}: B1 launched {launched} times in {args.rounds * n} calls")
        print(json.dumps({
            "root": root, "call": what, "calls_per_round": n, "rounds": args.rounds,
            "median_us": statistics.median(rounds), "min_us": min(rounds),
            "rounds_us": rounds,
        }), flush=True)


if __name__ == "__main__":
    main()
