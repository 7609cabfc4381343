#!/usr/bin/env python3
"""Times kernels B3 and B4 (csrc/fused3d.cu) on one NVIDIA GPU at one shape
per SB, the slabs a block of their H/W kernels holds (4, 2, 1), with the
device time of each of their kernels.

    python3 time_fused3d_sb.py [--root DIR]

``--root`` is the checkout whose ``fft_conv_tpu_torch`` is timed (default:
the directory of this script), so that two trees can be compared in one
run on one card, for example a ``git archive`` of the parent commit
unpacked under ``build/``: run parent, change, change, parent. The timing
helpers (``device_ms``, a CUDA graph of 20 calls replayed 30 times, and
``phase_split_ms``, torch.profiler's device time per kernel) are those of
this script's own ``chip_smoke.py``. Inputs come from a torch.Generator
seeded with 0; each row also prints its max abs error against the plain
version. Prints one JSON line per row.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (chain, B, Cin, Cout, D, H, W, K): the 3D benchmark rows (SB = 4) and the
# largest volumes of chip_smoke.py's checks that keep each chain's plan at
# H = 226 (NBH 114, SB = 2) and H = 454 (NBH 228, SB = 1)
ROWS = [
    ("B3", 2, 8, 8, 64, 64, 64, 8),
    ("B3", 2, 4, 4, 16, 226, 64, 3),
    ("B3", 2, 2, 2, 12, 454, 64, 3),
    ("B4", 2, 8, 8, 64, 64, 64, 10),
    ("B4", 2, 8, 8, 16, 454, 64, 3),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    root = os.path.abspath(parser.parse_args().root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from fft_conv_tpu_torch.kernels import fused3d

    if not torch.cuda.is_available():
        sys.exit("time_fused3d_sb.py needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for chain, b, cin, cout, d, h, w, k in ROWS:
        x = torch.randn(b, cin, d, h, w, device=dev, generator=gen)
        wt = torch.randn(cout, cin, k, k, k, device=dev, generator=gen) / k ** 1.5
        if chain == "B3":
            spectra = fused3d.kernel_spectra_3d(wt, h)
            launch, reference = fused3d._launch_fused3d, fused3d._fused3d_forward_reference
        else:
            spectra = fused3d.kernel_spectra_tap(wt, h)
            launch, reference = fused3d._launch_fused3d_tap, fused3d._fused3d_tap_reference
        plan = fused3d._plan_for(x.shape, wt.shape, 1)[0]

        def kernel():
            return launch(x, spectra, 1, (k, k, k))

        err = float((kernel() - reference(x, wt)).abs().max())
        print(json.dumps({
            "root": root, "chain": chain, "shape": [b, cin, cout, d, h, w, k],
            "plan": list(plan), "sb": fused3d._slabs_per_block(plan[1]), "max_abs_err": err,
            "ms": smoke.device_ms(kernel),
            "phase_ms": smoke.phase_split_ms(torch, kernel, "fused3d_"),
        }), flush=True)


if __name__ == "__main__":
    main()
