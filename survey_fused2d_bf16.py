#!/usr/bin/env python3
"""How closely B2's tensor-core pair follows its plain version, on a CUDA card.

    python3 survey_fused2d_bf16.py [--seeds N]

For the tile shapes of tests/test_torch_cuda.py (128 x 128, 256 x 128,
384 x 128, 128 x 256) and the two 2D benchmark rows, each with N seeds (one
at the rows), runs the pair under "bf16x3" and "bf16" and prints one JSON
line per call: err_mean and err_max of the kernel against its plain version
on the CPU (``_fused2d_forward_reference(..., mode=)``), in units of sigma =
max(1, std(ref)), the tiles whose err_mean passes 1e-5 * sigma, and the
ratio of the kernel's err_mean against the float64 result to the plain
version's. The last line holds the worst of each. It shows how far a bf16
rounding that goes the other way spreads through a tile
(tests/test_torch_cuda.py:_assert_bf16_2d_kernel_close).
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("survey_fused2d_bf16: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fft_conv_tpu_torch.kernels import fused2d

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(2, 8, 8, 300, 290, 16, 16, 1), (1, 3, 2, 129, 400, 7, 9, 1),
             (2, 4, 6, 200, 300, 12, 100, 2), (1, 2, 2, 300, 140, 70, 5, 1),
             (1, 2, 2, 400, 150, 200, 9, 1), (2, 8, 8, 512, 512, 16, 16, 1),
             (2, 8, 8, 512, 512, 34, 34, 1)]
    worst = {}
    for b, cin, cout, h, w, k1, k2, groups in cases:
        for seed in range(args.seeds if h < 512 else 1):
            rng = np.random.default_rng(seed)
            x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32))
            k = torch.from_numpy(rng.standard_normal((cout, cin // groups, k1, k2))
                                 .astype(np.float32)) / (cin // groups * k1 * k2) ** 0.5
            plan = fused2d.tile_plan_2d(k1, k2, cin // groups, cout)
            spectra = fused2d.kernel_spectra_2d(k.cuda(), plan[0], plan[2], plan[3])
            exact = fused2d._fused2d_forward_reference(x.double(), k.double(), groups)
            for mode in ("bf16x3", "bf16"):
                y = fused2d._launch_fused2d(x.cuda(), spectra, plan, groups, (k1, k2), mode)
                y = y.cpu().double()
                ref = fused2d._fused2d_forward_reference(x, k, groups, mode=mode).double()
                sigma = max(1.0, float(ref.std()))
                err = (y - ref).abs()
                _, v1, _, _, v2 = plan
                tiles = [float(err[..., i:i + v1, j:j + v2].mean()) / sigma
                         for i in range(0, err.shape[-2], v1) for j in range(0, err.shape[-1], v2)]
                ratio = float((y - exact).abs().mean()) / float((ref - exact).abs().mean())
                row = {"mode": mode, "shape": [b, cin, cout, h, w, k1, k2, groups], "seed": seed,
                       "plan": list(plan), "err_mean": float(err.mean()) / sigma,
                       "err_max": float(err.max()) / sigma,
                       "tiles_apart": sum(t > 1e-5 for t in tiles), "tiles": len(tiles),
                       "err_ratio_vs_float64": ratio}
                print(json.dumps(row), flush=True)
                top = worst.setdefault(mode, {"calls": 0, "err_mean": 0.0, "err_max": 0.0,
                                              "ratio_off": 0.0})
                top["calls"] += 1
                top["err_mean"] = max(top["err_mean"], row["err_mean"])
                top["err_max"] = max(top["err_max"], row["err_max"])
                top["ratio_off"] = max(top["ratio_off"], abs(ratio - 1))
    print(json.dumps({"worst": worst, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
