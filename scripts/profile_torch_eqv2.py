"""Where the time of one PyTorch-port EquiformerV2 sampling step goes, on one
NVIDIA card.

Runs the chip_smoke.py EquiformerV2 path (the eqv2_so3.yml widths, bench.py's
16 synthetic 80-atom systems, ODE reverse diffusion with the hoisted static
graph) under ``torch.profiler`` for a few steps and prints what
``scripts/profile_torch_sampling.py`` prints: wall and device-busy time per
step, the idle share, and the device kernels with the most time.

    python scripts/profile_torch_eqv2.py [--steps 5] [--compute-dtype bfloat16]

The last line is one JSON object with the same numbers.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from adsorbdiff_tpu_torch.device import resolve_device  # noqa: E402
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2  # noqa: E402
from chip_smoke import EQV2_KW, EQV2_PARAMS  # noqa: E402
from profile_torch_sampling import profile_sampling  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16",), help="the model's compute_dtype")
    args = ap.parse_args()
    model = EquiformerV2(**EQV2_KW, compute_dtype=args.compute_dtype, device=resolve_device(None),
                         generator=torch.Generator().manual_seed(0))
    profile_sampling(model, EQV2_PARAMS, args.steps,
                     f"EquiformerV2 sampling steps (B=16, N=80, 8 layers, C=128, lmax 4 / mmax 2, K=20, compute_dtype "
                     f"{args.compute_dtype})")


if __name__ == "__main__":
    main()
