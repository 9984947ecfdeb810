"""How far bf16 roundoff alone moves the PyTorch port's EquiformerV2, beside how far bf16 moves it from f32, on one NVIDIA card.

For each ``--layers`` depth, at the eqv2_so3.yml widths with chip_smoke.py
phase 29's seeded weights and its B=2 bench systems, the bf16 model runs on
the card and on the CPU, the f32 model on the CPU, and three CPU bf16
forwards whose parameters are multiplied by (1 + 2e-7 N(0,1)).  Per force
head it prints, each as a fraction of max|cpu bf16|: the card's distance
from the CPU's bf16, the CPU's bf16-to-f32 distance d, the card's distance
from the CPU's f32, and the roundoff spread (the largest of the three
perturbed forwards' distances).  No gate: a reading where the spread
reaches d is what the script looks for.

    python scripts/spread_torch_bf16_eqv2.py [--layers 2 4 8]
"""
import argparse
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2
    from adsorbdiff_tpu_torch.ops import build

    if not torch.cuda.is_available():
        raise SystemExit("spread_torch_bf16_eqv2: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    device = smoke.resolve_device(None)
    build.build()
    small = smoke.collate(smoke.bench_systems()[:2], max_atoms=80, device=device)
    for layers in args.layers:
        kw = dict(smoke.EQV2_KW, num_layers=layers)
        model16, model32 = (EquiformerV2(**kw, compute_dtype=cdt, device=device,
                                         generator=torch.Generator().manual_seed(7)) for cdt in ("bfloat16", None))
        try:  # the line is printed before the gate; a reading past it is a reading
            smoke.bf16_card_vs_cpu(f"EquiformerV2 {layers} layers", model16, model32, small,
                                   ("force_block", "force_block2"), fixed=1.0)
        except AssertionError as exc:
            print(f"[spread] {layers} layers: {exc}", flush=True)


if __name__ == "__main__":
    main()
