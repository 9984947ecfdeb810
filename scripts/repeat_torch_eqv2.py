"""Repeated readings of the PyTorch port's S^2 activation backward kernel and EquiformerV2 training, on one NVIDIA card.

One process takes, ``--runs`` times each:

- s2_grid_silu_bwd per launch (CUDA events over 500 launches after
  warm-up, with the SM clock nvidia-smi reads meanwhile) at chip_smoke.py
  phase 13b's shape, h and dy [12, 80, 20, 19, 64] (the first attention
  block's input of a B=12 EquiformerV2 training forward), with the
  eqv2_so3.yml tables (lmax 4, mmax 2, grid 18: [324, 19]); h and dy
  random from a seeded generator;
- chip_smoke.py's phase 14: one DenoisingTrainer.train() epoch of 20 steps
  at B=12 (eqv2_so3.yml + base.yml, random weights) on bench systems
  written to shards in a temporary directory; systems/s over the 19 steps
  after the first.

Host-clock rates move between processes, so every reading is printed, not
a summary.  ``--root`` takes chip_smoke.py and adsorbdiff_tpu_torch from
another checkout (an older commit unpacked with ``git archive``), so two
commits can be compared on one card in one call: run the script once per
checkout, alternating them.

    python scripts/repeat_torch_eqv2.py [--runs 1] [--root DIR]

The last line is one JSON object with every reading.
"""
import argparse
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile

# h's shape at phase 13b: [B, N, K, NC, C]
BWD_SHAPE = (12, 80, 20, 19, 64)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose chip_smoke.py and adsorbdiff_tpu_torch are run (default: this one)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.models import equiformer_v2
    from adsorbdiff_tpu_torch.ops import build, kernels
    from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer

    if not torch.cuda.is_available():
        raise SystemExit("repeat_torch_eqv2: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; checkout {root}", flush=True)
    device = smoke.resolve_device(None)  # also switches TF32 off
    build.build(["s2_grid_silu", "s2_grid_silu_bwd", "eqv2_attn_conv1", "eqv2_edge_rotate"])

    gen = torch.Generator().manual_seed(0)
    to_m, from_m = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(4, 2, 18))
    h, dy = (torch.randn(BWD_SHAPE, generator=gen).to(device) for _ in range(2))

    def kernel_ms():
        """Per launch, CUDA events over 500 launches, with the card's SM clock
        (nvidia-smi every 50 ms while they run; the median sample)."""
        smi_clock = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                                      "-lms", "50"], stdout=subprocess.PIPE, text=True)
        ms = smoke.cuda_ms(lambda: kernels.s2_grid_silu_bwd(h, dy, to_m, from_m), 500)
        smi_clock.terminate()
        samples = sorted(int(x) for x in smi_clock.communicate()[0].split())
        return ms, samples[len(samples) // 2] if samples else None

    def train():
        with tempfile.TemporaryDirectory() as tmp:
            paths = smoke.write_training_shards(tmp, {"train": smoke.EQV2_TRAIN_BATCH * smoke.EQV2_TRAIN_STEPS,
                                                      "val": smoke.EQV2_EVAL_BATCH})
            config = dict(copy.deepcopy(smoke.EQV2_TRAIN_CONFIG), run_dir=tmp,
                          dataset=[{"src": paths["train"]}, {"src": paths["val"]}])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                trainer = DenoisingTrainer(config, device=device)
                per_step = trainer.model.num_layers + 2
                smoke.train_one_epoch(trainer, smoke.EQV2_TRAIN_STEPS, {
                    "s2_grid_silu": per_step, "eqv2_attn_conv1": per_step, "s2_grid_silu_bwd": per_step,
                    "eqv2_edge_rotate": 2 * (1 + 3 * per_step)})
        return float(re.search(r"([0-9.]+) systems/s", out.getvalue()).group(1))

    readings = []
    for run in range(args.runs):
        ms, clock = kernel_ms()
        reading = dict(kernel_ms=ms, sm_clock_mhz=clock, training_systems_per_s=train())
        readings.append(reading)
        print(f"[run {run}] s2_grid_silu_bwd {ms:.4f} ms at h{BWD_SHAPE} (SM clock {clock} MHz); EquiformerV2 "
              f"training {reading['training_systems_per_s']:.2f} systems/s", flush=True)
    print(json.dumps({"device": smi, "root": root, "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
