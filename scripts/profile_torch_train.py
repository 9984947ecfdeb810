"""Where the time of one PyTorch-port training step goes, on one NVIDIA card.

Runs a chip_smoke.py training path (DenoisingTrainer.train() at the
painn_so3.yml + base.yml settings, B=48, or with ``--model eqv2`` at the
eqv2_so3.yml + base.yml settings, B=12) on bench systems written to shards
in a temporary directory, for one epoch of a few steps, and prints:

- the wall time per step (an epoch with the profiler off, after a warm-up
  step), the card's busy time per step (the sum of all device-side events of
  a profiled epoch of the same steps) and the idle share;
- the device kernels with the most time, with their share of busy time.

    python scripts/profile_torch_train.py [--model painn|eqv2] [--steps 10]

The last line is one JSON object with the same numbers.
"""
import argparse
import copy
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from adsorbdiff_tpu_torch.device import resolve_device  # noqa: E402
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer  # noqa: E402
from chip_smoke import (  # noqa: E402
    EQV2_TRAIN_BATCH,
    EQV2_TRAIN_CONFIG,
    TRAIN_BATCH,
    TRAIN_CONFIG,
    write_training_shards,
)

TOP_KERNELS = 15  # rows of the per-kernel table


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("painn", "eqv2"), default="painn")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if args.model == "painn":
        batch_size, config = TRAIN_BATCH, copy.deepcopy(TRAIN_CONFIG)
        what = f"B={batch_size}, N=80, H=512, 6 layers, K=50"
    else:
        batch_size, config = EQV2_TRAIN_BATCH, copy.deepcopy(EQV2_TRAIN_CONFIG)
        what = f"EquiformerV2, B={batch_size}, N=80, 8 layers, C=128, lmax 4 / mmax 2, K=20"

    device = resolve_device(None)
    with tempfile.TemporaryDirectory() as root:
        paths = write_training_shards(root, {"train": batch_size * args.steps})
        trainer = DenoisingTrainer(dict(config, run_dir=root, logger=None, dataset=[{"src": paths["train"]}]),
                                   device=device)
        batch = next(iter(trainer.train_batcher)).to(device)
        trainer.train_step(batch, generator=torch.Generator(device=device).manual_seed(0))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # wall time with the profiler off
        trainer.train()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        trainer.step = 0  # a second epoch over the same batches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train()
            torch.cuda.synchronize()

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    per_step = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3 / args.steps,
                "device_events": sum(c for c, _ in by_name.values()) / args.steps}
    per_step["idle_share"] = 1.0 - per_step["device_busy_ms"] / wall_ms
    print(f"{torch.cuda.get_device_name(0)}; {args.steps} training steps ({what})")
    print(f"per step: wall {wall_ms:.3f} ms (profiler off), device busy {per_step['device_busy_ms']:.3f} ms "
          f"(profiler on; side-stream copies may overlap), idle share {per_step['idle_share']:.3f}; "
          f"{per_step['device_events']:.0f} device events of {len(by_name)} kinds")
    top = []
    for name, (calls, us) in sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP_KERNELS]:
        row = {"name": name, "calls_per_step": calls / args.steps, "device_ms_per_step": us / 1e3 / args.steps,
               "share": us / busy_us}
        top.append(row)
        print(f"{row['share']:7.1%}  {row['device_ms_per_step']:9.4f} ms/step  {row['calls_per_step']:6.1f} calls/step  "
              f"{name[:100]}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "model": args.model,
                      "steps": args.steps, **per_step, "top": top}))


if __name__ == "__main__":
    main()
