"""Where the time of one PyTorch-port sampling step goes, on one NVIDIA card.

Runs the chip_smoke.py main path (PaiNN at the painn_so3.yml widths, bench.py's
16 synthetic 80-atom systems, ODE reverse diffusion with the hoisted static
graph) under ``torch.profiler`` for a few steps and prints:

- the wall time per step (a run with the profiler off), the card's busy
  time per step (the sum of all device-side events of a profiled run of the
  same steps) and the idle share;
- the device kernels with the most time, with their share of busy time.

    python scripts/profile_torch_sampling.py [--steps 20] [--compute-dtype bfloat16]

The last line is one JSON object with the same numbers.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from adsorbdiff_tpu_torch.data.schema import collate  # noqa: E402
from adsorbdiff_tpu_torch.device import resolve_device  # noqa: E402
from adsorbdiff_tpu_torch.models.painn import PaiNN  # noqa: E402
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, make_score_fn  # noqa: E402
from chip_smoke import MODEL_KW, PARAMS, bench_systems  # noqa: E402

TOP_KERNELS = 15  # rows of the per-kernel table


def profile_sampling(model, params: dict, steps: int, title: str) -> None:
    """Profile ``steps`` ODE steps of ``model``'s DiffusionEngine on the 16
    bench systems and print the per-step numbers (see the module docstring)."""
    device = next(model.parameters()).device
    batch = collate(bench_systems(), max_atoms=80, device=device)

    def engine(n):
        return DiffusionEngine(make_score_fn(model), dict(params, num_steps=n), static_fn=model.prepare_static,
                               device=device)

    gen = torch.Generator(device=device)
    engine(2).run(batch, generator=gen.manual_seed(0))  # warm-up: kernels built, allocator primed
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # wall time with the profiler off
    engine(steps).run(batch, generator=gen.manual_seed(1))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine(steps).run(batch, generator=gen.manual_seed(1))
        torch.cuda.synchronize()

    # device-side events only (kernels, copies, sets); one stream, so no overlap
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    per_step = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3 / steps,
                "device_events": sum(c for c, _ in by_name.values()) / steps}
    per_step["idle_share"] = 1.0 - per_step["device_busy_ms"] / wall_ms
    print(f"{torch.cuda.get_device_name(0)}; {steps} {title}")
    print(f"per step: wall {wall_ms:.3f} ms (profiler off), device busy {per_step['device_busy_ms']:.3f} ms "
          f"(profiler on), idle share {per_step['idle_share']:.3f}; {per_step['device_events']:.0f} device events "
          f"of {len(by_name)} kinds")
    top = []
    for name, (calls, us) in sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP_KERNELS]:
        row = {"name": name, "calls_per_step": calls / steps, "device_ms_per_step": us / 1e3 / steps,
               "share": us / busy_us}
        top.append(row)
        print(f"{row['share']:7.1%}  {row['device_ms_per_step']:9.4f} ms/step  {row['calls_per_step']:6.1f} calls/step  "
              f"{name[:100]}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "steps": steps, **per_step, "top": top}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16",), help="the model's compute_dtype")
    args = ap.parse_args()
    model = PaiNN(**MODEL_KW, compute_dtype=args.compute_dtype, device=resolve_device(None),
                  generator=torch.Generator().manual_seed(0))
    profile_sampling(model, PARAMS, args.steps, f"sampling steps (B=16, N=80, H=512, 6 layers, K=50, compute_dtype "
                                                f"{args.compute_dtype})")


if __name__ == "__main__":
    main()
