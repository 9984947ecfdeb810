"""Where the time of one PyTorch-port relaxation step goes, on one NVIDIA card.

Runs the chip_smoke.py relaxation path (GemNet-OC at the gemnet_relax.yml
widths with random weights, 8 of bench.py's synthetic 80-atom systems,
batched L-BFGS at the published relax_opt with the Verlet graph on) under
``torch.profiler`` for a few steps and prints:

- the wall time per step (a run with the profiler off), the card's busy
  time per step (the sum of all device-side events of a profiled run of the
  same steps) and the idle share;
- the device kernels with the most time, with their share of busy time,
  then the port's hand-written kernels (``ops/build.py::KERNELS``) with their
  device time per launch.

Per-step numbers divide a whole ``RelaxationEngine.run`` by ``--steps``: it
holds ``--steps`` model forwards, the final forward, the first candidate
build and any Verlet rebuilds.

    python scripts/profile_torch_relax.py [--steps 10] [--compute-dtype bfloat16]

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
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC  # noqa: E402
from adsorbdiff_tpu_torch.ops import build, pbc  # noqa: E402
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import RelaxationEngine  # noqa: E402
from chip_smoke import GEMNET_KW, RELAX_BATCH, RELAX_OPT, bench_systems  # noqa: E402

TOP_KERNELS = 15  # rows of the per-kernel table


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16",), help="the model's compute_dtype")
    args = ap.parse_args()

    device = resolve_device(None)
    systems = bench_systems(RELAX_BATCH)
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], GEMNET_KW["cutoff"])
    batch = collate(systems, max_atoms=80, device=device)
    model = GemNetOC(**GEMNET_KW, cell_reps=cell_reps, compute_dtype=args.compute_dtype, device=device,
                     generator=torch.Generator().manual_seed(3))

    def run(steps):
        RelaxationEngine.from_model(model, dict(RELAX_OPT, steps=steps), device=device).run(batch)
        torch.cuda.synchronize()

    run(2)  # warm-up: kernels built, allocator primed
    t0 = time.perf_counter()  # wall time with the profiler off
    run(args.steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(args.steps)

    # device-side events only (kernels, copies, sets); one stream, so no overlap
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
    print(f"{torch.cuda.get_device_name(0)}; {args.steps} L-BFGS steps (B={RELAX_BATCH}, N=80, GemNet-OC "
          f"gemnet_relax.yml widths, cell_reps {cell_reps}, Verlet graph, compute_dtype {args.compute_dtype})")
    print(f"per step: wall {wall_ms:.3f} ms (profiler off), device busy {per_step['device_busy_ms']:.3f} ms "
          f"(profiler on), idle share {per_step['idle_share']:.3f}; {per_step['device_events']:.0f} device events "
          f"of {len(by_name)} kinds")
    top = []
    for name, (calls, us) in sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP_KERNELS]:
        row = {"name": name, "calls_per_step": calls / args.steps, "device_ms_per_step": us / 1e3 / args.steps,
               "share": us / busy_us}
        top.append(row)
        print(f"{row['share']:7.1%}  {row['device_ms_per_step']:9.4f} ms/step  {row['calls_per_step']:6.1f} calls/step  "
              f"{name[:100]}")
    ours = []
    for name, (calls, us) in sorted(by_name.items()):
        if any(k in name for k in build.KERNELS):
            ours.append({"name": name, "calls_per_step": calls / args.steps, "device_ms_per_launch": us / 1e3 / calls})
            print(f"hand-written: {ours[-1]['device_ms_per_launch']:.4f} ms per launch, {calls / args.steps:.1f} "
                  f"calls/step  {name[:100]}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "steps": args.steps, **per_step, "top": top,
                      "hand_written": ours}))


if __name__ == "__main__":
    main()
