"""Repeated end-to-end readings of the PyTorch port's relaxation and pipeline, on one NVIDIA card.

One process runs, ``--runs`` times each:

- chip_smoke.py's phase 6: GemNet-OC at the gemnet_relax.yml widths (random
  weights, seed 3) relaxing 8 of bench.py's synthetic systems with 100
  batched L-BFGS steps at the published relax_opt with the Verlet graph;
  relax system-steps/s, wall per step and Verlet rebuilds;
- the same relaxation for 10 steps, as scripts/profile_torch_relax.py times
  it with the profiler off (wall per step, rebuilds);
- chip_smoke.py's phase 16: run_pipeline over the 16 bench systems (its
  own printed lines are passed through); total and relax-stage seconds.
  Since PR 17 the phase builds both trainers from configs and checkpoints
  it saves first; a checkout from before takes a seeded generator instead,
  and the script calls whichever form the checkout has.

Host-bound rates move between calls, so every reading is printed, not a
summary.  ``--root`` takes chip_smoke.py and adsorbdiff_tpu_torch from
another checkout (an older commit unpacked with ``git archive``), so two
commits can be compared on one card in one call: run the script once per
checkout, alternating them.

    python scripts/repeat_torch_relax.py [--runs 2] [--root DIR]

The last line is one JSON object with every reading.
"""
import argparse
import contextlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose chip_smoke.py and adsorbdiff_tpu_torch are run (default: this one)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.data.schema import collate
    from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC
    from adsorbdiff_tpu_torch.ops import build, pbc
    from adsorbdiff_tpu_torch.relaxation.ml_relaxation import RelaxationEngine

    if not torch.cuda.is_available():
        raise SystemExit("repeat_torch_relax: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; checkout {root}", flush=True)
    device = smoke.resolve_device(None)  # also switches TF32 off
    build.build()

    systems = smoke.bench_systems(smoke.RELAX_BATCH)
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], smoke.GEMNET_KW["cutoff"])
    batch = collate(systems, max_atoms=80, device=device)
    model = GemNetOC(**smoke.GEMNET_KW, cell_reps=cell_reps, device=device, generator=torch.Generator().manual_seed(3))

    def relax(steps):
        engine = RelaxationEngine.from_model(model, dict(smoke.RELAX_OPT, steps=steps), device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.run(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(steps=res.nsteps, wall_s=wall, system_steps_per_s=res.nsteps * batch.batch_size / wall,
                    ms_per_step=wall * 1e3 / res.nsteps, rebuilds=res.rebuilds)

    relax(2)  # warm-up, as phase 6
    readings = []
    for run in range(args.runs):
        long, short = relax(smoke.RELAX_OPT["steps"]), relax(10)
        out = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(out):
            if "gen" in inspect.signature(smoke.pipeline_path).parameters:  # a checkout from before PR 17
                smoke.pipeline_path(device, torch.Generator().manual_seed(13), smoke.bench_systems(), tmp)
            else:
                smoke.pipeline_path(device, smoke.bench_systems(), tmp)
        stages = re.search(r"wall per stage \(s\): (.*)", out.getvalue()).group(1)
        pipeline = {k: float(v) for k, v in (item.split() for item in stages.split(", "))}
        readings.append(dict(relax_100=long, relax_10=short, pipeline_s=pipeline))
        print(f"[run {run}] relax {long['steps']} steps: {long['system_steps_per_s']:.2f} relax system-steps/s, "
              f"{long['ms_per_step']:.3f} ms a step, {long['rebuilds']} Verlet rebuilds; relax {short['steps']} "
              f"steps: {short['ms_per_step']:.3f} ms a step, {short['rebuilds']} rebuilds; pipeline total "
              f"{pipeline['total']:.3f} s, relax stage {pipeline['relax']:.3f} s", flush=True)
        for line in out.getvalue().splitlines():
            if line.startswith("[pipeline] wall") or line.startswith("[pipeline] relaxation"):
                print(f"[run {run}] {line}", flush=True)
    print(json.dumps({"device": smi, "root": root, "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
