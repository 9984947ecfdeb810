"""Repeated readings of the PyTorch port's PaiNN forward kernel, sampling and training, on one NVIDIA card.

One process takes, ``--runs`` times each:

- painn_message_fused per launch (CUDA events over 2000 launches after
  warm-up, with the SM clock nvidia-smi reads meanwhile) at the sampling
  shape (16, 80, 50, 128, 512) on the sampling path's neighbour
  table (chip_smoke.py's bench systems, cutoff 12 A, cell_reps (2, 2, 0)),
  and at (48, 80, 50, 128, 512) on the same table of 48 bench systems;
  random features and weights from a seeded generator;
- chip_smoke.py's phase 4: PaiNN at the painn_so3.yml widths (random
  weights, seed 0) drives 100 ODE reverse-diffusion steps at B=16;
  system-steps/s;
- chip_smoke.py's phase 8b: one DenoisingTrainer.train() epoch of 31 steps
  at B=48 (painn_so3.yml + base.yml) on bench systems written to shards in a
  temporary directory; systems/s over the 30 steps after the first.

Host-bound rates move between processes, so every reading is printed, not
a summary.  ``--root`` takes chip_smoke.py and adsorbdiff_tpu_torch from
another checkout (an older commit unpacked with ``git archive``), so two
commits can be compared on one card in one call: run the script once per
checkout, alternating them.

    python scripts/repeat_torch_painn.py [--runs 1] [--root DIR]

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
import time


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
    from adsorbdiff_tpu_torch.data.schema import collate
    from adsorbdiff_tpu_torch.models.base import generate_graph
    from adsorbdiff_tpu_torch.models.painn import PaiNN
    from adsorbdiff_tpu_torch.ops import build, kernels
    from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, make_score_fn
    from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer

    if not torch.cuda.is_available():
        raise SystemExit("repeat_torch_painn: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; checkout {root}", flush=True)
    device = smoke.resolve_device(None)  # also switches TF32 off
    build.build(["painn_message_fused", "painn_message_fused_bwd"])

    gen = torch.Generator().manual_seed(0)
    model = PaiNN(**smoke.MODEL_KW, device=device, generator=gen)
    shapes = {}
    for b in (16, 48):
        batch = collate(smoke.bench_systems(b), max_atoms=80, device=device)
        nl, _, unit = generate_graph(batch, cutoff=model.cutoff, max_neighbors=model.max_neighbors,
                                     cell_reps=model.cell_reps)
        shape = (b, 80, model.max_neighbors, 128, model.hidden_channels)
        shapes[b] = smoke.message_inputs(torch.Generator().manual_seed(b), device, *shape, model.cutoff, nl=nl,
                                         unit=unit)
    batch = collate(smoke.bench_systems(), max_atoms=80, device=device)

    def kernel_ms(b):
        """Per launch, CUDA events over 2000 launches, with the card's SM clock
        (nvidia-smi every 50 ms while they run; the median sample)."""
        inputs = shapes[b]
        smi_clock = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                                      "-lms", "50"], stdout=subprocess.PIPE, text=True)
        ms = smoke.cuda_ms(lambda: kernels.painn_message_fused(**inputs, cutoff=model.cutoff), 2000)
        smi_clock.terminate()
        samples = sorted(int(x) for x in smi_clock.communicate()[0].split())
        return ms, samples[len(samples) // 2] if samples else None

    def sample():
        engine = DiffusionEngine(make_score_fn(model), smoke.PARAMS, static_fn=model.prepare_static, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(batch, generator=torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
        return smoke.PARAMS["num_steps"] * batch.batch_size / (time.perf_counter() - t0)

    def train():
        with tempfile.TemporaryDirectory() as tmp:
            paths = smoke.write_training_shards(tmp, {"train": smoke.TRAIN_BATCH * smoke.TRAIN_STEPS,
                                                      "val": smoke.TRAIN_BATCH})
            config = dict(copy.deepcopy(smoke.TRAIN_CONFIG), run_dir=tmp,
                          dataset=[{"src": paths["train"]}, {"src": paths["val"]}])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                trainer = DenoisingTrainer(config, device=device)
                layers = trainer.model.num_layers
                smoke.train_one_epoch(trainer, smoke.TRAIN_STEPS, {"painn_message_fused": layers,
                                                                   "painn_message_fused_bwd": layers})
        return float(re.search(r"([0-9.]+) systems/s", out.getvalue()).group(1))

    DiffusionEngine(make_score_fn(model), dict(smoke.PARAMS, num_steps=2), static_fn=model.prepare_static,
                    device=device).run(batch, generator=torch.Generator(device=device).manual_seed(2))  # warm-up
    readings = []
    for run in range(args.runs):
        (ms16, clock16), (ms48, clock48) = kernel_ms(16), kernel_ms(48)
        reading = dict(kernel_ms_b16=ms16, kernel_ms_b48=ms48, sm_clock_mhz=(clock16, clock48),
                       sampling_system_steps_per_s=sample(), training_systems_per_s=train())
        readings.append(reading)
        print(f"[run {run}] painn_message_fused {ms16:.4f} ms at B=16, {ms48:.4f} ms at B=48 (SM clock {clock16} and "
              f"{clock48} MHz); sampling {reading['sampling_system_steps_per_s']:.2f} system-steps/s; training "
              f"{reading['training_systems_per_s']:.2f} systems/s", flush=True)
    print(json.dumps({"device": smi, "root": root, "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
