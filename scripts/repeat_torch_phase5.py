"""How often the first CPU forward of a process parts from the next ones
(chip_smoke.py phase 5, ROADMAP C.1), on one NVIDIA card.

Runs chip_smoke.py's phases 1-5 (the kernel build, the PaiNN sampling path
and the card-vs-CPU check at B=2, whose CPU forward runs three times on
equal inputs) in ``--runs`` fresh processes, one after another, and prints
for each run its exit code and phase 5's lines; a run in which a CPU forward
parts from the others prints a ``[host]`` line naming the forward and its
first differing record.

    python scripts/repeat_torch_phase5.py [--runs 20]

The last line is one JSON object: the runs, how many exited non-zero, and
for each run with a parting forward its number and its ``[host]`` and
"CPU forward" lines.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES_1_TO_5 = (
    "import sys, torch; sys.path.insert(0, {root!r}); import chip_smoke as cs; "
    "from adsorbdiff_tpu_torch.device import resolve_device; from adsorbdiff_tpu_torch.ops import build; "
    "device = resolve_device(None); build.build(); "
    "cs.sampling_path(device, torch.Generator().manual_seed(0), cs.bench_systems())"
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    code = PHASES_1_TO_5.format(root=ROOT)
    failed, parted = 0, []
    t0 = time.perf_counter()
    for i in range(args.runs):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
        lines = [line for line in r.stdout.splitlines()
                 if "CPU forward" in line or "card vs CPU PaiNN" in line or "max |card|" in line]
        print(f"run {i}: exit {r.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        print("\n".join(lines), flush=True)
        if r.returncode:
            failed += 1
            print(r.stderr[-2000:], flush=True)
        if any(line.startswith("[host]") for line in lines):
            parted.append(dict(run=i, lines=[line for line in lines if "CPU forward" in line]))
    print(json.dumps(dict(runs=args.runs, failed=failed, parted=parted)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
