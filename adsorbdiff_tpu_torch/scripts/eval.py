"""Success-rate evaluation over the pipeline's artifacts (the reference's
``scripts/eval.py`` as a command), on the host.

    python -m adsorbdiff_tpu_torch.scripts.eval trajs   results/0/relaxations [more dirs ...] --targets dft.pkl
    python -m adsorbdiff_tpu_torch.scripts.eval nsite   results/  --targets dft.pkl
    python -m adsorbdiff_tpu_torch.scripts.eval outcars dft_runs/ --targets dft.pkl [--ref-energies ref.pkl]
    python -m adsorbdiff_tpu_torch.scripts.eval npz     preds.npz --traj-root results/ --targets dft.pkl

Modes: ``trajs`` (ML trajectory directories), ``nsite`` (a
``<root>/<seed>/relaxations`` pipeline tree), ``outcars`` (VASP OUTCAR runs
under ``<root>/<sid_fid>/``), ``npz`` (energies from a predictions npz, the
trajectories under ``--traj-root`` for the anomaly filter).  ``--targets``
takes the reference's pkl of ``{sid: [(config, energy), ...]}``, or a flat
``{sid: energy}`` JSON file.  Prints one ``<sid>: success|fail`` line per
system, then ``success rate: <percent>%  (<successes>/<systems>)``.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Tuple

from adsorbdiff_tpu_torch import eval_tools as ev


def load_targets(path: str):
    if path.endswith(".json"):
        with open(path) as f:
            return {str(k): float(v) for k, v in json.load(f).items()}
    return ev.dft_targets_from_pkl(path)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, dict]:
    ap = argparse.ArgumentParser(description="Success rate of relaxed adsorbate placements against DFT minima.")
    ap.add_argument("mode", choices=["trajs", "nsite", "outcars", "npz"])
    ap.add_argument("sources", nargs="+", help="traj dirs / tree root / OUTCAR root / npz path")
    ap.add_argument("--targets", required=True, help="DFT targets pkl (or flat json)")
    ap.add_argument("--traj-root", default=None, help="npz mode: root of traj dirs for anomaly filtering")
    ap.add_argument("--ref-energies", default=None, help="outcars mode: per-sid reference-energy pkl")
    ap.add_argument("--threshold", type=float, default=ev.SUCCESS_THRESHOLD)
    ap.add_argument("--keep-anomalies", action="store_true", help="disable the anomaly filter")
    args = ap.parse_args(argv)

    targets = load_targets(args.targets)
    filt = not args.keep_anomalies
    if args.mode == "trajs":
        rate, per = ev.success_rate(args.sources, targets, filter_anomalies=filt, threshold=args.threshold)
    elif args.mode == "nsite":
        (root,) = args.sources
        rate, per = ev.success_rate_nsite(root, targets, filter_anomalies=filt, threshold=args.threshold)
    elif args.mode == "outcars":
        (root,) = args.sources
        refs = ev.ref_energies_from_pkl(args.ref_energies) if args.ref_energies else None
        rate, per = ev.success_rate_from_outcars(root, targets, ref_energies=refs, threshold=args.threshold)
    else:  # npz
        (npz_path,) = args.sources
        if not args.traj_root:
            ap.error("npz mode needs --traj-root for the anomaly filter")
        dirs = ev.nsite_traj_dirs(args.traj_root) or ev.seed_traj_dirs(args.traj_root) or [args.traj_root]
        rate, per = ev.success_rate_from_npz(npz_path, dirs, targets, filter_anomalies=filt, threshold=args.threshold)

    for sid in sorted(per):
        print(f"{sid}: {'success' if per[sid] else 'fail'}")
    print(f"success rate: {rate * 100:.1f}%  ({sum(per.values())}/{len(per)})")
    return rate, per


if __name__ == "__main__":
    main()
