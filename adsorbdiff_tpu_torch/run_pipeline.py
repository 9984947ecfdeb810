"""Command line of the whole pipeline: sample -> convert -> MLFF relax ->
success rate, from two configs and their checkpoints (port of
``scripts/run_pipeline.py``).

    python -m adsorbdiff_tpu_torch.run_pipeline \
        --diffusion-config configs/denoising/painn_so3.yml --diffusion-ckpt <ckpt> \
        --relax-config configs/relaxation/gemnet_oc/gemnet_relax.yml --relax-ckpt <ckpt> \
        --relax-dataset data/valood_placements --out-dir results/pipeline \
        --nsites 5 [--dft-targets targets.pkl]

The diffusion config builds a :class:`~adsorbdiff_tpu_torch.train.trainer.
DenoisingTrainer` and the relax config (``trainer: forces``) an
:class:`~adsorbdiff_tpu_torch.train.trainer.S2EFTrainer`, each through the
trainer context with its checkpoint loaded.  Both run on the CUDA card unless
their configs set ``cpu: true``.  The relax engine is picked by
``relax_opt.continuous: auto`` (no ``relax_opt`` is passed, as in the JAX
command line).
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from adsorbdiff_tpu_torch.common.config import load_config
from adsorbdiff_tpu_torch.common.logging_utils import setup_logging
from adsorbdiff_tpu_torch.eval_tools import dft_targets_from_pkl
from adsorbdiff_tpu_torch.pipeline import run_pipeline
from adsorbdiff_tpu_torch.tasks import new_trainer_context
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer, S2EFTrainer

_ROLES = {"denoising": DenoisingTrainer, "s2ef": S2EFTrainer}


def build_trainer(config_path: str, ckpt: str, mode: str):
    """The trainer of ``config_path`` with ``ckpt`` loaded (``mode``
    ``run-relaxations`` unless the config names one; ``is_debug``, so no
    experiment logger).  ``mode`` is the trainer's role in the pipeline,
    ``"denoising"`` (the sampler) or ``"s2ef"`` (the relaxer); a config whose
    trainer has another class raises."""
    config, _, _ = load_config(config_path)
    config.setdefault("mode", "run-relaxations")
    config["checkpoint"] = ckpt
    config["is_debug"] = True
    with new_trainer_context(config) as ctx:
        trainer = ctx.trainer
    if not isinstance(trainer, _ROLES[mode]):
        raise ValueError(f"{config_path} builds a {type(trainer).__name__}; the pipeline's {mode} trainer must be a "
                         f"{_ROLES[mode].__name__}")
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> Optional[float]:
    """Run the pipeline; returns the success rate (None without
    ``--dft-targets``), which it also logs."""
    setup_logging()
    ap = argparse.ArgumentParser(prog="python -m adsorbdiff_tpu_torch.run_pipeline")
    ap.add_argument("--diffusion-config", required=True)
    ap.add_argument("--diffusion-ckpt", required=True)
    ap.add_argument("--relax-config", required=True)
    ap.add_argument("--relax-ckpt", required=True)
    ap.add_argument("--relax-dataset", required=True, help="placements shard (src)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--nsites", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--atom-budget", type=int, default=None,
                    help="atom-balanced batching: per-bucket batch size min(batch size, budget // padded atoms)")
    ap.add_argument("--relaxation-steps", type=int, default=300)
    ap.add_argument("--dft-targets", default=None, help="pkl of {sid: [(cfg, E), ...]}")
    args = ap.parse_args(argv)

    diffusion_trainer = build_trainer(args.diffusion_config, args.diffusion_ckpt, "denoising")
    relax_trainer = build_trainer(args.relax_config, args.relax_ckpt, "s2ef")
    dft_targets = dft_targets_from_pkl(args.dft_targets) if args.dft_targets else None
    rate = run_pipeline(
        diffusion_trainer,
        relax_trainer,
        {"src": args.relax_dataset},
        args.out_dir,
        nsites=args.nsites,
        relaxation_steps=args.relaxation_steps,
        dft_targets=dft_targets,
        batch_size=args.batch_size,
        atom_budget=args.atom_budget,
    )
    if rate is not None:
        logging.info(f"Success rate: {rate * 100:.1f}%")
    return rate


if __name__ == "__main__":
    main()
