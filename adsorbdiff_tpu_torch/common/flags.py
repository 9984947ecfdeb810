"""CLI flags (port of :mod:`adsorbdiff_tpu.common.flags`).

The port runs on one CUDA card, or on the host with ``--cpu``; multi-GPU
runs and cluster submission are not ported yet.
"""
from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="adsorbdiff_tpu_torch")
    parser.add_argument(
        "--mode", choices=["train", "validate"], required=True,
        help="Train the model, or validate a checkpoint",
    )
    parser.add_argument("--config-yml", required=True, type=str,
                        help="Path to a config file listing data, model, optim parameters.")
    parser.add_argument("--identifier", default="", type=str,
                        help="Experiment identifier to append to checkpoint/log/result directory")
    parser.add_argument("--debug", action="store_true", help="Debugging run: no experiment logger")
    parser.add_argument("--run-dir", default="./", type=str, help="Directory to store checkpoint/log/result directory")
    parser.add_argument("--print-every", default=100, type=int, help="Log every N iterations")
    parser.add_argument("--seed", default=0, type=int, help="Seed of the run's torch.Generator")
    parser.add_argument("--amp", action="store_true", help="Mixed precision (not ported yet: raises)")
    parser.add_argument("--checkpoint", default=None, type=str, help="Checkpoint to load")
    parser.add_argument("--cpu", action="store_true", help="Run on the host instead of the CUDA card")
    return parser
