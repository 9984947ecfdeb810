"""Convert a reference AdsorbDiff/OCP torch checkpoint into the port's
checkpoint format.

    python -m adsorbdiff_tpu_torch.scripts.convert_checkpoint PT_zeroshot_painn.pt out_dir/
    python -m adsorbdiff_tpu_torch.scripts.convert_checkpoint ckpt.pt out_dir/ --name mlff \\
        --override cutoff=12.0 --override max_neighbors=30

Reads the ``.pt``'s embedded model config, maps the weights for the port's
model of that family (PaiNN, GemNet-OC, EquiformerV2;
:mod:`adsorbdiff_tpu_torch.train.torch_import`), and writes ``out_dir/<name>``
and its ``<name>.config.yaml`` (the model section), which the trainers load:
``--checkpoint out_dir/<name>`` with a config whose ``model`` block is that
section.  ``--override key=value`` sets a model-config entry (a Python
literal, else a string).  The conversion runs on the host: ``--cpu`` is
accepted and changes nothing.
"""
from __future__ import annotations

import argparse
import ast
from typing import Optional, Sequence

from adsorbdiff_tpu_torch.common.logging_utils import setup_logging
from adsorbdiff_tpu_torch.train.torch_import import convert_torch_checkpoint


def parse_overrides(pairs: Sequence[str]) -> dict:
    """``key=value`` strings -> a dict, each value a Python literal where it
    parses as one."""
    out = {}
    for kv in pairs:
        key, value = kv.split("=", 1)
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description="Convert a reference torch checkpoint to the port's format.")
    ap.add_argument("torch_checkpoint")
    ap.add_argument("out_dir")
    ap.add_argument("--name", default="checkpoint")
    ap.add_argument("--override", action="append", default=[], help="model-config override key=value (repeatable)")
    ap.add_argument("--cpu", action="store_true", help="accepted for compatibility; the conversion always runs on "
                                                        "the host")
    args = ap.parse_args(argv)
    setup_logging()
    path = convert_torch_checkpoint(args.torch_checkpoint, args.out_dir, name=args.name,
                                    model_cfg_override=parse_overrides(args.override) or None)
    print(f"wrote {path} (+ {path}.config.yaml)")
    return path


if __name__ == "__main__":
    main()
