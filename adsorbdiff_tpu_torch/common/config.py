"""Config system: YAML with recursive ``includes``, duplicate detection and
dotted-key CLI overrides.

Port of :mod:`adsorbdiff_tpu.common.config`.  Overrides are parsed with
``ast.literal_eval`` (``--optim.lr_initial=1e-4`` is a float), falling back to
strings.  ``yaml`` is imported only where a file is read, so a trainer built
from a dict runs without PyYAML.
"""
from __future__ import annotations

import ast
import logging
import os
from typing import Any, Dict, List, Sequence, Tuple


def merge_dicts(dict1: dict, dict2: dict) -> Tuple[dict, List[str]]:
    """Recursively merge ``dict2`` into ``dict1`` (dict2 wins).

    Returns the merged dict and the list of dotted keys where dict2
    overwrote dict1 (the reference logs duplicate warnings,
    ref: utils.py:376-415 & :872-911).  A dict whose keys are all indices
    merges into a list element by element, so ``--dataset.0.src=path``
    overrides the first dataset entry.
    """
    if not isinstance(dict1, dict) or not isinstance(dict2, dict):
        raise ValueError("merge_dicts expects two dicts")

    duplicates: List[str] = []

    def _merge(a: dict, b: dict, prefix: str) -> dict:
        out = dict(a)
        for k, v in b.items():
            dotted = f"{prefix}{k}"
            if k in a and isinstance(a[k], dict) and isinstance(v, dict):
                out[k] = _merge(a[k], v, dotted + ".")
            elif k in a and isinstance(a[k], list) and isinstance(v, dict) and all(str(i).isdigit() for i in v):
                out[k] = _merge_list(a[k], v, dotted + ".")
            else:
                if k in a:
                    duplicates.append(dotted)
                out[k] = v
        return out

    def _merge_list(a: list, b: dict, prefix: str) -> list:
        """Index-keyed overrides into a list (``--dataset.0.src=...``)."""
        out = list(a)
        for idx, v in b.items():
            i = int(idx)
            out.extend({} for _ in range(i + 1 - len(out)))
            if isinstance(out[i], dict) and isinstance(v, dict):
                out[i] = _merge(out[i], v, f"{prefix}{i}.")
            else:
                duplicates.append(f"{prefix}{i}")
                out[i] = v
        return out

    return _merge(dict1, dict2, ""), duplicates


def load_config(path: str, files_previously_included: Sequence[str] = ()):
    """Load a YAML config, recursively resolving its ``includes`` list.

    Include cycles raise; later files win over earlier includes; the main
    file wins over all includes (reference semantics, ref: utils.py:376-415).
    Returns ``(config, duplicates_warning, duplicates_error)``: a key that two
    includes both set is an error, a key of the main file that overrides an
    include a warning, as in the reference.  (The JAX package files the
    latter as an error too, so its ``build_config`` refuses
    ``configs/denoising/eqv2_so3.yml``, whose ``optim`` overrides base.yml's.)
    """
    import yaml

    path = os.path.abspath(path)
    if path in files_previously_included:
        raise ValueError(f"Cyclic config include detected: {path}")
    seen = list(files_previously_included) + [path]

    with open(path) as f:
        direct = yaml.safe_load(f) or {}

    includes = direct.pop("includes", [])
    if not isinstance(includes, list):
        raise AttributeError(f"Includes must be a list, '{type(includes)}' provided")

    config: Dict[str, Any] = {}
    dup_warn: List[str] = []
    dup_err: List[str] = []
    base_dir = os.path.dirname(path)
    for inc in includes:
        inc_path = inc if os.path.isabs(inc) else os.path.join(base_dir, inc)
        inc_cfg, w, e = load_config(inc_path, seen)
        config, dups = merge_dicts(config, inc_cfg)
        dup_warn += w
        dup_err += e + dups

    config, dups = merge_dicts(config, direct)
    dup_warn += dups
    return config, dup_warn, dup_err


def create_dict_from_args(args: Sequence[str], sep: str = ".") -> dict:
    """Turn ``["optim.lr_initial=1e-4", "model.num_layers=4"]`` into a nested
    dict; values go through ``ast.literal_eval`` with string fallback
    (ref: utils.py:361-373)."""
    out: Dict[str, Any] = {}
    for arg in args:
        arg = arg.strip("--")
        if "=" in arg:
            keys_str, value_str = arg.split("=", 1)
            try:
                value = ast.literal_eval(value_str)
            except (ValueError, SyntaxError):
                value = value_str
        else:
            keys_str, value = arg, True
        node = out
        keys = keys_str.split(sep)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return out


def build_config(args, args_override: Sequence[str] = ()) -> dict:
    """Assemble the run config from parsed CLI flags + dotted overrides
    (ref: utils.py:418-458). ``args`` is any object with the attributes set
    by :mod:`adsorbdiff_tpu_torch.common.flags`."""
    config, dup_warning, dup_error = load_config(args.config_yml)
    if len(dup_warning) > 0:
        logging.warning(f"Overwritten config parameters from included configs: {dup_warning}")
    if len(dup_error) > 0:
        raise ValueError(f"Conflicting (duplicate) parameters in simultaneously included configs: {dup_error}")

    if args_override:
        overrides = create_dict_from_args(args_override)
        config, _ = merge_dicts(config, overrides)

    config["mode"] = args.mode
    config["identifier"] = args.identifier
    config["seed"] = args.seed
    config["is_debug"] = getattr(args, "debug", False)
    config["run_dir"] = getattr(args, "run_dir", "./")
    config["print_every"] = getattr(args, "print_every", 100)
    config["amp"] = getattr(args, "amp", False)
    config["checkpoint"] = getattr(args, "checkpoint", None)
    config["cpu"] = getattr(args, "cpu", False)
    return config

