"""Metric evaluator with running {total, numel, metric} accumulation.

The port's own copy of :mod:`adsorbdiff_tpu.train.evaluator` (host-side
numpy, the same task -> metric tables), so that the port imports nothing of
the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def min_diff(pred_pos: np.ndarray, dft_pos: np.ndarray, cell: np.ndarray, pbc=(True, True, True)) -> np.ndarray:
    """PBC minimum-image displacement (ref: evaluator.py:266-283)."""
    pos_diff = pred_pos - dft_pos
    fractional = np.linalg.solve(cell.T, pos_diff.T).T
    for i, periodic in enumerate(pbc):
        if periodic:
            fractional[:, i] %= 1.0
            fractional[:, i] %= 1.0
    fractional[fractional > 0.5] -= 1
    return np.matmul(fractional, cell)


def _result(total: float, numel: float) -> Dict[str, float]:
    return {"metric": total / max(numel, 1e-12), "total": float(total), "numel": float(numel)}


def mae(prediction, target, key):
    err = np.abs(np.asarray(target[key]) - np.asarray(prediction[key]))
    return _result(err.sum(), err.size)


def mse(prediction, target, key):
    err = (np.asarray(target[key]) - np.asarray(prediction[key])) ** 2
    return _result(err.sum(), err.size)


def cosine_similarity(prediction, target, key):
    p, t = np.asarray(prediction[key]), np.asarray(target[key])
    num = (p * t).sum(-1)
    den = np.linalg.norm(p, axis=-1) * np.linalg.norm(t, axis=-1) + 1e-8
    sim = num / den
    return _result(sim.sum(), sim.size)


def magnitude_error(prediction, target, key, p: int = 2):
    err = np.abs(
        np.linalg.norm(np.asarray(prediction[key]), ord=p, axis=-1)
        - np.linalg.norm(np.asarray(target[key]), ord=p, axis=-1)
    )
    return _result(err.sum(), err.size)


def forcesx_mae(prediction, target, key=None):
    err = np.abs(np.asarray(target["forces"])[:, 0] - np.asarray(prediction["forces"])[:, 0])
    return _result(err.sum(), err.size)


def forcesy_mae(prediction, target, key=None):
    err = np.abs(np.asarray(target["forces"])[:, 1] - np.asarray(prediction["forces"])[:, 1])
    return _result(err.sum(), err.size)


def forcesz_mae(prediction, target, key=None):
    err = np.abs(np.asarray(target["forces"])[:, 2] - np.asarray(prediction["forces"])[:, 2])
    return _result(err.sum(), err.size)


def energy_within_threshold(prediction, target, key=None):
    """Systems with |dE| < 0.02 eV (ref: evaluator.py:210-227)."""
    err = np.abs(np.asarray(target["energy"]) - np.asarray(prediction["energy"]))
    return _result((err < 0.02).sum(), err.size)


def energy_forces_within_threshold(prediction, target, key=None):
    """Systems with |dE| < 0.02 and max per-atom |dF| < 0.03 (ref: :173-207)."""
    natoms = np.asarray(target["natoms"])
    ef = np.abs(np.asarray(target["forces"]) - np.asarray(prediction["forces"]))
    ee = np.abs(np.asarray(target["energy"]) - np.asarray(prediction["energy"]))
    success, start = 0, 0
    for i, n in enumerate(natoms):
        n = int(n)
        if ee[i] < 0.02 and (ef[start : start + n].max() if n else np.inf) < 0.03:
            success += 1
        start += n
    return _result(success, len(natoms))


def average_distance_within_threshold(prediction, target, key=None):
    """IS2RS ADwT over thresholds 0.01..0.5 (ref: evaluator.py:230-263)."""
    natoms = np.asarray(target["natoms"]).astype(int)
    pred = np.asarray(prediction["positions"])
    tgt = np.asarray(target["positions"])
    cells = np.asarray(target["cell"])
    pbc = tuple(bool(x) for x in np.asarray(target.get("pbc", (True, True, True))))
    mean_distance = []
    start = 0
    for i, n in enumerate(natoms):
        d = min_diff(pred[start : start + n], tgt[start : start + n], cells[i], pbc)
        mean_distance.append(np.mean(np.linalg.norm(d, axis=1)))
        start += n
    intv = np.arange(0.01, 0.5, 0.001)
    success = sum(int((np.asarray(mean_distance) < t).sum()) for t in intv)
    total = len(mean_distance) * len(intv)
    return _result(success, total)


METRIC_FNS = {
    "mae": mae,
    "mse": mse,
    "cosine_similarity": cosine_similarity,
    "magnitude_error": magnitude_error,
    "forcesx_mae": forcesx_mae,
    "forcesy_mae": forcesy_mae,
    "forcesz_mae": forcesz_mae,
    "energy_within_threshold": energy_within_threshold,
    "energy_forces_within_threshold": energy_forces_within_threshold,
    "average_distance_within_threshold": average_distance_within_threshold,
}


class Evaluator:
    """ref: modules/evaluator.py:33-122 (task tables + running accumulation)."""

    task_metrics = {
        "s2ef": {
            "energy": ["mae"],
            "forces": [
                "forcesx_mae",
                "forcesy_mae",
                "forcesz_mae",
                "mae",
                "cosine_similarity",
                "magnitude_error",
                "energy_forces_within_threshold",
            ],
        },
        "is2rs": {"positions": ["average_distance_within_threshold", "mae", "mse"]},
        "is2re": {"energy": ["mae", "mse", "energy_within_threshold"]},
    }

    task_primary_metric = {
        "s2ef": "energy_forces_within_threshold",
        "is2rs": "positions_average_distance_within_threshold",
        "is2re": "energy_mae",
        "ocp": None,
    }

    def __init__(self, task: Optional[str] = None, eval_metrics: Optional[dict] = None) -> None:
        self.task = task
        self.target_metrics = eval_metrics if eval_metrics else self.task_metrics.get(task, {})

    def eval(self, prediction: dict, target: dict, prev_metrics: Optional[dict] = None) -> dict:
        metrics = prev_metrics or {}
        for prop, fns in self.target_metrics.items():
            for fn in fns:
                name = f"{prop}_{fn}" if prop not in fn and prop != "misc" else fn
                res = METRIC_FNS[fn](prediction, target, prop)
                metrics = self.update(name, res, metrics)
        return metrics

    def update(self, key: str, stat, metrics: dict) -> dict:
        if key not in metrics:
            metrics[key] = {"metric": None, "total": 0.0, "numel": 0.0}
        if isinstance(stat, dict):
            metrics[key]["total"] += stat["total"]
            metrics[key]["numel"] += stat["numel"]
        elif isinstance(stat, (float, int)):
            metrics[key]["total"] += stat
            metrics[key]["numel"] += 1
        else:
            raise NotImplementedError(f"stat type {type(stat)}")
        metrics[key]["metric"] = metrics[key]["total"] / max(metrics[key]["numel"], 1e-12)
        return metrics
