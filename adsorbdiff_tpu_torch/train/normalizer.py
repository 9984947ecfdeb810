"""Target normalizer (port of :mod:`adsorbdiff_tpu.train.normalizer`)."""
from __future__ import annotations

from typing import Optional

import numpy as np


class Normalizer:
    def __init__(self, mean: float = 0.0, std: float = 1.0, tensor: Optional[np.ndarray] = None) -> None:
        if tensor is not None:
            mean, std = float(np.mean(tensor)), float(np.std(tensor))
        self.mean = float(mean)
        self.std = float(std)

    def norm(self, x):
        return (x - self.mean) / self.std

    def denorm(self, x):
        return x * self.std + self.mean

    def state_dict(self) -> dict:
        return {"mean": self.mean, "std": self.std}

    def load_state_dict(self, d: dict) -> None:
        self.mean = float(d["mean"])
        self.std = float(d["std"])
