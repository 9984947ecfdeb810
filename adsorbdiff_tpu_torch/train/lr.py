"""Learning-rate schedules, as functions of the optimiser's step count.

Port of :mod:`adsorbdiff_tpu.train.lr`: linear warm-up from
``warmup_factor`` to 1 over ``warmup_epochs`` (in steps), then cosine decay
to ``lr_min_factor`` at ``epochs`` steps, or multistep decay; all scaled by
``lr_initial``.  A schedule takes a Python number or a tensor (the
trainer's on-device count) and computes in float32, as the JAX version does.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_lr(lr_initial: float, warmup_steps: int, max_steps: int, warmup_factor: float,
              lr_min_factor: float) -> Callable:
    def schedule(step):
        step = _f32(step)
        alpha = step / max(float(warmup_steps), 1.0)
        warm = warmup_factor * (1.0 - alpha) + alpha
        cos = lr_min_factor + 0.5 * (1 - lr_min_factor) * (1 + torch.cos(math.pi * (step / float(max_steps))))
        floor = torch.full_like(step, lr_min_factor)
        scale = torch.where(step <= warmup_steps, warm, torch.where(step >= max_steps, floor, cos))
        return lr_initial * scale

    return schedule


def multistep_lr(lr_initial: float, warmup_steps: int, warmup_factor: float, decay_steps: Sequence[int],
                 decay_rate: float) -> Callable:
    decay = sorted(float(s) for s in decay_steps)

    def schedule(step):
        step = _f32(step)
        alpha = step / max(float(warmup_steps), 1.0)
        warm = warmup_factor * (1.0 - alpha) + alpha
        idx = sum((step > d).to(torch.float32) for d in decay)
        return lr_initial * torch.where(step <= warmup_steps, warm, decay_rate**idx)

    return schedule


def build_lr_schedule(optim_config: dict, n_iter_per_epoch: int) -> Callable:
    """From the config's ``optim`` block; every ``scheduler_params`` key
    naming epochs is multiplied by the steps per epoch."""
    lr_initial = float(optim_config["lr_initial"])
    params = dict(optim_config.get("scheduler_params", {}) or {})
    name = optim_config.get("scheduler", "LambdaLR")

    def steps(key, default):
        v = params.get(key, default)
        if isinstance(v, list):
            return [int(x * n_iter_per_epoch) for x in v]
        return int(v * n_iter_per_epoch)

    if name == "LambdaLR":
        lambda_type = params.get("lambda_type", "cosine")
        if lambda_type == "cosine":
            return cosine_lr(
                lr_initial,
                warmup_steps=steps("warmup_epochs", 1),
                max_steps=steps("epochs", optim_config.get("max_epochs", 1)),
                warmup_factor=float(params.get("warmup_factor", 0.2)),
                lr_min_factor=float(params.get("lr_min_factor", 0.01)),
            )
        if lambda_type == "multistep":
            return multistep_lr(
                lr_initial,
                warmup_steps=steps("warmup_epochs", 1),
                warmup_factor=float(params.get("warmup_factor", 0.2)),
                decay_steps=steps("decay_epochs", [1]),
                decay_rate=float(params.get("decay_rate", 0.1)),
            )
        raise ValueError(f"unknown lambda_type {lambda_type}")
    if name == "constant":
        return lambda step: lr_initial * torch.ones_like(_f32(step))
    raise ValueError(f"unknown scheduler {name}")
