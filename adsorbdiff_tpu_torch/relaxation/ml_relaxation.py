"""Batch runner for diffusion sampling.

Port of ``DiffusionEngine`` from :mod:`adsorbdiff_tpu.relaxation.ml_relaxation`
plus :func:`make_score_fn`, the score function that
``relaxation/calculator.py`` builds around a PaiNN.  ``RelaxationEngine``,
Langevin sampling and trajectory writing come with later parts of the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.diffusion.sampler import SampleResult, reverse_diffusion


def make_score_fn(model: torch.nn.Module) -> Callable:
    """``score_fn(batch, static_graph=None) -> (tr_score, rot_score)`` for a
    denoising model, with the rotation score zeroed on fixed atoms (the
    reference's denoising_torch.py:496-499).  Runs without autograd."""

    def score_fn(cur: AtomsBatch, static_graph=None):
        with torch.no_grad():
            out = model(cur, static_graph)
        out1, out2 = out if isinstance(out, tuple) else (out, None)
        if out2 is not None:
            out2 = torch.where(cur.fixed[..., None], 0.0, out2)
        return out1, out2

    return score_fn


class DiffusionEngine:
    """Reverse diffusion over batches (the reference's Denoiser + ml_diffuse).

    ``static_fn``: optional ``batch -> static graph`` precomputation (e.g.
    ``model.prepare_static``) run once per trajectory; ``score_fn`` is then
    called as ``score_fn(batch, static)``.  ``device``: where batches run, the
    CUDA card unless ``"cpu"`` is passed (raises without a card).
    """

    def __init__(
        self,
        score_fn: Callable,
        denoising_pos_params: dict,
        sampler: str = "reverse_sde_rot",
        static_fn: Optional[Callable] = None,
        device: DeviceLike = None,
    ) -> None:
        if sampler != "reverse_sde_rot":
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
        self.score_fn = score_fn
        self.params = dict(denoising_pos_params)
        self.static_fn = static_fn
        self.device = resolve_device(device)

    def run(
        self,
        batch: AtomsBatch,
        generator: Optional[torch.Generator] = None,
        traj_dir: Optional[str] = None,
        *,
        frac: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        rot_noise: Optional[torch.Tensor] = None,
    ) -> SampleResult:
        """Sample one batch.  ``frac``/``noise``/``rot_noise`` replace the
        random draws (see :func:`reverse_diffusion`)."""
        if traj_dir:
            raise NotImplementedError("trajectory writing waits for runtime/trajectory.py to be ported")
        with torch.no_grad():
            return reverse_diffusion(
                self.score_fn, batch.to(self.device), self.params,
                generator=generator, with_rotation="rot_std_low" in self.params,
                static_fn=self.static_fn, frac=frac, noise=noise, rot_noise=rot_noise,
            )
