"""Batch runners for diffusion sampling and MLFF relaxation.

Port of ``DiffusionEngine`` and ``RelaxationEngine`` from
:mod:`adsorbdiff_tpu.relaxation.ml_relaxation`, plus :func:`make_score_fn`,
the score function that ``relaxation/calculator.py`` builds around a PaiNN.
Langevin sampling and trajectory writing (``runtime/trajectory.py`` and the
background writer) come with later parts of the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.diffusion.sampler import SampleResult, reverse_diffusion
from adsorbdiff_tpu_torch.relaxation.lbfgs import LBFGSResult, lbfgs_relax, make_mlff_energy_forces


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


class RelaxationEngine:
    """Batched L-BFGS over batches (the reference's ml_relax).

    ``relax_opt`` keys (defaults in brackets): ``steps`` [``steps``], ``fmax``
    [``fmax``], ``maxstep`` [0.04], ``memory`` [50], ``damping`` [1.0],
    ``alpha`` [70.0], ``early_exit`` [True].  ``device``: where batches run,
    the CUDA card unless ``"cpu"`` is passed (raises without a card).
    """

    def __init__(
        self,
        energy_forces_fn: Callable,
        relax_opt: Optional[dict] = None,
        steps: int = 300,
        fmax: float = 0.01,
        candidate_fn: Optional[Callable] = None,
        device: DeviceLike = None,
    ) -> None:
        opt = dict(relax_opt or {})
        self.kwargs = dict(
            steps=int(opt.get("steps", steps)),
            fmax=float(opt.get("fmax", fmax)),
            maxstep=float(opt.get("maxstep", 0.04)),
            memory=int(opt.get("memory", 50)),
            damping=float(opt.get("damping", 1.0)),
            alpha=float(opt.get("alpha", 70.0)),
            early_exit=bool(opt.get("early_exit", True)),
        )
        self.energy_forces_fn = energy_forces_fn
        self.candidate_fn = candidate_fn
        self.device = resolve_device(device)

    @classmethod
    def from_model(cls, model: torch.nn.Module, relax_opt: Optional[dict] = None, **kw) -> "RelaxationEngine":
        """``relax_opt["verlet_graph"]`` (default True) keeps the neighbour
        tables as Verlet candidate lists (``model.prepare_candidates``)
        refreshed every step and rebuilt once the displacement margin is
        spent; ``relax_opt["k_cand"]`` (default 64) sizes the candidate pool."""
        opt = dict(relax_opt or {})
        candidate_fn = None
        if bool(opt.get("verlet_graph", True)) and hasattr(model, "prepare_candidates"):
            k_cand = int(opt.get("k_cand", 64))
            candidate_fn = lambda b: model.prepare_candidates(b, k_cand)  # noqa: E731
        return cls(make_mlff_energy_forces(model), relax_opt, candidate_fn=candidate_fn, **kw)

    def run(self, batch: AtomsBatch, traj_dir: Optional[str] = None) -> LBFGSResult:
        if traj_dir:
            raise NotImplementedError("trajectory writing waits for runtime/trajectory.py to be ported")
        with torch.no_grad():
            return lbfgs_relax(self.energy_forces_fn, batch.to(self.device), candidate_fn=self.candidate_fn,
                               **self.kwargs)
