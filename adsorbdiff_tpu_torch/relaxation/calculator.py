"""AdsorbDiffCalculator — the one-system / notebook API.

Port of :mod:`adsorbdiff_tpu.relaxation.calculator`, the reference's single
public top-level symbol (ref: adsorbdiff/relaxation/calculator.py:23-210,
exported at adsorbdiff/__init__.py:8): construct from checkpoints, then

- ``run_diffusion(atoms)`` — reverse diffusion for one system
  (ref: calculator.py:180-210),
- ``calculate(atoms)`` — energy/forces from the MLFF model, usable as an ASE
  calculator when ase is installed (ref: calculator.py:166-178),
- ``relax(atoms)`` — L-BFGS relaxation of one system.

Checkpoints are the port's single file (:mod:`adsorbdiff_tpu_torch.train.
checkpoint`), whose ``config`` holds the ``model`` section (JAX reads an orbax
directory and a sidecar ``<path>.config.yaml``).  The model is built from
that section and loads the file's ``ema_params`` and ``scale_factors``,
never its ``params``.  A reference ``.pt`` converts first (``python -m
adsorbdiff_tpu_torch.scripts.convert_checkpoint``).  Everything runs on
``device``: the CUDA card unless the caller passes ``"cpu"``; without a card
the constructor raises.  ``run_diffusion`` draws from a ``torch.Generator``
seeded with ``seed`` where JAX takes ``PRNGKey(seed)``, so the sampled
placements differ between the packages by design.
"""
from __future__ import annotations

from typing import Optional

import torch

from adsorbdiff_tpu_torch.common.compile_cache import setup_compilation_cache
from adsorbdiff_tpu_torch.data.schema import AtomsBatch, collate
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.relaxation.lbfgs import make_mlff_energy_forces
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, make_score_fn
from adsorbdiff_tpu_torch.runtime.atoms import Atoms, atoms_to_system, batch_to_atoms

DEFAULT_DENOISING_PARAMS = {
    # published sampling config (ref: configs/denoising/painn_so3.yml:79-83)
    "num_steps": 100,
    "ads_std_low": 0.1,
    "ads_std_high": 10.0,
    "rot_std_low": 0.01,
    "rot_std_high": 1.55,
    "ode": True,
}


def load_model(checkpoint_path: str, device: torch.device, *, sampling: bool,
               mode: Optional[str] = None) -> torch.nn.Module:
    """The model of a port checkpoint in eval mode on ``device``, with the
    checkpoint's EMA weights and scale factors."""
    from adsorbdiff_tpu_torch.train import checkpoint as ckpt
    from adsorbdiff_tpu_torch.train.trainer import _model_from_config

    state, config = ckpt.load_checkpoint(checkpoint_path)
    if not config or "model" not in config:
        raise ValueError(f"{checkpoint_path} holds no config with a model section")
    model_cfg = dict(config["model"])
    if model_cfg.get("cell_reps") == "auto":
        raise ValueError(
            f"{checkpoint_path}: model.cell_reps is 'auto', which a trainer resolves from its dataset "
            "(train/trainer.py::BaseTrainer._resolve_auto_cell_reps); save the checkpoint with the resolved "
            "cell_reps, or set them in its config")
    if sampling:
        model_cfg["sampling"] = True
    model = _model_from_config(model_cfg, mode=mode, device=device, generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    if set(params) != set(state["ema_params"]):
        raise ValueError(f"{checkpoint_path}: ema_params names differ from the model's: "
                         f"{sorted(set(params) ^ set(state['ema_params']))}")
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["ema_params"][name])
        for name, value in state.get("scale_factors", {}).items():
            buffers[name].copy_(value)
    return model.requires_grad_(False).eval()


class AdsorbDiffCalculator:
    """One-system diffusion + MLFF energy/forces API."""

    implemented_properties = ["energy", "forces"]  # ASE calculator protocol

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,  # denoising (score) model ckpt
        mlff_checkpoint_path: Optional[str] = None,  # s2ef model ckpt
        denoising_pos_params: Optional[dict] = None,
        max_atoms: Optional[int] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ) -> None:
        setup_compilation_cache()  # built kernels persist across processes
        self.checkpoint_path = checkpoint_path
        self.mlff_checkpoint_path = mlff_checkpoint_path
        self.denoising_pos_params = {**DEFAULT_DENOISING_PARAMS, **(denoising_pos_params or {})}
        self.max_atoms = max_atoms
        self.seed = seed
        self.device = resolve_device(device)
        self._diff: Optional[DiffusionEngine] = None
        self._mlff: Optional[torch.nn.Module] = None
        self.results: dict = {}

    # -- internals -----------------------------------------------------------
    def _batch(self, atoms: Atoms) -> AtomsBatch:
        n = self.max_atoms or int(-(-len(atoms) // 8) * 8)
        return collate([atoms_to_system(atoms)], max_atoms=n, device=self.device)

    def _diffusion_engine(self) -> DiffusionEngine:
        if self._diff is None:
            if not self.checkpoint_path:
                raise ValueError("no denoising checkpoint configured")
            model = load_model(self.checkpoint_path, self.device, sampling=True)
            self._diff = DiffusionEngine(make_score_fn(model), self.denoising_pos_params,
                                         static_fn=getattr(model, "prepare_static", None), device=self.device)
        return self._diff

    def _mlff_model(self) -> torch.nn.Module:
        """The MLFF (s2ef) model, loaded on first use."""
        if self._mlff is None:
            if not self.mlff_checkpoint_path:
                raise ValueError("no MLFF checkpoint configured")
            self._mlff = load_model(self.mlff_checkpoint_path, self.device, sampling=False, mode="s2ef")
        return self._mlff

    # -- public API ----------------------------------------------------------
    def run_diffusion(self, atoms: Atoms, generator: Optional[torch.Generator] = None,
                      traj_dir: Optional[str] = None) -> Atoms:
        """Reverse diffusion for one system (ref: calculator.py:180-210);
        ``generator`` (on the calculator's device) defaults to one seeded
        with ``seed``."""
        batch = self._batch(atoms)
        engine = self._diffusion_engine()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
        res = engine.run(batch, generator, traj_dir=traj_dir, skip_existing=False)
        engine.flush()
        return batch_to_atoms(res.batch)[0]

    def calculate(self, atoms=None, properties=("energy", "forces"), system_changes=None) -> dict:
        """Energy/forces via the MLFF model (ASE Calculator.calculate shape,
        ref: calculator.py:166-178)."""
        if not isinstance(atoms, Atoms):
            atoms = Atoms.from_ase(atoms)
        batch = self._batch(atoms)
        e, f = make_mlff_energy_forces(self._mlff_model())(batch)
        n = len(atoms)
        self.results = {"energy": float(e[0]), "forces": f[0, :n].cpu().numpy()}
        return self.results

    def get_potential_energy(self, atoms=None, **kw) -> float:
        if atoms is not None or "energy" not in self.results:
            self.calculate(atoms)
        return self.results["energy"]

    def get_forces(self, atoms=None):
        if atoms is not None or "forces" not in self.results:
            self.calculate(atoms)
        return self.results["forces"]

    def relax(self, atoms: Atoms, steps: int = 300, fmax: float = 0.01, relax_opt: Optional[dict] = None,
              traj_dir: Optional[str] = None) -> Atoms:
        """MLFF L-BFGS relaxation of one system."""
        batch = self._batch(atoms)
        engine = RelaxationEngine.from_model(self._mlff_model(), relax_opt, steps=steps, fmax=fmax,
                                             device=self.device)
        res = engine.run(batch, traj_dir=traj_dir, skip_existing=False)
        engine.flush()
        return batch_to_atoms(res.batch, energy=res.energy, forces=res.forces)[0]
