"""End-to-end single-system demo — the reference notebook as a script.

Port of the repository's ``examples/val_sample.py`` (which drives the JAX
package) onto :mod:`adsorbdiff_tpu_torch`.  It mirrors
``examples/valID_sample/val_sample.ipynb`` (the reference's de-facto smoke
test, SURVEY.md §4): build an adslab, run reverse diffusion to place the
adsorbate, MLFF-relax the result, and anomaly-check the trajectory — all
through the public one-system API.

The reference notebook loads pretrained checkpoints (PT_zeroshot_painn.pt +
an OCP GemNet-OC MLFF); this demo trains nothing and uses freshly-initialized
small models so it runs anywhere in ~a minute — swap in real checkpoints (the
port's format; a reference ``.pt`` converts with ``python -m
adsorbdiff_tpu_torch.scripts.convert_checkpoint``) via ``--diffusion-ckpt`` /
``--mlff-ckpt`` for meaningful physics.

Run: python -m adsorbdiff_tpu_torch.examples.val_sample [--cpu] [--num-steps 50] [--relax-steps 30]
(without ``--cpu`` everything runs on the CUDA card).
"""
import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from adsorbdiff_tpu_torch import AdsorbDiffCalculator
from adsorbdiff_tpu_torch.placement import Adsorbate, AdsorbateSlabConfig, Bulk, DetectTrajAnomaly, Slab
from adsorbdiff_tpu_torch.runtime.atoms import Atoms
from adsorbdiff_tpu_torch.train import checkpoint as ckpt
from adsorbdiff_tpu_torch.train.trainer import _model_from_config

MODEL_CFG = dict(
    name="painn", hidden_channels=64, num_layers=3, num_rbf=32, cutoff=8.0,
    max_neighbors=24, so3_denoising=True, cell_reps=(1, 1, 0),
)


def make_demo_checkpoint(out_dir: str, model_cfg: dict, mode: Optional[str] = None, name: str = "ckpt") -> str:
    """Write ``out_dir/name``: a port checkpoint of the model ``model_cfg``
    describes with fresh weights (seed 0), EMA equal to them, a zero AdamW
    state and the model's scale factors, its config ``{"model": model_cfg}``
    (with ``mode``).  The JAX example's ``example`` batch is not needed: a
    PyTorch model initialises without one.  Returns the path."""
    model = _model_from_config(model_cfg, mode=mode, device=torch.device("cpu"),
                               generator=torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    state = {
        "step": 0,
        "params": params,
        "ema_params": {n: p.clone() for n, p in params.items()},
        "scale_factors": {n: b for n, b in model.named_buffers() if n.endswith("scale_factor")},
        "opt_state": {"count": torch.zeros((), dtype=torch.int32),
                      "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                      "nu": {n: torch.zeros_like(p) for n, p in params.items()}},
    }
    config = {"model": dict(model_cfg, **({"mode": mode} if mode else {}))}
    return ckpt.save_checkpoint(out_dir, name, state, config=config)


def cu_bulk() -> Bulk:
    """fcc Cu, the conventional cell."""
    a = 3.61
    cell = np.eye(3) * a
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    return Bulk(bulk_atoms=Atoms(positions=frac @ cell, numbers=[29] * 4, cell=cell), src_id="mp-30")


def co_adsorbate() -> Adsorbate:
    """CO bound through C."""
    atoms = Atoms(positions=[[0, 0, 0], [0, 0, 1.15]], numbers=[6, 8], cell=np.eye(3) * 20, pbc=(False,) * 3)
    return Adsorbate(adsorbate_atoms=atoms, binding_indices=[0], smiles="*CO")


def cu100_co_adslab() -> Atoms:
    """A Cu(100) slab with CO placed on a random site (placement toolkit)."""
    slab = Slab.from_bulk_get_specific_millers((1, 0, 0), cu_bulk())[0]
    config = AdsorbateSlabConfig(slab, co_adsorbate(), num_sites=1, mode="random", rng=np.random.default_rng(0))
    return config.atoms_list[0]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the demo; returns the placed and relaxed structures, the placed
    structure's energy and the anomaly flags."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--diffusion-ckpt", default=None)
    ap.add_argument("--mlff-ckpt", default=None)
    ap.add_argument("--num-steps", type=int, default=50)
    ap.add_argument("--relax-steps", type=int, default=30)
    ap.add_argument("--cpu", action="store_true", help="run on the host (the plain PyTorch path)")
    args = ap.parse_args(argv)

    # 1. build a Cu(100) slab and place CO on a random site (placement toolkit)
    adslab = cu100_co_adslab()
    print(f"adslab: {len(adslab)} atoms, {int((np.asarray(adslab.tags) == 2).sum())} adsorbate atoms")

    with tempfile.TemporaryDirectory() as tmp:
        # 2. checkpoints (demo-initialized unless provided)
        diff_ckpt = args.diffusion_ckpt or make_demo_checkpoint(tmp, MODEL_CFG, name="diff")
        mlff_ckpt = args.mlff_ckpt or make_demo_checkpoint(
            tmp, dict(MODEL_CFG, so3_denoising=False), mode="s2ef", name="mlff"
        )

        # 3. one-system API: diffusion placement -> energy -> relaxation
        calc = AdsorbDiffCalculator(
            checkpoint_path=diff_ckpt,
            mlff_checkpoint_path=mlff_ckpt,
            denoising_pos_params={"num_steps": args.num_steps},
            max_atoms=int(-(-len(adslab) // 8) * 8),
            device="cpu" if args.cpu else None,
        )
        placed = calc.run_diffusion(adslab, traj_dir=os.path.join(tmp, "trajs"))
        print("diffusion done; adsorbate COM:", placed.positions[np.asarray(placed.tags) == 2].mean(0).round(3))

        energy = calc.get_potential_energy(placed)
        print(f"MLFF energy of placed structure: {energy:.4f} eV")

        relaxed = calc.relax(placed, steps=args.relax_steps, fmax=0.05)
        print(f"relaxed energy: {relaxed.energy:.4f} eV")

    # 4. anomaly check (the eval-pipeline filter)
    det = DetectTrajAnomaly(placed, relaxed, placed.tags)
    flags = dict(dissociated=det.is_adsorbate_dissociated(), desorbed=det.is_adsorbate_desorbed(),
                 surface_changed=det.has_surface_changed(), intercalated=det.is_adsorbate_intercalated())
    print("anomalies: " + " ".join(f"{k}={v}" for k, v in flags.items()))
    print("demo complete")
    return dict(adslab=adslab, placed=placed, energy=energy, relaxed=relaxed, anomalies=flags)


if __name__ == "__main__":
    main()
