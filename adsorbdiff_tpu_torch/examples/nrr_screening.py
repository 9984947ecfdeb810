"""NRR screening example — alloy-catalyst adsorbate enumeration as a script.

Port of the repository's ``examples/nrr_screening.py`` (which drives the JAX
package) onto :mod:`adsorbdiff_tpu_torch`, itself a port of the reference's
second worked example (ref: examples/NRR/NRR_example-gemnet.ipynb):
reproduce the *H vs *N*NH scaling-relation screen of Zhou et al., ACS Catal.
13 (2023) 2190 — for each alloy (111) surface, place the *H and *N*NH
adsorbates, relax with the MLFF, filter anomalies (dissociated / desorbed /
surface-changed / intercalated), and tabulate the minimum adsorption
energies whose (dE_NNH, dE_H) plane separates HER- from NRR-favoring
surfaces.

The adsorbates come from the packaged 86-entry OC20 DB (the reference loads
adsorbates.pkl; the port ships the converted asset, see
placement/adsorbate.py).  The reference notebook downloads
PT_zeroshot_painn.pt + an OCP GemNet-OC MLFF; this script uses
freshly-initialized small models by default so it runs anywhere — pass
``--diffusion-ckpt`` / ``--mlff-ckpt`` (the port's checkpoints; a reference
``.pt`` converts with ``python -m
adsorbdiff_tpu_torch.scripts.convert_checkpoint``) for meaningful physics.

Run: python -m adsorbdiff_tpu_torch.examples.nrr_screening [--cpu] [--bulks 2] [--num-steps 20]
(without ``--cpu`` everything runs on the CUDA card).
"""
import argparse
import tempfile
from typing import Optional, Sequence

import numpy as np

from adsorbdiff_tpu_torch import AdsorbDiffCalculator
from adsorbdiff_tpu_torch.examples.val_sample import make_demo_checkpoint
from adsorbdiff_tpu_torch.placement import (
    Adsorbate,
    AdsorbateSlabConfig,
    Bulk,
    DetectTrajAnomaly,
    Slab,
)
from adsorbdiff_tpu_torch.runtime.atoms import Atoms

MODEL_CFG = dict(
    name="painn", hidden_channels=48, num_layers=2, num_rbf=24, cutoff=8.0,
    max_neighbors=24, so3_denoising=True, cell_reps=(1, 1, 0),
)

# A3B fcc alloys from the NRR study (L1_2 ordering; lattice constants ~ a of
# the host metal).  (composition, Z_host x3 + Z_dopant, a [Angstrom],
# literature reaction label from the paper's Fig 6b)
ALLOYS = [
    ("Ag3Mo", [47, 47, 47, 42], 4.09, "HER"),
    ("Pd3Mo", [46, 46, 46, 42], 3.89, "NRR"),
    ("Cu3Re", [29, 29, 29, 75], 3.61, "HER"),
    ("Ni3Nb", [28, 28, 28, 41], 3.52, "NRR"),
]


def l12_bulk(name, numbers, a):
    """L1_2 (Cu3Au prototype) fcc cell: dopant at the corner."""
    cell = np.eye(3) * a
    frac = np.array([[0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5], [0, 0, 0]])
    return Bulk(bulk_atoms=Atoms(positions=frac @ cell, numbers=numbers, cell=cell), src_id=name)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the screen; returns the table's rows, the number of anomalous
    runs filtered and the number of diffusion runs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--diffusion-ckpt", default=None)
    ap.add_argument("--mlff-ckpt", default=None)
    ap.add_argument("--bulks", type=int, default=2, help="how many alloys to screen")
    ap.add_argument("--num-steps", type=int, default=20, help="diffusion steps")
    ap.add_argument("--relax-steps", type=int, default=30)
    ap.add_argument("--cpu", action="store_true", help="run on the host (the plain PyTorch path)")
    args = ap.parse_args(argv)

    # adsorbates straight from the packaged OC20 DB (heuristic placements use
    # their predefined binding indices, ref notebook cell 7)
    ads_h = Adsorbate(adsorbate_smiles_from_db="*H")
    ads_nnh = Adsorbate(adsorbate_smiles_from_db="*N*NH")
    print(f"adsorbates: {ads_h!r}, {ads_nnh!r}")

    calc = None
    rows = []
    anomalies = runs = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, numbers, a, reaction in ALLOYS[: args.bulks]:
            bulk = l12_bulk(name, numbers, a)
            slab = Slab.from_bulk_get_specific_millers((1, 1, 1), bulk)[0]
            for label, ads in (("H", ads_h), ("NNH", ads_nnh)):
                cfg = AdsorbateSlabConfig(
                    slab, ads, mode="heuristic", num_sites=1, rng=np.random.default_rng(0)
                )
                adslab = cfg.atoms_list[0]
                if calc is None:
                    diff_ckpt = args.diffusion_ckpt or make_demo_checkpoint(tmp, MODEL_CFG, name="diff")
                    mlff_ckpt = args.mlff_ckpt or make_demo_checkpoint(
                        tmp, dict(MODEL_CFG, so3_denoising=False), mode="s2ef", name="mlff"
                    )
                    calc = AdsorbDiffCalculator(
                        checkpoint_path=diff_ckpt,
                        mlff_checkpoint_path=mlff_ckpt,
                        denoising_pos_params={"num_steps": args.num_steps},
                        max_atoms=int(-(-(len(adslab) + 4) // 16) * 16),
                        device="cpu" if args.cpu else None,
                    )
                placed = calc.run_diffusion(adslab)
                runs += 1
                relaxed = calc.relax(placed, steps=args.relax_steps, fmax=0.02)
                det = DetectTrajAnomaly(placed, relaxed, placed.tags)
                anom = (
                    det.is_adsorbate_dissociated()
                    or det.is_adsorbate_desorbed()
                    or det.has_surface_changed()
                    or det.is_adsorbate_intercalated()
                )
                if anom:
                    anomalies += 1
                    print(f"  {name}/{label}: anomalous relaxation, skipped")
                    continue
                rows.append(dict(bulk=name, adsorbate=label, e_ml=float(relaxed.energy), reaction=reaction))
                print(f"  {name}/{label}: E_ml = {relaxed.energy:+.4f} eV")

    # min-E table per (bulk, adsorbate) and the Fig-6b style separation
    print(f"\n{anomalies} anomalous runs filtered")
    print(f"{'bulk':<8} {'dE_H':>9} {'dE_NNH':>9}  reaction")
    by_bulk = {}
    for r in rows:
        by_bulk.setdefault(r["bulk"], {})[r["adsorbate"]] = r
    for name, d in by_bulk.items():
        if "H" in d and "NNH" in d:
            print(
                f"{name:<8} {d['H']['e_ml']:>9.4f} {d['NNH']['e_ml']:>9.4f}  {d['H']['reaction']}"
            )
    print(
        "\n(NRR-favoring surfaces sit below the dE_H = dE_NNH scaling line in"
        " the published screen; with demo-initialized models the energies are"
        " untrained — supply real checkpoints for physical results.)"
    )
    return dict(rows=rows, anomalies=anomalies, runs=runs)


if __name__ == "__main__":
    main()
