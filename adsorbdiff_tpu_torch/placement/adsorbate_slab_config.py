"""Adsorbate placement on slab binding sites.

Port of :mod:`adsorbdiff_tpu.placement.adsorbate_slab_config`, its arithmetic copied, so that
the same ``np.random.Generator`` seed gives the same result in both packages
(numpy and scipy only: the port keeps its own copy because the JAX
package's :class:`Atoms` reaches JAX through its schema).

Rebuild of ``AdsorbateSlabConfig`` (ref: adsorbdiff/placement/
adsorbate_slab_config.py:22-575):

- "random" site sampling: Delaunay triangulation over the 3x3-tiled surface
  atoms' xy positions (so cell-edge triangles aren't undersampled), uniform
  in-triangle sampling, then wrap-filter to the central cell (ref: :99-168);
- placement: random rotation (mode-dependent cone), COM / binding atom
  translated to the site, then lifted along the surface normal so the closest
  adsorbate-surface covalent-radius pair clears ``interstitial_gap``
  (ref: :196-351).  The reference root-finds the lift with scipy.fsolve; the
  intersection equation is an exact quadratic, solved here in closed form.
- "heuristic" site mode: ontop / bridge / hollow sites from the same Delaunay
  mesh (pymatgen-free equivalent of ``AdsorbateSiteFinder``, ref: :168-194),
  with the binding atom (not the COM) translated to the site.
"""
from __future__ import annotations

from itertools import product
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import Delaunay

from adsorbdiff_tpu_torch.placement.adsorbate import Adsorbate, randomly_rotate_adsorbate
from adsorbdiff_tpu_torch.placement.flag_anomaly import COVALENT_RADII
from adsorbdiff_tpu_torch.placement.slab import Slab
from adsorbdiff_tpu_torch.runtime.atoms import Atoms


class AdsorbateSlabConfig:
    def __init__(
        self,
        slab: Slab,
        adsorbate: Adsorbate,
        num_sites: int = 100,
        num_augmentations_per_site: int = 1,
        interstitial_gap: float = 0.1,
        mode: str = "random",
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        assert mode in ["random", "heuristic", "random_site_heuristic_placement"]
        assert interstitial_gap < 5, "a substantial lift above the surface is unphysical"
        self.slab = slab
        self.adsorbate = adsorbate
        self.num_sites = num_sites
        self.interstitial_gap = interstitial_gap
        self.mode = mode
        self.rng = rng or np.random.default_rng()

        self.sites = self.get_binding_sites(num_sites)
        self.atoms_list, self.metadata_list = self.place_adsorbate_on_sites(
            self.sites, num_augmentations_per_site, interstitial_gap
        )

    # ------------------------------------------------------------------ sites
    def get_binding_sites(self, num_sites: int) -> np.ndarray:
        """ref: :99-194."""
        assert self.slab.has_surface_tagged()
        atoms = self.slab.atoms
        cell = np.asarray(atoms.cell, np.float64)
        surf_mask = np.asarray(atoms.tags) == 1

        if self.mode in ["random", "random_site_heuristic_placement"]:
            # 3x3 xy tiling, central tile first (indices preserved, ref: :479-509)
            reps = [(0, 0)] + [r for r in product([-1, 0, 1], repeat=2) if r != (0, 0)]
            tiled_pos = np.concatenate([atoms.positions + i * cell[0] + j * cell[1] for i, j in reps])
            tiled_surf_mask = np.tile(surf_mask, len(reps))
            surf_pos = tiled_pos[tiled_surf_mask]
            n_central = int(surf_mask.sum())

            dt = Delaunay(surf_pos[:, :2])
            simplices = dt.simplices
            # keep triangles with >= 1 vertex in the central cell (ref: :131-143)
            keep = (simplices < n_central).any(axis=1)
            simplices = simplices[keep]

            num_per_tri = int(np.ceil(2.0 * num_sites / max(len(simplices), 1)))
            all_sites = []
            for tri in simplices:
                all_sites.append(get_random_sites_on_triangle(surf_pos[tri], num_per_tri, self.rng))
            uw = np.concatenate(all_sites) if all_sites else np.zeros((0, 3))
            # drop sites outside the central cell (xy-wrap test, ref: :158-166)
            frac = uw @ np.linalg.inv(cell)
            wrapped = frac.copy()
            wrapped[:, :2] %= 1.0
            w = wrapped @ cell
            keep_idx = np.all(np.isclose(uw, w, atol=1e-8), axis=1)
            sites = uw[keep_idx]
            self.rng.shuffle(sites)
            return sites[:num_sites]

        # "heuristic": ontop / bridge / hollow sites from the Delaunay mesh of
        # the surface atoms — pymatgen-free equivalent of
        # AdsorbateSiteFinder.find_adsorption_sites(distance=0)["all"]
        # (ref: :168-194).  Ontop = surface atoms, bridge = Delaunay edge
        # midpoints, hollow = triangle centroids; like the reference, ALL
        # found sites are returned (with a warning if more than num_sites).
        sites = heuristic_adsorption_sites(atoms)
        if len(sites) > num_sites:
            import logging

            logging.warning(
                f"Found {len(sites)} sites with mode='heuristic' and "
                f"num_sites={num_sites}. Heuristic mode returns all found sites."
            )
        self.rng.shuffle(sites)
        return sites

    # -------------------------------------------------------------- placement
    def place_adsorbate_on_site(self, site: np.ndarray, interstitial_gap: float = 0.1):
        """ref: :196-254."""
        ads = self.adsorbate.atoms.copy()
        slab_atoms = self.slab.atoms

        binding_idx = None
        if self.mode in ["heuristic", "random_site_heuristic_placement"]:
            binding_idx = int(self.rng.choice(self.adsorbate.binding_indices))

        sampled_angles = np.zeros(3)
        if len(ads) > 1:
            ads, sampled_angles = randomly_rotate_adsorbate(ads, self.mode, binding_idx, self.rng)

        center = ads.positions.mean(axis=0) if self.mode == "random" else ads.positions[binding_idx]
        ads.positions = ads.positions + (np.asarray(site) - center)

        cell = np.asarray(slab_atoms.cell, np.float64)
        normal = np.cross(cell[0], cell[1])
        unit_normal = normal / np.linalg.norm(normal)
        lift = self._get_scaled_normal(ads, slab_atoms, np.asarray(site), unit_normal, interstitial_gap)
        ads.positions = ads.positions + lift * unit_normal

        combined = Atoms(
            positions=np.concatenate([slab_atoms.positions, ads.positions]),
            numbers=np.concatenate([slab_atoms.numbers, ads.numbers]),
            cell=cell,
            tags=np.concatenate([slab_atoms.tags, np.full(len(ads), 2)]),
            fixed=np.concatenate([slab_atoms.fixed, np.zeros(len(ads), bool)]),
            pbc=(True, True, False),
        )
        return combined, sampled_angles

    def place_adsorbate_on_sites(self, sites, num_augmentations_per_site: int = 1, interstitial_gap: float = 0.1):
        atoms_list, metadata_list = [], []
        for site in sites:
            for _ in range(num_augmentations_per_site):
                atoms, angles = self.place_adsorbate_on_site(site, interstitial_gap)
                atoms_list.append(atoms)
                metadata_list.append({"site": np.asarray(site), "xyz_angles": angles})
        return atoms_list, metadata_list

    def _get_scaled_normal(
        self,
        ads: Atoms,
        slab_atoms: Atoms,
        site: np.ndarray,
        unit_normal: np.ndarray,
        interstitial_gap: float = 0.1,
    ) -> float:
        """Exact solve of the reference's fsolve target (ref: :278-351):
        find max over colliding pairs of the lift x with
        |surf - (ads_i + x*n)| = r_i + r_j + gap."""
        cell = np.asarray(slab_atoms.cell, np.float64)
        cell_center = np.array([0.5, 0.5, 0.5]) @ cell
        shift = cell_center - site
        # center about the site, wrap slab into the cell (ref: :316-322)
        slab_pos = slab_atoms.positions + shift
        frac = slab_pos @ np.linalg.inv(cell)
        frac[:, :2] %= 1.0
        slab_pos = frac @ cell
        ads_pos = ads.positions + shift

        r_ads = COVALENT_RADII[np.clip(ads.numbers, 0, len(COVALENT_RADII) - 1)]
        r_slab = COVALENT_RADII[np.clip(slab_atoms.numbers, 0, len(COVALENT_RADII) - 1)]

        # project onto the surface plane; pairs closer than r_i+r_j+gap collide
        def proj(p):
            v = p - cell[0]
            return p - np.outer(v @ unit_normal, unit_normal)

        pa, ps = proj(ads_pos), proj(slab_pos)
        d2 = np.linalg.norm(pa[:, None, :] - ps[None, :, :], axis=-1)
        rsum = r_ads[:, None] + r_slab[None, :]
        ai, si = np.nonzero(d2 <= rsum + interstitial_gap)
        if len(ai) == 0:
            return 0.0  # no possible intersections (ref: :349-351)

        lifts = []
        for a, s in zip(ai, si):
            w = slab_pos[s] - ads_pos[a]
            # |w - x n|^2 = R^2, |n|=1: x^2 - 2(w.n)x + |w|^2 - R^2 = 0
            rr = rsum[a, s] + interstitial_gap
            b = w @ unit_normal
            disc = b * b - (w @ w - rr * rr)
            if disc < 0:
                continue
            lifts.append(b + np.sqrt(disc))  # larger root = above the surface
        return float(max(lifts)) if lifts else 0.0

    def get_metadata_dict(self, ind: int) -> dict:
        """ref: :441-457."""
        return {
            "adsorbed_slab_atomsobject": self.atoms_list[ind],
            "adsorbed_slab_metadata": {
                "bulk_id": getattr(self.slab.bulk, "src_id", None),
                "millers": self.slab.millers,
                "shift": self.slab.shift,
                "top": self.slab.top,
                "smiles": self.adsorbate.smiles,
                "site": self.metadata_list[ind]["site"],
                "xyz_angles": self.metadata_list[ind]["xyz_angles"],
            },
        }


def heuristic_adsorption_sites(atoms: Atoms, dedup_tol: float = 0.1) -> np.ndarray:
    """Ontop / bridge / hollow adsorption sites from a Delaunay triangulation
    of the (3x3-tiled) surface atoms' xy positions — a pymatgen-free
    ``AdsorbateSiteFinder.find_adsorption_sites(distance=0)`` (ref:
    adsorbate_slab_config.py:168-189; pymatgen builds the same Delaunay mesh
    internally).  Sites sit at the mean position of their defining atoms
    (distance=0: the caller lifts along the normal afterwards); duplicates
    within ``dedup_tol`` Å after wrapping to the central cell are merged."""
    cell = np.asarray(atoms.cell, np.float64)
    surf_mask = np.asarray(atoms.tags) == 1
    assert surf_mask.any(), "heuristic sites need tagged surface atoms"
    reps = [(0, 0)] + [r for r in product([-1, 0, 1], repeat=2) if r != (0, 0)]
    tiled_pos = np.concatenate([atoms.positions + i * cell[0] + j * cell[1] for i, j in reps])
    tiled_surf = tiled_pos[np.tile(surf_mask, len(reps))]
    n_central = int(surf_mask.sum())

    sites = [tiled_surf[:n_central]]  # ontop, central cell only
    if len(tiled_surf) >= 3:
        simplices = Delaunay(tiled_surf[:, :2]).simplices
        simplices = simplices[(simplices < n_central).any(axis=1)]
        for tri in simplices:
            v = tiled_surf[tri]
            sites.append((v[[0, 1, 2]] + v[[1, 2, 0]]) / 2.0)  # bridge
            sites.append(v.mean(axis=0, keepdims=True))  # hollow
    uw = np.concatenate(sites)

    # wrap-filter to the central cell (xy), then dedupe on a tol grid
    frac = uw @ np.linalg.inv(cell)
    keep = np.all((frac[:, :2] >= -1e-8) & (frac[:, :2] < 1 - 1e-8), axis=1)
    uw = uw[keep]
    out: List[np.ndarray] = []
    seen = set()
    for s in uw:
        key = tuple(np.round(s / dedup_tol).astype(np.int64).tolist())
        if key not in seen:
            seen.add(key)
            out.append(s)
    return np.asarray(out)


def get_random_sites_on_triangle(vertices: np.ndarray, num_sites: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Uniform samples on a 3D triangle (ref: :460-477, Osada et al. Sec 4.2)."""
    rng = rng or np.random.default_rng()
    r1_sqrt = np.sqrt(rng.uniform(0, 1, num_sites))[:, None]
    r2 = rng.uniform(0, 1, num_sites)[:, None]
    return (1 - r1_sqrt) * vertices[0] + r1_sqrt * (1 - r2) * vertices[1] + r1_sqrt * r2 * vertices[2]


def get_interstitial_distances(adsorbate_slab_config: Atoms) -> np.ndarray:
    """Per adsorbate-slab pair: d - (r_i + r_j) (ref: :511-560)."""
    tags = np.asarray(adsorbate_slab_config.tags)
    ads = tags == 2
    pos, numbers = adsorbate_slab_config.positions, np.asarray(adsorbate_slab_config.numbers)
    r = COVALENT_RADII[np.clip(numbers, 0, len(COVALENT_RADII) - 1)]
    d = np.linalg.norm(pos[ads][:, None] - pos[~ads][None], axis=-1)
    return (d - (r[ads][:, None] + r[~ads][None])).ravel()


def there_is_overlap(adsorbate_slab_config: Atoms) -> bool:
    """ref: :562-575."""
    return bool((get_interstitial_distances(adsorbate_slab_config) < 0).any())
