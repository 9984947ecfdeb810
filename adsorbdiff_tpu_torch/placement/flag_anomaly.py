"""Trajectory anomaly detection (dissociation / desorption / surface change /
intercalation).

Port of :mod:`adsorbdiff_tpu.placement.flag_anomaly` (numpy only; the port
keeps its own copy because the JAX package's module reaches JAX through its
Atoms).  Connectivity is ase.neighborlist's rule computed in numpy: covalent
radii times a multiplier plus the NeighborList default skin of 0.3 Å, under
the minimum image, with the Cordero (2008) radii table that
ase.data.covalent_radii ships.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from adsorbdiff_tpu_torch.runtime.atoms import Atoms

# Cordero et al. 2008 covalent radii (Å), index = atomic number (0 unused).
# Same table as ase.data.covalent_radii.
COVALENT_RADII = np.array([
    0.20, 0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,  # X..Ne
    1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06,  # Na..Ar
    2.03, 1.76, 1.70, 1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22,  # K..Zn
    1.22, 1.20, 1.19, 1.20, 1.20, 1.16,  # Ga..Kr
    2.20, 1.95, 1.90, 1.75, 1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45, 1.44,  # Rb..Cd
    1.42, 1.39, 1.39, 1.38, 1.39, 1.40,  # In..Xe
    2.44, 2.15, 2.07, 2.04, 2.03, 2.01, 1.99, 1.98, 1.98, 1.96, 1.94, 1.92,  # Cs..Dy
    1.92, 1.89, 1.90, 1.87, 1.87, 1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36,  # Ho..Pt
    1.36, 1.32, 1.45, 1.46, 1.48, 1.40, 1.50, 1.50,  # Au..Rn
    2.60, 2.21, 2.15, 2.06, 2.00, 1.96, 1.90, 1.87, 1.80, 1.69,  # Fr..Cm
])

_SKIN = 0.3  # ase NeighborList default skin, included in stored neighbors


def connectivity_matrix(
    positions: np.ndarray,
    numbers: np.ndarray,
    cell: Optional[np.ndarray] = None,
    pbc: Sequence[bool] = (True, True, True),
    cutoff_multiplier: float = 1.0,
) -> np.ndarray:
    """Boolean-int connectivity: d_ij(min image) < mult*(r_i + r_j) + skin."""
    positions = np.asarray(positions, np.float64)
    numbers = np.asarray(numbers, int)
    n = len(positions)
    radii = COVALENT_RADII[np.clip(numbers, 0, len(COVALENT_RADII) - 1)] * cutoff_multiplier
    cut = radii[:, None] + radii[None, :] + _SKIN

    diff = positions[:, None, :] - positions[None, :, :]
    if cell is not None and any(pbc):
        cell = np.asarray(cell, np.float64)
        # minimum over neighboring images (pm 1 cell per periodic axis)
        reps = [np.arange(-1, 2) if pbc[i] else np.array([0]) for i in range(3)]
        offsets = np.stack(np.meshgrid(*reps, indexing="ij"), axis=-1).reshape(-1, 3) @ cell
        d = np.min(
            np.linalg.norm(diff[None, :, :, :] + offsets[:, None, None, :], axis=-1), axis=0
        )
    else:
        d = np.linalg.norm(diff, axis=-1)
    conn = (d < cut).astype(np.int64)
    np.fill_diagonal(conn, 0)
    return conn


class DetectTrajAnomaly:
    """The reference's anomaly tests on an initial and a final structure;
    ``init_atoms``/``final_atoms`` are :class:`adsorbdiff_tpu_torch.runtime.
    atoms.Atoms` (or anything with positions/numbers/cell/pbc attributes)."""

    def __init__(
        self,
        init_atoms,
        final_atoms,
        atoms_tag: Sequence[int],
        final_slab_atoms=None,
        surface_change_cutoff_multiplier: float = 1.5,
        desorption_cutoff_multiplier: float = 1.5,
    ) -> None:
        self.init_atoms = init_atoms
        self.final_atoms = final_atoms
        self.atoms_tag = np.asarray(atoms_tag, int)
        self.surface_change_cutoff_multiplier = surface_change_cutoff_multiplier
        self.desorption_cutoff_multiplier = desorption_cutoff_multiplier
        if final_slab_atoms is None:
            slab_idx = np.nonzero(self.atoms_tag != 2)[0]
            final_slab_atoms = _take(init_atoms, slab_idx)
        self.final_slab_atoms = final_slab_atoms

    def _conn(self, atoms, mult: float = 1.0) -> np.ndarray:
        return connectivity_matrix(
            atoms.positions, atoms.numbers, atoms.cell, getattr(atoms, "pbc", (True, True, True)), mult
        )

    def is_adsorbate_dissociated(self) -> bool:
        """Initial adsorbate connectivity not maintained."""
        ads = np.nonzero(self.atoms_tag == 2)[0]
        return not np.array_equal(
            self._conn(_take(self.init_atoms, ads)), self._conn(_take(self.final_atoms, ads))
        )

    def has_surface_changed(self) -> bool:
        """Bond breaking/forming on the surface beyond the cushion."""
        surf = np.nonzero(self.atoms_tag != 2)[0]
        adslab = self._conn(_take(self.final_atoms, surf))
        slab_cushion = self._conn(self.final_slab_atoms, self.surface_change_cutoff_multiplier)
        slab_test = 1 in (adslab - slab_cushion)
        adslab_cushion = self._conn(_take(self.final_atoms, surf), self.surface_change_cutoff_multiplier)
        slab = self._conn(self.final_slab_atoms)
        adslab_test = 1 in (slab - adslab_cushion)
        return bool(slab_test or adslab_test)

    def is_adsorbate_desorbed(self) -> bool:
        """No adsorbate-surface bonds under the desorption cushion."""
        ads = np.nonzero(self.atoms_tag == 2)[0]
        surf = np.nonzero(self.atoms_tag != 2)[0]
        conn = self._conn(self.final_atoms, self.desorption_cutoff_multiplier)
        for idx in ads:
            if conn[idx][surf].sum() >= 1:
                return False
        return True

    def is_adsorbate_intercalated(self) -> bool:
        """Any adsorbate atom bonded to a frozen (tag-0) atom."""
        ads = np.nonzero(self.atoms_tag == 2)[0]
        frozen = np.nonzero(self.atoms_tag == 0)[0]
        conn = self._conn(self.final_atoms)
        for idx in ads:
            if conn[idx][frozen].sum() >= 1:
                return True
        return False


def _take(atoms, idx):
    return Atoms(
        positions=np.asarray(atoms.positions)[idx],
        numbers=np.asarray(atoms.numbers)[idx],
        cell=atoms.cell,
        tags=np.asarray(atoms.tags)[idx] if getattr(atoms, "tags", None) is not None else None,
        fixed=np.asarray(atoms.fixed)[idx] if getattr(atoms, "fixed", None) is not None else None,
        pbc=getattr(atoms, "pbc", (True, True, True)),
    )
