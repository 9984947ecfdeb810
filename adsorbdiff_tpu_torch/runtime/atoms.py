"""A minimal host-side Atoms container and its converters.

Port of :mod:`adsorbdiff_tpu.runtime.atoms` (which reaches JAX through its
schema): the same fields and methods, so trajectories and the anomaly filter
read the same in both packages.  :meth:`Atoms.to_ase` and
:meth:`Atoms.from_ase` import ``ase`` when called and raise ``ImportError``
without it; nothing on the main path needs them.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch, System, uncollate


class Atoms:
    """Host-side atoms object: positions, numbers, cell (rows), tags, fixed."""

    def __init__(
        self,
        positions: np.ndarray,
        numbers: np.ndarray,
        cell: np.ndarray,
        tags: Optional[np.ndarray] = None,
        fixed: Optional[np.ndarray] = None,
        energy: Optional[float] = None,
        forces: Optional[np.ndarray] = None,
        sid: int = 0,
        fid: int = 0,
        pbc=(True, True, True),
    ) -> None:
        n = len(positions)
        self.positions = np.asarray(positions, np.float64).reshape(n, 3)
        self.numbers = np.asarray(numbers, np.int64).reshape(n)
        self.cell = np.asarray(cell, np.float64).reshape(3, 3)
        self.tags = np.zeros(n, np.int64) if tags is None else np.asarray(tags, np.int64)
        self.fixed = np.zeros(n, bool) if fixed is None else np.asarray(fixed, bool)
        self.energy = energy
        self.forces = None if forces is None else np.asarray(forces, np.float64).reshape(n, 3)
        self.sid = int(sid)
        self.fid = int(fid)
        self.pbc = tuple(bool(p) for p in pbc)

    def __len__(self) -> int:
        return len(self.positions)

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def set_positions(self, pos: np.ndarray) -> None:
        self.positions = np.asarray(pos, np.float64).reshape(-1, 3)

    def get_atomic_numbers(self) -> np.ndarray:
        return self.numbers.copy()

    def get_tags(self) -> np.ndarray:
        return self.tags.copy()

    def get_potential_energy(self):
        return self.energy

    def get_forces(self):
        return self.forces

    def get_cell(self) -> np.ndarray:
        return self.cell.copy()

    def copy(self) -> "Atoms":
        return Atoms(
            self.positions, self.numbers, self.cell, self.tags, self.fixed,
            self.energy, self.forces, self.sid, self.fid, self.pbc,
        )

    def to_ase(self):
        """A real ``ase.Atoms`` (needs ``ase``)."""
        import ase
        from ase.calculators.singlepoint import SinglePointCalculator
        from ase.constraints import FixAtoms

        atoms = ase.Atoms(numbers=self.numbers, positions=self.positions, cell=self.cell, pbc=self.pbc)
        atoms.set_tags(self.tags)
        if self.fixed.any():
            atoms.set_constraint(FixAtoms(mask=self.fixed))
        if self.energy is not None or self.forces is not None:
            atoms.calc = SinglePointCalculator(atoms, energy=self.energy, forces=self.forces)
        return atoms

    @classmethod
    def from_ase(cls, atoms, sid: int = 0, fid: int = 0) -> "Atoms":
        fixed = np.zeros(len(atoms), bool)
        for c in getattr(atoms, "constraints", []) or []:
            if c.__class__.__name__ == "FixAtoms":
                fixed[np.asarray(c.index, int)] = True
        energy = forces = None
        if atoms.calc is not None:
            r = getattr(atoms.calc, "results", {})
            energy, forces = r.get("energy"), r.get("forces")
        return cls(
            atoms.get_positions(), atoms.get_atomic_numbers(), np.asarray(atoms.get_cell()),
            atoms.get_tags(), fixed, energy, forces, sid, fid, tuple(atoms.get_pbc()),
        )


def atoms_to_system(atoms: Atoms, **over) -> System:
    """Atoms -> the pipeline's host :class:`System`."""
    kw = dict(
        pos=atoms.positions,
        atomic_numbers=atoms.numbers,
        cell=atoms.cell,
        tags=atoms.tags,
        fixed=atoms.fixed,
        sid=atoms.sid,
        fid=atoms.fid,
    )
    if atoms.energy is not None:
        kw["energy"] = float(atoms.energy)
    if atoms.forces is not None:
        kw["forces"] = atoms.forces
    kw.update(over)
    return System(**kw)


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def batch_to_atoms(batch: AtomsBatch, energy=None, forces=None) -> List[Atoms]:
    """A batch (on any device) -> one host :class:`Atoms` per system;
    ``energy [B]`` and ``forces [B, N, 3]`` may be tensors or arrays."""
    energy, forces = _host(energy), _host(forces)
    return [
        Atoms(
            positions=s.pos,
            numbers=s.atomic_numbers,
            cell=s.cell,
            tags=s.tags,
            fixed=s.fixed,
            energy=None if energy is None else float(energy[i]),
            forces=None if forces is None else forces[i, : s.natoms],
            sid=s.sid,
            fid=s.fid,
        )
        for i, s in enumerate(uncollate(batch))
    ]
