"""Trajectory storage: one columnar ``*.adtraj.npz`` file per system.

Port of :mod:`adsorbdiff_tpu.runtime.trajectory` with the same file format
(keys, dtypes, and the ``.tmp.npz`` -> ``os.replace`` completion marker), so
a trajectory written by either package reads back in the other.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np

from adsorbdiff_tpu_torch.runtime.atoms import Atoms

SUFFIX = ".adtraj.npz"


class Trajectory:
    """A single system's trajectory: [T, n, 3] positions + static metadata."""

    def __init__(
        self,
        positions: np.ndarray,  # [T, n, 3]
        numbers: np.ndarray,
        cell: np.ndarray,
        tags: np.ndarray,
        fixed: np.ndarray,
        energy: Optional[np.ndarray] = None,  # [T]
        forces: Optional[np.ndarray] = None,  # [T, n, 3]
        sid: int = 0,
        fid: int = 0,
    ) -> None:
        self.positions = np.asarray(positions, np.float32)
        self.numbers = np.asarray(numbers, np.int32)
        self.cell = np.asarray(cell, np.float32)
        self.tags = np.asarray(tags, np.int32)
        self.fixed = np.asarray(fixed, bool)
        self.energy = None if energy is None else np.asarray(energy, np.float32)
        self.forces = None if forces is None else np.asarray(forces, np.float32)
        self.sid = int(sid)
        self.fid = int(fid)

    def __len__(self) -> int:
        return len(self.positions)

    def __getitem__(self, t: int) -> Atoms:
        return Atoms(
            positions=self.positions[t],
            numbers=self.numbers,
            cell=self.cell,
            tags=self.tags,
            fixed=self.fixed,
            energy=None if self.energy is None else float(self.energy[t]),
            forces=None if self.forces is None else self.forces[t],
            sid=self.sid,
            fid=self.fid,
        )

    def save(self, path: str) -> str:
        if not path.endswith(SUFFIX):
            path = path + SUFFIX
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cols = dict(
            positions=self.positions,
            numbers=self.numbers,
            cell=self.cell,
            tags=self.tags,
            fixed=self.fixed,
            sid=np.int64(self.sid),
            fid=np.int64(self.fid),
        )
        if self.energy is not None:
            cols["energy"] = self.energy
        if self.forces is not None:
            cols["forces"] = self.forces
        tmp = path[: -len(".npz")] + ".tmp.npz"  # np.savez appends .npz to other names
        np.savez_compressed(tmp, **cols)
        os.replace(tmp, path)  # atomic: the file exists only once complete
        return path

    @classmethod
    def load(cls, path: str) -> "Trajectory":
        if not os.path.exists(path) and os.path.exists(path + SUFFIX):
            path = path + SUFFIX
        z = np.load(path)
        return cls(
            positions=z["positions"],
            numbers=z["numbers"],
            cell=z["cell"],
            tags=z["tags"],
            fixed=z["fixed"],
            energy=z["energy"] if "energy" in z.files else None,
            forces=z["forces"] if "forces" in z.files else None,
            sid=int(z["sid"]),
            fid=int(z["fid"]),
        )

    def to_ase_traj(self, path: str) -> None:
        """Export as an ASE ``.traj`` (needs ``ase``)."""
        import ase.io

        with ase.io.Trajectory(path, mode="w") as traj:
            for t in range(len(self)):
                traj.write(self[t].to_ase())


def check_traj_files(sids: Sequence[int], traj_dir: Optional[str]) -> bool:
    """True if every system's trajectory already exists (the resumability
    check of the engines)."""
    if not traj_dir:
        return False
    return all(os.path.exists(os.path.join(traj_dir, f"{sid}{SUFFIX}")) for sid in sids)


def list_trajectories(traj_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(traj_dir, f"*{SUFFIX}")))
