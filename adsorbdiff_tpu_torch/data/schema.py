"""The batch schema: a fixed-shape padded batch of systems, as torch tensors.

Port of :mod:`adsorbdiff_tpu.data.schema`.  Every system owns a padded row of
``max_atoms`` slots and ``atom_mask`` marks real atoms, so a batch is a dense
``[B, N, ...]`` set of tensors and "scatter over batch" is a masked reduction
over axis 1 (:mod:`adsorbdiff_tpu_torch.ops.segment`).

Tags follow OC20: 0 = subsurface slab, 1 = surface slab, 2 = adsorbate.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class AtomsBatch:
    """Fixed-shape batch of (padded) atomic systems. All tensors lead with B."""

    pos: torch.Tensor  # [B, N, 3] float32 cartesian
    atomic_numbers: torch.Tensor  # [B, N] int32 (0 on padding)
    tags: torch.Tensor  # [B, N] int32
    fixed: torch.Tensor  # [B, N] bool (FixAtoms constraint)
    cell: torch.Tensor  # [B, 3, 3] float32, rows = lattice vectors
    natoms: torch.Tensor  # [B] int32
    atom_mask: torch.Tensor  # [B, N] bool
    sid: torch.Tensor  # [B] int32 system id
    fid: torch.Tensor  # [B] int32 frame/config id
    energy: torch.Tensor  # [B] float32 (y / conditional energy; 0 if absent)
    y_relaxed: torch.Tensor  # [B] float32 (DFT relaxed energy target; 0 if absent)
    pos_relaxed: torch.Tensor  # [B, N, 3] float32 (relaxed positions; = pos if absent)
    forces: Optional[torch.Tensor] = None  # [B, N, 3] float32 (S2EF target)

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def ads_mask(self) -> torch.Tensor:
        """[B, N] bool: real adsorbate atoms (tags == 2)."""
        return (self.tags == 2) & self.atom_mask

    @property
    def free_mask(self) -> torch.Tensor:
        """[B, N] bool: real unconstrained atoms."""
        return (~self.fixed) & self.atom_mask

    def replace(self, **changes) -> "AtomsBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device: DeviceLike) -> "AtomsBatch":
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return AtomsBatch(**{name: None if t is None else t.to(device) for name, t in fields.items()})


class System:
    """Host-side single system (numpy), the unit the data pipeline moves."""

    __slots__ = (
        "pos",
        "atomic_numbers",
        "tags",
        "fixed",
        "cell",
        "sid",
        "fid",
        "energy",
        "y_relaxed",
        "pos_relaxed",
        "forces",
    )

    def __init__(
        self,
        pos: np.ndarray,
        atomic_numbers: np.ndarray,
        cell: np.ndarray,
        tags: Optional[np.ndarray] = None,
        fixed: Optional[np.ndarray] = None,
        sid: int = 0,
        fid: int = 0,
        energy: Optional[float] = None,
        y_relaxed: float = 0.0,
        pos_relaxed: Optional[np.ndarray] = None,
        forces: Optional[np.ndarray] = None,
    ) -> None:
        n = len(pos)
        self.pos = np.asarray(pos, np.float32).reshape(n, 3)
        self.atomic_numbers = np.asarray(atomic_numbers, np.int32).reshape(n)
        self.cell = np.asarray(cell, np.float32).reshape(3, 3)
        self.tags = np.zeros(n, np.int32) if tags is None else np.asarray(tags, np.int32).reshape(n)
        self.fixed = np.zeros(n, bool) if fixed is None else np.asarray(fixed).astype(bool).reshape(n)
        self.sid = int(sid)
        self.fid = int(fid)
        # None = unset; distinguishes "no energy label" from a legitimate 0.0
        self.energy = None if energy is None else float(energy)
        self.y_relaxed = float(y_relaxed)
        self.pos_relaxed = (
            self.pos.copy() if pos_relaxed is None else np.asarray(pos_relaxed, np.float32).reshape(n, 3)
        )
        self.forces = None if forces is None else np.asarray(forces, np.float32).reshape(n, 3)

    @property
    def natoms(self) -> int:
        return len(self.pos)


def collate(
    systems: Sequence[System],
    max_atoms: Optional[int] = None,
    with_forces: bool = False,
    device: DeviceLike = None,
) -> AtomsBatch:
    """Pad and stack host-side systems into an :class:`AtomsBatch` on
    ``device`` (the CUDA card unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    b = len(systems)
    n = max(int(s.natoms) for s in systems)
    if max_atoms is not None:
        if n > max_atoms:
            raise ValueError(f"system with {n} atoms exceeds max_atoms={max_atoms}")
        n = max_atoms

    def zeros(shape, dtype):
        return np.zeros((b,) + shape, dtype)

    out = dict(
        pos=zeros((n, 3), np.float32),
        atomic_numbers=zeros((n,), np.int32),
        tags=zeros((n,), np.int32),
        fixed=zeros((n,), bool),
        cell=zeros((3, 3), np.float32),
        natoms=np.zeros(b, np.int32),
        atom_mask=zeros((n,), bool),
        sid=np.zeros(b, np.int32),
        fid=np.zeros(b, np.int32),
        energy=np.zeros(b, np.float32),
        y_relaxed=np.zeros(b, np.float32),
        pos_relaxed=zeros((n, 3), np.float32),
    )
    forces = zeros((n, 3), np.float32) if with_forces else None
    for i, s in enumerate(systems):
        k = s.natoms
        out["pos"][i, :k] = s.pos
        out["atomic_numbers"][i, :k] = s.atomic_numbers
        out["tags"][i, :k] = s.tags
        out["fixed"][i, :k] = s.fixed
        out["cell"][i] = s.cell
        out["natoms"][i] = k
        out["atom_mask"][i, :k] = True
        out["sid"][i] = s.sid
        out["fid"][i] = s.fid
        out["energy"][i] = 0.0 if s.energy is None else s.energy
        out["y_relaxed"][i] = s.y_relaxed
        out["pos_relaxed"][i, :k] = s.pos_relaxed
        if with_forces and s.forces is not None:
            forces[i, :k] = s.forces
    tensors = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    return AtomsBatch(forces=None if forces is None else torch.from_numpy(forces).to(device), **tensors)


def uncollate(batch: AtomsBatch) -> List[System]:
    """Batch -> host systems (inverse of :func:`collate`)."""
    host = batch.to("cpu")
    pos = host.pos.numpy()
    z = host.atomic_numbers.numpy()
    tags = host.tags.numpy()
    fixed = host.fixed.numpy()
    cell = host.cell.numpy()
    natoms = host.natoms.numpy()
    pos_rel = host.pos_relaxed.numpy()
    forces = None if host.forces is None else host.forces.numpy()
    out = []
    for i in range(batch.batch_size):
        k = int(natoms[i])
        out.append(
            System(
                pos=pos[i, :k],
                atomic_numbers=z[i, :k],
                tags=tags[i, :k],
                fixed=fixed[i, :k],
                cell=cell[i],
                sid=int(host.sid[i]),
                fid=int(host.fid[i]),
                energy=float(host.energy[i]),
                y_relaxed=float(host.y_relaxed[i]),
                pos_relaxed=pos_rel[i, :k],
                forces=None if forces is None else forces[i, :k],
            )
        )
    return out
