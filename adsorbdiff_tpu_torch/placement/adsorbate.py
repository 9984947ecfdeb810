"""Adsorbate representation + random rotations.

Port of :mod:`adsorbdiff_tpu.placement.adsorbate`, its arithmetic copied, so that
the same ``np.random.Generator`` seed gives the same result in both packages
(numpy and scipy only: the port keeps its own copy because the JAX
package's :class:`Atoms` reaches JAX through its schema).

Rebuild of the reference (ref: adsorbdiff/placement/adsorbate.py:34-168) on
the ASE-lite Atoms type.  The OC20 adsorbate database (86 entries of
(ase.Atoms, SMILES, binding indices, reaction string) — ref:
placement/pkls/adsorbates.pkl) loads WITHOUT ase via a stub-class unpickler
that absorbs ``ase.*`` classes and reads positions/numbers out of the
pickled ``Atoms.arrays`` dict; a converted copy ships as the package asset
``assets/adsorbates_oc20.npz`` so DB-backed constructors work standalone
(``Adsorbate(adsorbate_id_from_db=...)`` with no path).
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

from adsorbdiff_tpu_torch.runtime.atoms import Atoms

_ASSET_DB = os.path.join(os.path.dirname(__file__), "..", "assets", "adsorbates_oc20.npz")


class Adsorbate:
    """An adsorbate: atoms + binding indices + optional SMILES/db id."""

    def __init__(
        self,
        adsorbate_atoms: Optional[Atoms] = None,
        adsorbate_id_from_db: Optional[int] = None,
        adsorbate_smiles_from_db: Optional[str] = None,
        adsorbate_db_path: Optional[str] = None,
        binding_indices: Optional[Sequence[int]] = None,
        smiles: Optional[str] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        self.smiles = smiles
        if adsorbate_atoms is not None:
            self.atoms = adsorbate_atoms
            self.binding_indices = list(binding_indices) if binding_indices is not None else [0]
            self.adsorbate_id_from_db = adsorbate_id_from_db
        else:
            db = _load_db(adsorbate_db_path)  # None -> packaged OC20 DB asset
            if adsorbate_id_from_db is None and adsorbate_smiles_from_db is not None:
                adsorbate_id_from_db = next(
                    i for i, entry in db.items() if entry[1] == adsorbate_smiles_from_db
                )
            if adsorbate_id_from_db is None:
                rng = rng or np.random.default_rng()
                adsorbate_id_from_db = int(rng.choice(list(db.keys())))
            self._load_entry(db[adsorbate_id_from_db], adsorbate_id_from_db)

    def _load_entry(self, entry: Tuple, idx: int) -> None:
        """OC20 db entry: (ase.Atoms, smiles, binding_indices) (ref: :109-121)."""
        atoms, smiles, binding = entry[0], entry[1], entry[2]
        self.atoms = Atoms.from_ase(atoms) if not isinstance(atoms, Atoms) else atoms
        self.smiles = smiles
        self.binding_indices = list(np.atleast_1d(binding))
        self.adsorbate_id_from_db = idx

    def __len__(self) -> int:
        return len(self.atoms)

    def __repr__(self) -> str:
        return f"Adsorbate: ({self.smiles}, natoms={len(self)})"


class _AseShim:
    """Stand-in for any pickled ``ase.*`` class: keeps the pickled state so
    ``arrays['positions']`` / ``arrays['numbers']`` / ``info`` are readable
    without ase installed."""

    def __init__(self, *args, **kwargs) -> None:
        self._args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - exotic reduce protocols
            self.__dict__["_state"] = state


class _AseShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "ase":
            return type(name, (_AseShim,), {"__module__": module})
        return super().find_class(module, name)


def _shim_to_atoms(obj) -> Atoms:
    """Pickled ase.Atoms (real or shimmed) -> ASE-lite Atoms."""
    if hasattr(obj, "arrays") and isinstance(obj.arrays, dict):
        arrays = obj.arrays
        cellobj = getattr(obj, "_cellobj", None)
        cell = getattr(cellobj, "array", None) if cellobj is not None else None
        return Atoms(
            positions=np.asarray(arrays["positions"], float),
            numbers=np.asarray(arrays["numbers"], int),
            cell=np.zeros((3, 3)) if cell is None else np.asarray(cell, float),
            tags=np.asarray(arrays.get("tags", np.zeros(len(arrays["numbers"])))).astype(int),
        )
    return Atoms.from_ase(obj)


def _load_db(path: Optional[str]) -> dict:
    """Load an adsorbate DB: the packaged npz asset (path None), a converted
    ``.npz``, or a reference ``.pkl`` (unpickled ase-free via the shim).

    Entries are ``(Atoms, smiles, binding_indices, reaction)`` keyed by int id
    (ref: adsorbate.py:24-121)."""
    if path is None:
        path = _ASSET_DB
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        db = {}
        offs = data["offsets"]
        for j, idx in enumerate(data["ids"]):
            lo, hi = int(offs[j]), int(offs[j + 1])
            atoms = Atoms(
                positions=data["positions"][lo:hi],
                numbers=data["numbers"][lo:hi],
                cell=np.zeros((3, 3)),
            )
            blo, bhi = int(data["binding_offsets"][j]), int(data["binding_offsets"][j + 1])
            db[int(idx)] = (
                atoms,
                str(data["smiles"][j]),
                data["binding"][blo:bhi].tolist(),
                str(data["reactions"][j]),
            )
        return db
    with open(path, "rb") as f:
        raw = _AseShimUnpickler(io.BufferedReader(f)).load()
    return {
        int(k): (_shim_to_atoms(v[0]),) + tuple(v[1:]) for k, v in raw.items()
    }


def convert_db_to_npz(pkl_path: str, out_path: str) -> int:
    """Reference adsorbates.pkl -> flat npz asset (generation utility)."""
    db = _load_db(pkl_path)
    ids = sorted(db)
    numbers, positions, offsets = [], [], [0]
    binding, binding_offsets = [], [0]
    smiles, reactions = [], []
    for i in ids:
        atoms, smi, bind = db[i][0], db[i][1], db[i][2]
        numbers.append(atoms.numbers)
        positions.append(atoms.positions)
        offsets.append(offsets[-1] + len(atoms))
        b = np.atleast_1d(np.asarray(bind, np.int64))
        binding.append(b)
        binding_offsets.append(binding_offsets[-1] + len(b))
        smiles.append(smi)
        reactions.append(db[i][3] if len(db[i]) > 3 else "")
    np.savez_compressed(
        out_path,
        ids=np.asarray(ids, np.int64),
        numbers=np.concatenate(numbers).astype(np.int64),
        positions=np.concatenate(positions).astype(np.float64),
        offsets=np.asarray(offsets, np.int64),
        binding=np.concatenate(binding),
        binding_offsets=np.asarray(binding_offsets, np.int64),
        smiles=np.asarray(smiles),
        reactions=np.asarray(reactions),
    )
    return len(ids)


def _rot_about(positions: np.ndarray, rotmat: np.ndarray, center: np.ndarray) -> np.ndarray:
    return (positions - center) @ rotmat.T + center


def randomly_rotate_adsorbate(
    atoms: Atoms,
    mode: str = "random",
    binding_idx: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
):
    """Uniform (or cone-constrained) random rotation (ref: adsorbate.py:122-168).

    "random": uniform z-spin then rotate the north pole to a uniform point on
    the sphere, about the COM.  "heuristic"/"random_site_heuristic_placement":
    same construction about the binding atom, with the pole confined to a
    pi/9 cone so the adsorbate doesn't crash into the surface.
    """
    assert mode in ["random", "heuristic", "random_site_heuristic_placement"]
    rng = rng or np.random.default_rng()
    out = atoms.copy()

    zrot = rng.uniform(0, 2 * np.pi)
    if mode == "random":
        center = out.positions.mean(axis=0)
        z = rng.uniform(-1.0, 1.0)
    else:
        assert binding_idx is not None
        center = out.positions[binding_idx]
        z = rng.uniform(np.cos(np.pi / 9), 1.0)
    phi = rng.uniform(0, 2 * np.pi)

    cz, sz = np.cos(zrot), np.sin(zrot)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    out.positions = _rot_about(out.positions, rz, center)

    # rotation taking (0,0,1) to rotvec
    rotvec = np.array([np.sqrt(1 - z * z) * np.cos(phi), np.sqrt(1 - z * z) * np.sin(phi), z])
    v = np.cross([0, 0, 1.0], rotvec)
    s = np.linalg.norm(v)
    c = rotvec[2]
    if s < 1e-12:
        r2 = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        r2 = np.eye(3) + vx + vx @ vx * ((1 - c) / s**2)
    out.positions = _rot_about(out.positions, r2, center)
    sampled_angles = np.array([zrot, phi, z])
    return out, sampled_angles
