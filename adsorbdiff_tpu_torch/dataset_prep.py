"""Dataset-preparation utilities: the reference's LMDB-creation scripts.

Port of :mod:`adsorbdiff_tpu.dataset_prep`: conditional training sets with
per-sid relative energies, the min-energy train sub-split, random-placement
validation/relaxation inputs and sid deduplication, all written as the
columnar ``*.adshard.npz`` shards the trainers read; and the VASP input
writers for DFT follow-up of relaxed structures.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from adsorbdiff_tpu_torch.data.schema import System
from adsorbdiff_tpu_torch.data.store import write_shard
from adsorbdiff_tpu_torch.runtime.atoms import atoms_to_system
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory


def build_conditional_train_set(
    traj_root: str,
    out_path: str,
    relaxed_positions: bool = True,
) -> int:
    """All configs per sid with RELATIVE energies E - E_min.

    The reference's ``preprocess_train_all_lmdb.py``: per system id, read
    every candidate trajectory's final frame, subtract the per-sid minimum
    energy (the min-energy config gets exactly 0.0 and ``fid = -1``), and
    emit all of them as conditional training targets.  Reads
    ``traj_root/<sid>/*.adtraj.npz``; returns the number of systems.
    """
    systems: List[System] = []
    sid_dirs = sorted(d for d in glob.glob(os.path.join(traj_root, "*")) if os.path.isdir(d))
    for sid_dir in sid_dirs:
        paths = sorted(glob.glob(os.path.join(sid_dir, f"*{SUFFIX}")))
        if not paths:
            continue
        trajs = [Trajectory.load(p) for p in paths]
        if any(t.energy is None for t in trajs):
            logging.warning(f"skipping {sid_dir}: trajectories without energies")
            continue
        energies = np.asarray([float(t.energy[-1]) for t in trajs])
        min_idx = int(np.argmin(energies))
        rel = energies - energies[min_idx]
        assert rel[min_idx] == 0.0
        for i, t in enumerate(trajs):
            pos = t.positions[-1]
            systems.append(
                System(
                    pos=pos,
                    atomic_numbers=t.numbers,
                    tags=t.tags,
                    fixed=t.fixed,
                    cell=t.cell,
                    sid=t.sid,
                    fid=(-1 if i == min_idx else i),
                    energy=float(rel[i]),  # conditional target (image.y)
                    pos_relaxed=pos if relaxed_positions else None,
                )
            )
    write_shard(out_path, systems)
    return len(systems)


def build_min_energy_subsplit(
    traj_root: str,
    out_dir: str,
    skip_first: int = 200,
    seed: int = 42,
    num_shards: int = 1,
    sid_list: Optional[Sequence[str]] = None,
) -> int:
    """Min-energy-config-per-sid train sub-split.

    The reference's ``preprocess_train_lmdb_subsplits.py``: shuffle the
    unique sid list with ``np.random.RandomState(seed)``, drop the first
    ``skip_first`` (the held-out sub-split), and for each remaining sid
    store only the candidate trajectory with the lowest final energy
    (positions and tags, no energy target; ``*surface`` trajectories are
    skipped), chunked over ``num_shards`` shards ``out_dir/data.%04d``.

    Reads ``traj_root/<sid>/*.adtraj.npz``; returns the number of systems.
    """
    if sid_list is None:
        sid_list = sorted(
            os.path.basename(d)
            for d in glob.glob(os.path.join(traj_root, "*"))
            if os.path.isdir(d)
        )
    sid_list = list(sid_list)
    rng = np.random.RandomState(seed)  # the reference's np.random.seed(42)
    rng.shuffle(sid_list)
    sid_list = sid_list[skip_first:]

    systems: List[System] = []
    for sid in sid_list:
        paths = sorted(glob.glob(os.path.join(traj_root, str(sid), f"*{SUFFIX}")))
        # the bare surface trajectory is not a candidate
        paths = [p for p in paths if not os.path.basename(p).split(".")[0].endswith("surface")]
        trajs = [Trajectory.load(p) for p in paths]
        trajs = [t for t in trajs if t.energy is not None]
        if not trajs:
            continue
        best = min(trajs, key=lambda t: float(t.energy[-1]))
        pos = best.positions[-1]
        systems.append(
            System(
                pos=pos,
                atomic_numbers=best.numbers,
                tags=best.tags,
                fixed=best.fixed,
                cell=best.cell,
                sid=best.sid,
                fid=0,
                pos_relaxed=pos,
            )
        )
    os.makedirs(out_dir, exist_ok=True)
    for i, chunk in enumerate(np.array_split(np.arange(len(systems)), max(num_shards, 1))):
        if len(chunk) == 0:
            continue
        write_shard(os.path.join(out_dir, "data.%04d" % i), [systems[j] for j in chunk])
    return len(systems)


def build_placement_dataset(
    adslab_configs: Sequence,
    out_path: str,
    sids: Optional[Sequence[int]] = None,
) -> int:
    """Random-placement relaxation/validation inputs (the reference's
    ``preprocess_val_relax_lmdb.py``): one system per :class:`Atoms`
    placement, its sid from ``sids`` or its position in the list."""
    systems = []
    for i, atoms in enumerate(adslab_configs):
        s = atoms_to_system(atoms)
        s.sid = int(sids[i]) if sids is not None else i
        systems.append(s)
    write_shard(out_path, systems)
    return len(systems)


def dedup_sids(dataset, out_path: str) -> int:
    """Keep the first entry of each sid, in dataset order (the reference's
    ``create_unique_train_system_id.py``)."""
    seen = set()
    systems = []
    for i in range(len(dataset)):
        s = dataset[i]
        if s.sid in seen:
            continue
        seen.add(s.sid)
        systems.append(s)
    write_shard(out_path, systems)
    return len(systems)


# --------------------------------------------------------------------- VASP
VASP_FLAGS = {
    # the reference's scripts/run_vasp_dft/write_vasp_inputs_nsite.py
    "ibrion": 2,
    "nsw": 0,
    "isif": 0,
    "isym": 0,
    "lreal": "Auto",
    "ediffg": -0.03,
    "symprec": 1e-10,
    "encut": 350.0,
    "laechg": True,
    "lwave": False,
    "ncore": 4,
    "gga": "RP",
    "pp": "PBE",
    "xc": "PBE",
}


def write_poscar(atoms, path: str) -> None:
    """Minimal VASP POSCAR writer (selective dynamics from `fixed`)."""
    numbers = np.asarray(atoms.numbers)
    order = np.argsort(numbers, kind="stable")
    symbols = {1: "H", 6: "C", 7: "N", 8: "O", 13: "Al", 26: "Fe", 28: "Ni", 29: "Cu",
               46: "Pd", 47: "Ag", 78: "Pt", 79: "Au"}
    uniq, counts = np.unique(numbers[order], return_counts=True)
    with open(path, "w") as f:
        f.write("adsorbdiff_tpu generated\n1.0\n")
        for row in np.asarray(atoms.cell):
            f.write("  ".join(f"{x:.10f}" for x in row) + "\n")
        f.write(" ".join(symbols.get(int(z), f"Z{int(z)}") for z in uniq) + "\n")
        f.write(" ".join(str(int(c)) for c in counts) + "\n")
        f.write("Selective dynamics\nCartesian\n")
        fixed = np.asarray(atoms.fixed)
        for i in order:
            flags = "F F F" if fixed[i] else "T T T"
            f.write("  ".join(f"{x:.10f}" for x in atoms.positions[i]) + f" {flags}\n")


def write_vasp_inputs(atoms, out_dir: str, flags: Optional[dict] = None) -> None:
    """POSCAR + INCAR for an ML-relaxed structure (screen anomalies first with
    :func:`adsorbdiff_tpu_torch.eval_tools.anomalous_structure`, as the
    reference does).  POTCAR and KPOINTS are site-specific and left to the
    cluster's own tooling."""
    os.makedirs(out_dir, exist_ok=True)
    write_poscar(atoms, os.path.join(out_dir, "POSCAR"))
    flags = dict(VASP_FLAGS, **(flags or {}))
    with open(os.path.join(out_dir, "INCAR"), "w") as f:
        for k, v in flags.items():
            if isinstance(v, bool):
                v = ".TRUE." if v else ".FALSE."
            f.write(f"{k.upper()} = {v}\n")


def launch_vasp(run_dirs: Sequence[str], command: str = "mpirun -np 16 vasp_std") -> List[str]:
    """The shell commands that run VASP in each directory, one after the
    other (the reference's ``launch_vasp.py``); returned, not executed."""
    return [f"cd {d} && {command} > vasp.out 2>&1" for d in run_dirs]
