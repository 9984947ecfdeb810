"""Offline evaluation: success rate, anomaly filtering, DwT/ADwT.

Port of :mod:`adsorbdiff_tpu.eval_tools` (numpy only; its own copy, as the
JAX package's module reaches JAX through its trajectory reader).  The
AdsorbDiff success metric: per system, the minimum anomaly-free ML energy
over all sampled placements and sites is within 0.1 eV of the DFT minimum.
Sources: ``.adtraj.npz`` trajectory directories (one per sampling seed or
site), the ``<root>/<seed>/relaxations`` layout of the pipeline, VASP
OUTCARs, and a predictions npz.
"""
from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from adsorbdiff_tpu_torch.placement.flag_anomaly import DetectTrajAnomaly
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory

SUCCESS_THRESHOLD = 0.1  # eV (ref: eval.py:582)


def is_successful(best_pred_energy: float, best_dft_energy: float, threshold: float = SUCCESS_THRESHOLD) -> bool:
    """ML min within `threshold` of (or below) the DFT min (ref: eval.py:582-586)."""
    return (best_pred_energy - best_dft_energy) <= threshold


def anomalous_structure(traj: Trajectory) -> np.ndarray:
    """4-flag anomaly vector for a trajectory (ref: eval.py:566-579)."""
    init_atoms, final_atoms = traj[0], traj[len(traj) - 1]
    detector = DetectTrajAnomaly(init_atoms, final_atoms, init_atoms.tags)
    return np.array(
        [
            detector.is_adsorbate_dissociated(),
            detector.is_adsorbate_desorbed(),
            detector.has_surface_changed(),
            detector.is_adsorbate_intercalated(),
        ]
    )


def min_energy_per_system(
    traj_dirs: Sequence[str],
    filter_anomalies: bool = True,
) -> Dict[str, Tuple[float, str]]:
    """Scan trajectory dirs (one per sampling seed/site); return per-sid
    (min final energy, traj path) over anomaly-free candidates
    (ref: eval.py traj-dir variants :111-553)."""
    best: Dict[str, Tuple[float, str]] = {}
    for d in traj_dirs:
        for path in sorted(glob.glob(os.path.join(d, f"*{SUFFIX}"))):
            traj = Trajectory.load(path)
            if traj.energy is None:
                continue
            if filter_anomalies and anomalous_structure(traj).any():
                continue
            e = float(traj.energy[-1])
            sid = str(traj.sid)
            if sid not in best or e < best[sid][0]:
                best[sid] = (e, path)
    return best


def success_rate_from_best(
    best: Dict[str, Tuple[float, str]],
    dft_targets: Dict[str, float],
    threshold: float = SUCCESS_THRESHOLD,
) -> Tuple[float, Dict[str, bool]]:
    """Success rate from a prebuilt per-sid (min energy, source) map over the
    DFT target denominator (ref: eval.py:556-563 — systems with no valid
    candidate count as failures)."""
    per_system: Dict[str, bool] = {}
    for sid, dft_e in dft_targets.items():
        if sid in best:
            per_system[sid] = bool(is_successful(best[sid][0], dft_e, threshold))
        else:
            per_system[sid] = False
    rate = sum(per_system.values()) / max(len(per_system), 1)
    return rate, per_system


def success_rate(
    traj_dirs: Sequence[str],
    dft_targets: Dict[str, float],
    filter_anomalies: bool = True,
    threshold: float = SUCCESS_THRESHOLD,
) -> Tuple[float, Dict[str, bool]]:
    """North-star success rate from ML trajectory dirs."""
    best = min_energy_per_system(traj_dirs, filter_anomalies)
    return success_rate_from_best(best, dft_targets, threshold)


# ---------------------------------------------------------------------------
# Results-layout walkers (the reference evaluates several on-disk layouts:
# flat traj dirs, per-seed dirs, and per-site `<seed>/relaxations` trees —
# ref: eval.py:344-380 get_success_from_noisy_relax_trajs,
# :383-425 get_success_from_train_trajs_nsite)
# ---------------------------------------------------------------------------


def parse_sid_fid(name: str) -> Tuple[str, str]:
    """Split a `{sid}_{fid}` file/dir stem into (sid, fid) with the reference's
    underscore-count convention — OC20-Dense sids contain two underscores, so
    3 underscores means a trailing fid and 2 means a bare sid
    (ref: eval.py:23-32)."""
    stem = os.path.basename(name).split(".")[0]
    n = stem.count("_")
    if n == 2 or n == 0:
        return stem, "0"
    sid, fid = stem.rsplit("_", 1)
    return sid, fid


def nsite_traj_dirs(root: str) -> List[str]:
    """`<root>/<seed>/relaxations` dirs — the 3-stage pipeline layout
    (ref: eval.py:403 ``glob(f"{traj_path}/*/relaxations/...")``)."""
    return sorted(d for d in glob.glob(os.path.join(root, "*", "relaxations")) if os.path.isdir(d))


def seed_traj_dirs(root: str) -> List[str]:
    """`<root>/<seed>` dirs — the noisy-relax layout
    (ref: eval.py:356 ``glob(f"{traj_path}/*/{sid}*.traj")``)."""
    return sorted(d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d))


def success_rate_nsite(root: str, dft_targets: Dict[str, float], **kw) -> Tuple[float, Dict[str, bool]]:
    """Success rate over a `<root>/<seed>/relaxations` tree (ref: eval.py:383-425)."""
    return success_rate(nsite_traj_dirs(root), dft_targets, **kw)


# ---------------------------------------------------------------------------
# VASP OUTCAR eval path (ref: eval.py:111-294 get_success_from_dft*)
# ---------------------------------------------------------------------------


def read_outcar_energy(path: str, force_consistent: bool = False) -> Optional[float]:
    """Final SCF energy from a VASP OUTCAR: ``energy(sigma->0)`` by default,
    the ``free  energy   TOTEN`` when ``force_consistent`` (the same pair ASE's
    OUTCAR reader exposes via get_potential_energy, which the reference calls
    at eval.py:143-144)."""
    e_fr: Optional[float] = None
    e0: Optional[float] = None
    with open(path, errors="ignore") as f:
        for line in f:
            if "free  energy   TOTEN" in line:
                try:
                    e_fr = float(line.split("=")[-1].split()[0])
                except (ValueError, IndexError):
                    pass
            elif "energy(sigma->0)" in line:
                try:
                    e0 = float(line.rsplit("=", 1)[-1].split()[0])
                except (ValueError, IndexError):
                    pass
    if force_consistent:
        return e_fr
    return e0 if e0 is not None else e_fr


def min_energy_from_outcars(
    root: str,
    ref_energies: Optional[Dict[str, float]] = None,
) -> Dict[str, Tuple[float, str]]:
    """Per-sid minimum DFT energy over `<root>/vasp/{sid}_{fid}/OUTCAR` runs,
    referenced to per-sid gas+slab energies when given
    (ref: eval.py:111-174 — ``mlE -= ref_energies[sid]``)."""
    best: Dict[str, Tuple[float, str]] = {}
    for outcar in sorted(glob.glob(os.path.join(root, "vasp", "*", "OUTCAR"))):
        sid, _fid = parse_sid_fid(os.path.basename(os.path.dirname(outcar)))
        e = read_outcar_energy(outcar)
        if e is None:
            continue
        if ref_energies is not None:
            if sid not in ref_energies:
                continue
            e -= float(ref_energies[sid])
        if sid not in best or e < best[sid][0]:
            best[sid] = (e, outcar)
    return best


def success_rate_from_outcars(
    root: str,
    dft_targets: Dict[str, float],
    ref_energies: Optional[Dict[str, float]] = None,
    threshold: float = SUCCESS_THRESHOLD,
) -> Tuple[float, Dict[str, bool]]:
    """DFT-verified success rate from OUTCAR runs (ref: eval.py:111-174)."""
    return success_rate_from_best(min_energy_from_outcars(root, ref_energies), dft_targets, threshold)


# ---------------------------------------------------------------------------
# npz-energies eval path (ref: eval.py:470-515 get_success_from_npz_energies:
# energies from a predictions npz keyed `{sid}_{fid}`, anomalies from trajs)
# ---------------------------------------------------------------------------


def min_energy_from_npz(
    npz_path: str,
    traj_dirs: Sequence[str],
    filter_anomalies: bool = True,
) -> Dict[str, Tuple[float, str]]:
    """Per-sid min energy where energies come from a predictions npz
    (``ids``/``energy`` arrays, ids = `{sid}_{fid}`) and the anomaly filter
    from the matching trajectory files (ref: eval.py:470-515)."""
    data = np.load(npz_path, allow_pickle=False)
    energies = {str(k): float(v) for k, v in zip(data["ids"], data["energy"])}
    best: Dict[str, Tuple[float, str]] = {}
    for d in traj_dirs:
        for path in sorted(glob.glob(os.path.join(d, f"*{SUFFIX}"))):
            traj = Trajectory.load(path)
            sid, fid = str(traj.sid), str(traj.fid)
            e = energies.get(f"{sid}_{fid}", energies.get(sid))
            if e is None:
                continue
            if filter_anomalies and anomalous_structure(traj).any():
                continue
            if sid not in best or e < best[sid][0]:
                best[sid] = (e, path)
    return best


def success_rate_from_npz(
    npz_path: str,
    traj_dirs: Sequence[str],
    dft_targets: Dict[str, float],
    filter_anomalies: bool = True,
    threshold: float = SUCCESS_THRESHOLD,
) -> Tuple[float, Dict[str, bool]]:
    """Success rate with npz-sourced energies (ref: eval.py:470-515)."""
    best = min_energy_from_npz(npz_path, traj_dirs, filter_anomalies)
    return success_rate_from_best(best, dft_targets, threshold)


def min_diff(diff: np.ndarray, cell: np.ndarray) -> np.ndarray:
    """PBC minimum-image wrap of displacement rows (ref: eval.py:765-777)."""
    fractional = np.linalg.solve(cell.T, diff.T).T
    fractional %= 1.0
    fractional %= 1.0
    fractional[fractional > 0.5] -= 1
    return np.matmul(fractional, cell)


def mean_ads_distance(traj: Trajectory, target_pos: np.ndarray, step: int = -1) -> float:
    """Mean adsorbate atom distance to target positions at a trajectory step,
    under the minimum image (ref: eval.py get_mean_distances_from_traj)."""
    ads = traj.tags == 2
    diff = traj.positions[step][ads] - np.asarray(target_pos)[ads]
    return float(np.mean(np.linalg.norm(min_diff(diff, traj.cell), axis=1)))


def compute_metrics(distances: Iterable[float]) -> Tuple[float, float]:
    """(DwT, ADwT): % of systems with mean distance < 0.1 Å, and the mean over
    thresholds 0.01..0.5 Å (ref: eval.py:751-762)."""
    distances = np.asarray(list(distances))
    intv = np.arange(0.01, 0.5, 0.001)
    dwts = [100 * float((distances < t).sum()) / len(distances) for t in intv]
    adwt = float(np.mean(dwts))
    dwt = 100 * float((distances < 0.1).sum()) / len(distances)
    return dwt, adwt


def ref_energies_from_pkl(path: str) -> Dict[str, float]:
    """Per-sid gas+slab reference energies ({sid: float} pickle, the
    ``oc20dense_ref_energies.pkl`` format — ref: eval.py:113-118)."""
    import pickle

    with open(path, "rb") as f:
        return {str(k): float(v) for k, v in pickle.load(f).items()}


def dft_targets_from_pkl(path: str) -> Dict[str, float]:
    """Per-sid DFT minimum energies from an OC20-Dense style mapping pickle
    {sid: [(config, energy), ...]} (ref: eval.py:603-636)."""
    import pickle

    with open(path, "rb") as f:
        targets = pickle.load(f)
    out: Dict[str, float] = {}
    for system, adslabs in targets.items():
        out[str(system)] = min(float(a[1]) for a in adslabs)
    return out
