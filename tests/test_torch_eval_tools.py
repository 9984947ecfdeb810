"""PyTorch port: anomaly detection and the success-rate / DwT evaluation.

Mirrors tests/test_eval_tools.py on the port's modules (the command line,
``adsorbdiff_tpu_torch/scripts/eval.py``, is held to ``scripts/eval.py`` in
``tests/test_torch_reference_import.py``), plus parity with the JAX
package on one trajectory tree: the same rate and per-system dict, and the
same anomaly flags per trajectory.
"""
import numpy as np
import pytest

from adsorbdiff_tpu_torch.eval_tools import (
    anomalous_structure,
    compute_metrics,
    is_successful,
    mean_ads_distance,
    min_energy_per_system,
    success_rate,
)
from adsorbdiff_tpu_torch.placement.flag_anomaly import COVALENT_RADII, DetectTrajAnomaly, connectivity_matrix
from adsorbdiff_tpu_torch.runtime.atoms import Atoms
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


def slab_with_co(z_ads=8.0, co_bond=1.15):
    """Cu slab (2 layers of 4) + CO adsorbate."""
    cell = np.diag([7.0, 7.0, 25.0])
    slab = []
    for iz, z in enumerate([0.0, 2.0]):
        for ix in range(2):
            for iy in range(2):
                slab.append([1.0 + 3 * ix, 1.0 + 3 * iy, z])
    pos = np.array(slab + [[1.0, 1.0, z_ads], [1.0, 1.0, z_ads + co_bond]])
    numbers = np.array([29] * 8 + [6, 8])
    tags = np.array([0] * 4 + [1] * 4 + [2, 2])
    return Atoms(positions=pos, numbers=numbers, cell=cell, tags=tags, fixed=tags == 0)


def test_connectivity_pbc():
    cell = np.diag([5.0, 5.0, 20.0])
    # two Cu atoms across the x-boundary: distance 1.0 via min image
    pos = np.array([[0.2, 2.0, 5.0], [4.8, 2.0, 5.0]])
    conn = connectivity_matrix(pos, [29, 29], cell, (True, True, True))
    assert conn[0, 1] == 1 and conn[1, 0] == 1
    conn_nopbc = connectivity_matrix(pos, [29, 29], cell, (False, False, False))
    assert conn_nopbc[0, 1] == 0


def test_anomaly_clean_relaxation():
    init = slab_with_co(z_ads=4.1)  # bound: C ~2.1 A above surface Cu
    final = slab_with_co(z_ads=4.0)
    det = DetectTrajAnomaly(init, final, init.tags)
    assert not det.is_adsorbate_dissociated()
    assert not det.is_adsorbate_desorbed()
    assert not det.has_surface_changed()
    assert not det.is_adsorbate_intercalated()


def test_anomaly_dissociation():
    init = slab_with_co(z_ads=4.1)
    final = slab_with_co(z_ads=4.1, co_bond=4.0)  # C-O bond broken
    det = DetectTrajAnomaly(init, final, init.tags)
    assert det.is_adsorbate_dissociated()


def test_anomaly_desorption():
    init = slab_with_co(z_ads=4.1)
    final = slab_with_co(z_ads=15.0)  # flew away
    det = DetectTrajAnomaly(init, final, init.tags)
    assert det.is_adsorbate_desorbed()


def test_anomaly_intercalation():
    init = slab_with_co(z_ads=4.1)
    final = slab_with_co(z_ads=0.0)  # C sits in the frozen layer
    det = DetectTrajAnomaly(init, final, init.tags)
    assert det.is_adsorbate_intercalated()


def test_anomaly_surface_change():
    init = slab_with_co(z_ads=4.1)
    final = slab_with_co(z_ads=4.1)
    moved = final.positions.copy()
    # migration must exceed the 1.5x covalent cushion (ref cutoff ~4.26 A for
    # Cu-Cu) to count as reconstruction
    moved[4] += np.array([0.0, 0.0, 6.0])
    final.set_positions(moved)
    det = DetectTrajAnomaly(init, final, init.tags)
    assert det.has_surface_changed()


def make_traj(tmp_path, sid, final_energy, desorbed=False, name=None):
    init = slab_with_co(z_ads=4.1)
    final = slab_with_co(z_ads=15.0 if desorbed else 4.0)
    t = Trajectory(
        positions=np.stack([init.positions, final.positions]).astype(np.float32),
        numbers=init.numbers, cell=init.cell, tags=init.tags, fixed=init.fixed,
        energy=np.array([0.0, final_energy], np.float32), sid=sid,
    )
    t.save(str(tmp_path / (name or str(sid))))
    return t


def test_success_rate_pipeline(tmp_path):
    d1 = tmp_path / "seed0"; d1.mkdir()
    d2 = tmp_path / "seed1"; d2.mkdir()
    # sid 1: candidate energies -1.0 (seed0) and -2.5 (seed1, but desorbed -> filtered)
    make_traj(d1, 1, -1.0)
    make_traj(d2, 1, -2.5, desorbed=True)
    # sid 2: min candidate -3.0, within 0.1 of dft -3.05
    make_traj(d1, 2, -2.0)
    make_traj(d2, 2, -3.0)
    best = min_energy_per_system([str(d1), str(d2)])
    assert best["1"][0] == pytest.approx(-1.0)  # desorbed candidate filtered
    assert best["2"][0] == pytest.approx(-3.0)

    dft = {"1": -2.0, "2": -3.05, "3": -1.0}  # sid 3 has no candidates
    rate, per = success_rate([str(d1), str(d2)], dft)
    assert per["1"] is False  # -1.0 vs -2.0 -> off by 1.0
    assert per["2"] is True  # -3.0 vs -3.05 -> within 0.1
    assert per["3"] is False  # missing candidate = failure
    assert rate == pytest.approx(1 / 3)


def test_dwt_metrics():
    dwt, adwt = compute_metrics([0.05, 0.2, 0.02, 0.4])
    assert dwt == pytest.approx(50.0)
    assert 0 < adwt < 100


def test_mean_ads_distance(tmp_path):
    t = make_traj(tmp_path, 9, -1.0)
    target = t.positions[-1].copy()
    assert mean_ads_distance(t, target) == pytest.approx(0.0, abs=1e-6)
    target2 = target.copy()
    target2[-2:] += [0.3, 0.0, 0.0]
    assert mean_ads_distance(t, target2) == pytest.approx(0.3, abs=1e-5)


OUTCAR_TEXT = """\
 some header
  free energy    TOTEN  =       -10.000 eV
  FREE ENERGIE OF THE ION-ELECTRON SYSTEM (eV)
  ---------------------------------------------------
  free  energy   TOTEN  =      -100.12345678 eV

  energy  without entropy=     -100.10000000  energy(sigma->0) =     -100.11172839
  ... later ionic step ...
  free  energy   TOTEN  =      -101.98765432 eV

  energy  without entropy=     -101.95000000  energy(sigma->0) =     -101.96882716
"""


def test_read_outcar_energy(tmp_path):
    from adsorbdiff_tpu_torch.eval_tools import read_outcar_energy

    p = tmp_path / "OUTCAR"
    p.write_text(OUTCAR_TEXT)
    # last ionic step wins; sigma->0 by default, TOTEN when force_consistent
    assert read_outcar_energy(str(p)) == pytest.approx(-101.96882716)
    assert read_outcar_energy(str(p), force_consistent=True) == pytest.approx(-101.98765432)


def test_success_rate_from_outcars(tmp_path):
    from adsorbdiff_tpu_torch.eval_tools import min_energy_from_outcars, success_rate_from_outcars

    # layout: <root>/vasp/{sid}_{fid}/OUTCAR with OC20-Dense style sids
    for run, e in [("12_345_67_0", -5.0), ("12_345_67_1", -6.5), ("98_76_54_0", -2.0)]:
        d = tmp_path / "vasp" / run
        d.mkdir(parents=True)
        (d / "OUTCAR").write_text(
            f"  free  energy   TOTEN  =      {e - 0.01} eV\n"
            f"  energy  without entropy=     {e}  energy(sigma->0) =     {e}\n"
        )
    ref = {"12_345_67": -1.0, "98_76_54": 0.0}
    best = min_energy_from_outcars(str(tmp_path), ref_energies=ref)
    assert best["12_345_67"][0] == pytest.approx(-5.5)  # -6.5 - (-1.0)
    assert best["98_76_54"][0] == pytest.approx(-2.0)

    dft = {"12_345_67": -5.55, "98_76_54": -3.0}
    rate, per = success_rate_from_outcars(str(tmp_path), dft, ref_energies=ref)
    assert per["12_345_67"] is True and per["98_76_54"] is False
    assert rate == pytest.approx(0.5)


def test_parse_sid_fid():
    from adsorbdiff_tpu_torch.eval_tools import parse_sid_fid

    assert parse_sid_fid("12_345_67_3.traj") == ("12_345_67", "3")
    assert parse_sid_fid("12_345_67.traj") == ("12_345_67", "0")
    assert parse_sid_fid("/a/b/881.adtraj.npz") == ("881", "0")


def test_success_rate_nsite_layout(tmp_path):
    """<root>/<seed>/relaxations layout, the 3-stage pipeline output."""
    from adsorbdiff_tpu_torch.eval_tools import nsite_traj_dirs, success_rate_nsite

    for seed, e in [(0, -1.0), (1, -3.0)]:
        d = tmp_path / str(seed) / "relaxations"
        d.mkdir(parents=True)
        make_traj(d, 7, e)
    assert len(nsite_traj_dirs(str(tmp_path))) == 2
    rate, per = success_rate_nsite(str(tmp_path), {"7": -3.05})
    assert per["7"] is True and rate == pytest.approx(1.0)


def test_success_rate_from_npz(tmp_path):
    """Energies from a predictions npz keyed {sid}_{fid}; anomalies from trajs."""
    from adsorbdiff_tpu_torch.eval_tools import success_rate_from_npz

    d = tmp_path / "trajs"
    d.mkdir()
    make_traj(d, 5, +99.0)  # traj energy is IGNORED (npz wins)
    make_traj(d, 6, -0.5, desorbed=True)  # anomalous -> filtered even with npz energy
    np.savez(
        tmp_path / "preds.npz",
        ids=np.array(["5_0", "6_0"]),
        energy=np.array([-4.0, -9.0], np.float32),
    )
    dft = {"5": -4.05, "6": -9.0}
    rate, per = success_rate_from_npz(str(tmp_path / "preds.npz"), [str(d)], dft)
    assert per["5"] is True  # npz energy -4.0 vs dft -4.05
    assert per["6"] is False  # only candidate desorbed -> failure
    assert rate == pytest.approx(0.5)


def test_covalent_radii_table_is_the_jax_packages():
    from adsorbdiff_tpu.placement.flag_anomaly import COVALENT_RADII as JAX_RADII

    np.testing.assert_array_equal(COVALENT_RADII, JAX_RADII)


def test_success_rate_and_anomalies_match_jax(tmp_path):
    """One nsite tree scored by both packages: equal rate and per-system
    dict, equal best energies and sources, equal anomaly flags."""
    from adsorbdiff_tpu import eval_tools as jax_eval
    from adsorbdiff_tpu_torch import eval_tools as port_eval

    rng = np.random.default_rng(5)
    for seed in range(3):
        d = tmp_path / str(seed) / "relaxations"
        d.mkdir(parents=True)
        for sid in range(6):
            z = [4.0, 15.0, 0.0, 4.2][(sid + seed) % 4]  # clean, desorbed, intercalated, clean
            make_traj(d, sid, float(rng.normal(-2.0, 0.5)), desorbed=z == 15.0)
            if z == 0.0:
                t = Trajectory.load(str(d / str(sid)))
                t.positions[-1, -2:, 2] -= 4.0
                t.save(str(d / str(sid)))
    dft = {str(sid): -2.0 + 0.05 * sid for sid in range(7)}
    dirs = port_eval.nsite_traj_dirs(str(tmp_path))
    assert dirs == jax_eval.nsite_traj_dirs(str(tmp_path)) and len(dirs) == 3
    assert port_eval.success_rate(dirs, dft) == jax_eval.success_rate(dirs, dft)
    assert port_eval.min_energy_per_system(dirs) == jax_eval.min_energy_per_system(dirs)
    for path in sorted(tmp_path.glob("*/relaxations/*.adtraj.npz")):
        np.testing.assert_array_equal(port_eval.anomalous_structure(Trajectory.load(str(path))),
                                      jax_eval.anomalous_structure(jax_eval.Trajectory.load(str(path))))
