"""PyTorch port: the placement toolkit against the JAX package.

Both packages' placement modules are numpy and scipy only, and the port's
copies their arithmetic, so every comparison here is exact: positions, tags,
fixed masks, sites, sampled angles and metadata from the same
``np.random.default_rng`` seeds are equal bit for bit (``np.array_equal``,
``==`` on scalars and metadata dicts).
"""
import filecmp
import pickle
import sys
import types

import numpy as np
import pytest

import adsorbdiff_tpu.placement.adsorbate as jax_adsorbate
import adsorbdiff_tpu.placement.adsorbate_slab_config as jax_config
import adsorbdiff_tpu.placement.bulk as jax_bulk
import adsorbdiff_tpu.placement.slab as jax_slab
import adsorbdiff_tpu.placement.voronoi as jax_voronoi
import adsorbdiff_tpu.runtime.atoms as jax_atoms
import adsorbdiff_tpu_torch.placement.adsorbate as t_adsorbate
import adsorbdiff_tpu_torch.placement.adsorbate_slab_config as t_config
import adsorbdiff_tpu_torch.placement.bulk as t_bulk
import adsorbdiff_tpu_torch.placement.slab as t_slab
import adsorbdiff_tpu_torch.placement.voronoi as t_voronoi
import adsorbdiff_tpu_torch.runtime.atoms as t_atoms
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

JAX = types.SimpleNamespace(atoms=jax_atoms, slab=jax_slab, bulk=jax_bulk, adsorbate=jax_adsorbate,
                            config=jax_config, voronoi=jax_voronoi)
PORT = types.SimpleNamespace(atoms=t_atoms, slab=t_slab, bulk=t_bulk, adsorbate=t_adsorbate,
                             config=t_config, voronoi=t_voronoi)
BOTH = (PORT, JAX)

ATOM_FIELDS = ("positions", "numbers", "cell", "tags", "fixed")


def assert_same_atoms(got, want):
    for name in ATOM_FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.pbc == want.pbc and got.sid == want.sid and got.fid == want.fid


def fcc_bulk(pkg, a=3.61, z=29):
    cell = np.eye(3) * a
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    return pkg.bulk.Bulk(bulk_atoms=pkg.atoms.Atoms(positions=frac @ cell, numbers=[z] * 4, cell=cell),
                         src_id="mp-30")


def cscl_bulk(pkg):
    a = 4.12
    atoms = pkg.atoms.Atoms(positions=[[0, 0, 0], [a / 2, a / 2, a / 2]], numbers=[55, 17], cell=np.eye(3) * a)
    return pkg.bulk.Bulk(bulk_atoms=atoms, src_id="mp-22865")


def l12_bulk(pkg, numbers=(46, 46, 46, 42), a=3.89):
    cell = np.eye(3) * a
    frac = np.array([[0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5], [0, 0, 0]])
    return pkg.bulk.Bulk(bulk_atoms=pkg.atoms.Atoms(positions=frac @ cell, numbers=list(numbers), cell=cell),
                         src_id="Pd3Mo")


BULKS = {"fcc": fcc_bulk, "cscl": cscl_bulk, "l12": l12_bulk}


def co_adsorbate(pkg):
    atoms = pkg.atoms.Atoms(positions=[[0, 0, 0], [0, 0, 1.15]], numbers=[6, 8], cell=np.eye(3) * 20,
                            pbc=(False,) * 3)
    return pkg.adsorbate.Adsorbate(adsorbate_atoms=atoms, binding_indices=[0], smiles="*CO")


def nnh_adsorbate(pkg):
    return pkg.adsorbate.Adsorbate(adsorbate_smiles_from_db="*N*NH")


def fcc111_slab(pkg, vacancy=False, a=3.61, nxy=3, layers=4):
    """tests/test_placement.py's ideal fcc(111) slab, ABC stacking, with one
    top-layer atom removed for ``vacancy``."""
    a_s, dz = a / np.sqrt(2.0), a / np.sqrt(3.0)
    a1, a2 = np.array([a_s, 0.0, 0.0]), np.array([a_s / 2, a_s * np.sqrt(3) / 2, 0.0])
    stack = [(0.0, 0.0), (1 / 3, 1 / 3), (2 / 3, 2 / 3)]
    pos = []
    for il in range(layers):
        ox, oy = stack[il % 3]
        for i in range(nxy):
            for j in range(nxy):
                p = (i + ox) * a1 + (j + oy) * a2
                pos.append([p[0], p[1], il * dz])
    pos = np.array(pos)
    if vacancy:
        pos = np.delete(pos, len(pos) - 1, axis=0)
    cell = np.array([nxy * a1, nxy * a2, [0, 0, (layers - 1) * dz + 15.0]])
    return pkg.atoms.Atoms(positions=pos, numbers=[29] * len(pos), cell=cell)


def cu100_slab(pkg):
    return pkg.slab.Slab.from_bulk_get_specific_millers((1, 0, 0), fcc_bulk(pkg))[0]


# ---------------------------------------------------------------- slabs
@pytest.mark.parametrize("max_miller", [1, 2, 3])
def test_enumerate_millers_matches_jax(max_miller):
    assert t_slab.enumerate_millers(max_miller) == jax_slab.enumerate_millers(max_miller)


@pytest.mark.parametrize("bulk,millers", [("fcc", (1, 0, 0)), ("fcc", (1, 1, 1)), ("fcc", (2, 1, 0)),
                                          ("fcc", (1, 1, 0)), ("cscl", (0, 0, 1)), ("cscl", (1, 1, 0)),
                                          ("l12", (1, 1, 1)), ("l12", (2, 1, 1))])
def test_compute_slabs_and_terminations_match_jax(bulk, millers):
    """Every termination (shift, top, flipped bottoms), its fingerprint, and
    the tiled, tagged and constrained slab built from it."""
    got = t_slab.compute_slabs(BULKS[bulk](PORT).atoms, millers=millers, layers=3, vacuum=12.0)
    want = jax_slab.compute_slabs(BULKS[bulk](JAX).atoms, millers=millers, layers=3, vacuum=12.0)
    assert len(got) == len(want) >= 1
    for (g, g_shift, g_top), (w, w_shift, w_top) in zip(got, want):
        assert_same_atoms(g, w)
        assert (g_shift, g_top) == (w_shift, w_top)
        assert t_slab.termination_fingerprint(g) == jax_slab.termination_fingerprint(w)
        assert_same_atoms(t_slab.tile_and_tag_atoms(g), jax_slab.tile_and_tag_atoms(w))
    if bulk == "cscl" and millers == (0, 0, 1):  # the binary's two terminations
        assert len(got) == 2


@pytest.mark.parametrize("bulk", ["cscl", "l12"])
def test_flip_and_tile_match_jax(bulk):
    (g, _, _), *_ = t_slab.compute_slabs(BULKS[bulk](PORT).atoms, millers=(0, 0, 1), layers=3)
    (w, _, _), *_ = jax_slab.compute_slabs(BULKS[bulk](JAX).atoms, millers=(0, 0, 1), layers=3)
    assert_same_atoms(t_slab.flip_slab(g), jax_slab.flip_slab(w))
    for min_ab in (4.0, 8.0, 13.0):
        assert_same_atoms(t_slab.tile_atoms(g, min_ab=min_ab), jax_slab.tile_atoms(w, min_ab=min_ab))


def test_slab_constructors_match_jax():
    """from_atoms, from_bulk_get_random_slab on one seed, get_slabs, and
    the metadata dicts."""
    got = t_slab.Slab.from_atoms(fcc111_slab(PORT), millers=(1, 1, 1))
    want = jax_slab.Slab.from_atoms(fcc111_slab(JAX), millers=(1, 1, 1))
    assert_same_atoms(got.atoms, want.atoms)
    for seed in (0, 5):
        g = t_slab.Slab.from_bulk_get_random_slab(l12_bulk(PORT), rng=np.random.default_rng(seed))
        w = jax_slab.Slab.from_bulk_get_random_slab(l12_bulk(JAX), rng=np.random.default_rng(seed))
        assert_same_atoms(g.atoms, w.atoms)
        assert g.get_metadata_dict()["slab_metadata"] == w.get_metadata_dict()["slab_metadata"]
    g_all, w_all = fcc_bulk(PORT).get_slabs(max_miller=2), fcc_bulk(JAX).get_slabs(max_miller=2)
    assert len(g_all) == len(w_all) > 3
    for g, w in zip(g_all, w_all):
        assert_same_atoms(g.atoms, w.atoms)
        assert g.get_metadata_dict()["slab_metadata"] == w.get_metadata_dict()["slab_metadata"]
        assert g.has_surface_tagged() and repr(g) == repr(w)


# ---------------------------------------------------------------- surface tags
@pytest.mark.parametrize("case", ["fcc111", "fcc111-vacancy", "cu100", "cscl001"])
def test_surface_tags_match_jax(case):
    """Tags by height, by coordination, and by Voronoi refinement (the
    subsurface-vacancy fcc(111) slab of tests/test_placement.py:335 is the
    case where Voronoi adds atoms)."""
    def slab_and_bulk(pkg):
        if case.startswith("fcc111"):
            return fcc111_slab(pkg, vacancy=case.endswith("vacancy")), fcc_bulk(pkg).atoms
        if case == "cu100":
            return cu100_slab(pkg).atoms, fcc_bulk(pkg).atoms
        bulk = cscl_bulk(pkg)
        return pkg.slab.compute_slabs(bulk.atoms, millers=(0, 0, 1), layers=3)[0][0], bulk.atoms

    (g_slab, g_bulk), (w_slab, w_bulk) = slab_and_bulk(PORT), slab_and_bulk(JAX)
    for fn in ("find_surface_atoms_by_height", "find_surface_atoms_by_coordination"):
        g, w = getattr(t_slab, fn)(g_slab), getattr(jax_slab, fn)(w_slab)
        assert g.dtype == w.dtype and np.array_equal(g, w), fn
    height = t_slab.tag_surface_atoms(g_slab)
    voronoi = t_slab.tag_surface_atoms(g_slab, bulk_atoms=g_bulk)
    assert_same_atoms(height, jax_slab.tag_surface_atoms(w_slab))
    assert_same_atoms(voronoi, jax_slab.tag_surface_atoms(w_slab, bulk_atoms=w_bulk))
    assert_same_atoms(t_slab.set_fixed_atom_constraints(voronoi),
                      jax_slab.set_fixed_atom_constraints(jax_slab.tag_surface_atoms(w_slab, bulk_atoms=w_bulk)))
    if case == "fcc111-vacancy":
        assert (voronoi.tags & ~height.tags).sum() == 3


@pytest.mark.parametrize("bulk", ["fcc", "cscl", "l12"])
def test_voronoi_cns_match_jax(bulk):
    g_atoms, w_atoms = BULKS[bulk](PORT).atoms, BULKS[bulk](JAX).atoms
    g = t_voronoi.voronoi_weighted_cns(g_atoms.positions, g_atoms.cell)
    w = jax_voronoi.voronoi_weighted_cns(w_atoms.positions, w_atoms.cell)
    assert np.array_equal(g, w)
    assert (t_voronoi.calculate_coordination_of_bulk_atoms(g_atoms)
            == jax_voronoi.calculate_coordination_of_bulk_atoms(w_atoms))


# ---------------------------------------------------------------- sites and rotations
@pytest.mark.parametrize("case", ["cu100", "square"])
def test_heuristic_sites_match_jax(case):
    def atoms(pkg):
        if case == "cu100":
            return cu100_slab(pkg).atoms
        return pkg.atoms.Atoms(positions=[[0.0, 0.0, 10.0], [0.0, 0.0, 8.0]], numbers=[29, 29],
                               cell=np.diag([2.5, 2.5, 20.0]), tags=[1, 0], pbc=(True, True, False))

    got, want = t_config.heuristic_adsorption_sites(atoms(PORT)), jax_config.heuristic_adsorption_sites(atoms(JAX))
    assert len(got) >= 3 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sites_on_triangle_match_jax(seed):
    vertices = np.random.default_rng(100 + seed).random((3, 3)) * 5
    got = t_config.get_random_sites_on_triangle(vertices, 50, np.random.default_rng(seed))
    want = jax_config.get_random_sites_on_triangle(vertices, 50, np.random.default_rng(seed))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["random", "heuristic", "random_site_heuristic_placement"])
def test_randomly_rotate_adsorbate_matches_jax(mode):
    binding = None if mode == "random" else 0
    for seed in range(3):
        g, g_angles = t_adsorbate.randomly_rotate_adsorbate(nnh_adsorbate(PORT).atoms, mode, binding,
                                                            np.random.default_rng(seed))
        w, w_angles = jax_adsorbate.randomly_rotate_adsorbate(nnh_adsorbate(JAX).atoms, mode, binding,
                                                              np.random.default_rng(seed))
        assert_same_atoms(g, w)
        assert np.array_equal(g_angles, w_angles)


@pytest.mark.parametrize("mode", ["random", "heuristic", "random_site_heuristic_placement"])
@pytest.mark.parametrize("adsorbate", ["CO", "NNH"])
def test_adsorbate_slab_config_matches_jax(mode, adsorbate):
    """Sites, placed adslabs, sampled angles and every metadata dict, and
    the overlap measures on the placements."""
    make = co_adsorbate if adsorbate == "CO" else nnh_adsorbate
    got = t_config.AdsorbateSlabConfig(cu100_slab(PORT), make(PORT), num_sites=6, mode=mode,
                                       rng=np.random.default_rng(3))
    want = jax_config.AdsorbateSlabConfig(cu100_slab(JAX), make(JAX), num_sites=6, mode=mode,
                                          rng=np.random.default_rng(3))
    assert np.array_equal(got.sites, want.sites) and len(got.atoms_list) == len(want.atoms_list) >= 1
    for i, (g, w) in enumerate(zip(got.atoms_list, want.atoms_list)):
        assert_same_atoms(g, w)
        for key in ("site", "xyz_angles"):
            assert np.array_equal(got.metadata_list[i][key], want.metadata_list[i][key])
        g_md, w_md = got.get_metadata_dict(i), want.get_metadata_dict(i)
        assert_same_atoms(g_md["adsorbed_slab_atomsobject"], w_md["adsorbed_slab_atomsobject"])
        arrays = ("site", "xyz_angles")
        for key in arrays:
            assert np.array_equal(g_md["adsorbed_slab_metadata"][key], w_md["adsorbed_slab_metadata"][key])
        assert ({k: v for k, v in g_md["adsorbed_slab_metadata"].items() if k not in arrays}
                == {k: v for k, v in w_md["adsorbed_slab_metadata"].items() if k not in arrays})
        assert np.array_equal(t_config.get_interstitial_distances(g), jax_config.get_interstitial_distances(w))
        assert t_config.there_is_overlap(g) == jax_config.there_is_overlap(w)


# ---------------------------------------------------------------- adsorbates, bulks, the asset
def test_asset_is_the_jax_packages_and_loads_the_same():
    assert filecmp.cmp(t_adsorbate._ASSET_DB, jax_adsorbate._ASSET_DB, shallow=False)
    assert "adsorbdiff_tpu_torch" in t_adsorbate._ASSET_DB
    got, want = t_adsorbate._load_db(None), jax_adsorbate._load_db(None)
    assert sorted(got) == sorted(want) and len(got) == 86
    for k in want:
        assert_same_atoms(got[k][0], want[k][0])
        assert got[k][1:] == want[k][1:]


def test_adsorbate_constructors_match_jax():
    for kw in (dict(adsorbate_id_from_db=0), dict(adsorbate_id_from_db=41), dict(adsorbate_smiles_from_db="*CO")):
        g, w = t_adsorbate.Adsorbate(**kw), jax_adsorbate.Adsorbate(**kw)
        assert_same_atoms(g.atoms, w.atoms)
        assert (g.smiles, g.binding_indices, g.adsorbate_id_from_db, repr(g)) == (
            w.smiles, w.binding_indices, w.adsorbate_id_from_db, repr(w))
    for seed in (0, 3, 9):
        g = t_adsorbate.Adsorbate(rng=np.random.default_rng(seed))
        w = jax_adsorbate.Adsorbate(rng=np.random.default_rng(seed))
        assert_same_atoms(g.atoms, w.atoms)
        assert (g.smiles, g.adsorbate_id_from_db) == (w.smiles, w.adsorbate_id_from_db)


class _Shim:
    """An object pickled under an ``ase.*`` name (ase is not installed)."""


def _ase_pickle(path, entries, monkeypatch):
    """Write a reference-style ``adsorbates.pkl``: ``{id: (ase.Atoms,
    smiles, binding, reaction)}``, each Atoms with the ``arrays`` dict and
    ``_cellobj.array`` that the unpickler shim reads."""
    ase_atoms = type("Atoms", (_Shim,), {"__module__": "ase.atoms"})
    ase_cell = type("Cell", (_Shim,), {"__module__": "ase.cell"})
    for name, cls in (("ase", None), ("ase.atoms", ase_atoms), ("ase.cell", ase_cell)):
        module = types.ModuleType(name)
        if cls is not None:
            setattr(module, cls.__name__, cls)
        monkeypatch.setitem(sys.modules, name, module)
    db = {}
    for i, (pos, numbers, smiles, binding, reaction) in entries.items():
        atoms, cell = ase_atoms(), ase_cell()
        cell.array = np.zeros((3, 3))
        atoms.arrays = {"positions": np.asarray(pos, float), "numbers": np.asarray(numbers, int),
                        "tags": np.zeros(len(numbers), int)}
        atoms._cellobj = cell
        db[i] = (atoms, smiles, binding, reaction)
    with open(path, "wb") as f:
        pickle.dump(db, f)


def test_convert_db_to_npz_round_trips_like_jax(tmp_path, monkeypatch):
    """A small reference-style pickle through both packages' shim
    unpickler and ``convert_db_to_npz``: equal databases, equal npz files'
    arrays, and the npz reading back as the pickle."""
    rng = np.random.default_rng(4)
    entries = {0: (rng.random((1, 3)), [8], "*O", [0], "O -> *O"),
               7: (rng.random((3, 3)), [7, 7, 1], "*N*NH", [0, 1], "N2 -> *N*NH"),
               12: (rng.random((2, 3)), [6, 8], "*CO", 0, "CO -> *CO")}
    pkl = str(tmp_path / "adsorbates.pkl")
    _ase_pickle(pkl, entries, monkeypatch)
    for name in ("ase", "ase.atoms", "ase.cell"):
        monkeypatch.delitem(sys.modules, name)  # the unpickler must not need them
    got, want = t_adsorbate._load_db(pkl), jax_adsorbate._load_db(pkl)
    assert sorted(got) == sorted(want) == [0, 7, 12]
    for k in want:
        assert_same_atoms(got[k][0], want[k][0])
        assert got[k][1:] == want[k][1:]
    out_t, out_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert t_adsorbate.convert_db_to_npz(pkl, out_t) == jax_adsorbate.convert_db_to_npz(pkl, out_j) == 3
    with np.load(out_t) as a, np.load(out_j) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    back = t_adsorbate._load_db(out_t)
    for k in got:
        np.testing.assert_array_equal(back[k][0].positions, got[k][0].positions)
        np.testing.assert_array_equal(back[k][0].numbers, got[k][0].numbers)
        assert back[k][1] == got[k][1] and back[k][2] == list(np.atleast_1d(got[k][2])) and back[k][3] == got[k][3]
    ads = t_adsorbate.Adsorbate(adsorbate_smiles_from_db="*N*NH", adsorbate_db_path=out_t)
    assert ads.binding_indices == [0, 1] and ads.adsorbate_id_from_db == 7


def test_bulk_from_db_matches_jax(tmp_path):
    """A pickled bulk DB (one per package, of the same arrays): the same id
    drawn from one seed, the same atoms and src_id."""
    rng = np.random.default_rng(8)
    arrays = [(rng.random((n, 3)) * 4, rng.integers(20, 80, n), np.eye(3) * 4) for n in (2, 4, 3, 5)]
    paths = {}
    for label, pkg in (("port", PORT), ("jax", JAX)):
        db = [(pkg.atoms.Atoms(positions=p, numbers=z, cell=c), f"mp-{i}") for i, (p, z, c) in enumerate(arrays)]
        paths[label] = str(tmp_path / f"{label}.pkl")
        with open(paths[label], "wb") as f:
            pickle.dump(db, f)
    for seed in (0, 1, 2):
        g = t_bulk.Bulk(bulk_db_path=paths["port"], rng=np.random.default_rng(seed))
        w = jax_bulk.Bulk(bulk_db_path=paths["jax"], rng=np.random.default_rng(seed))
        assert (g.bulk_id_from_db, g.src_id, repr(g)) == (w.bulk_id_from_db, w.src_id, repr(w))
        assert_same_atoms(g.atoms, w.atoms)
    g = t_bulk.Bulk(bulk_id_from_db=2, bulk_db_path=paths["port"])
    assert g.src_id == "mp-2" and len(g) == 3


def test_package_exports():
    from adsorbdiff_tpu_torch.placement import Adsorbate, AdsorbateSlabConfig, Bulk, DetectTrajAnomaly, Slab
    from adsorbdiff_tpu_torch.placement.flag_anomaly import COVALENT_RADII

    assert (Adsorbate, AdsorbateSlabConfig, Bulk, Slab) == (t_adsorbate.Adsorbate, t_config.AdsorbateSlabConfig,
                                                           t_bulk.Bulk, t_slab.Slab)
    assert DetectTrajAnomaly.__module__ == "adsorbdiff_tpu_torch.placement.flag_anomaly"
    assert t_config.COVALENT_RADII is COVALENT_RADII
