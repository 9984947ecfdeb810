"""PyTorch port: the whole PaiNN against the JAX model, the reference
fixture, the weight round trip and equivariance.

Tolerance atol 5e-5, rtol 1e-4 against JAX: f32 sums of K and R terms taken
in another order, grown over the layers (the tolerance JAX's own
Pallas-vs-XLA parity test uses).
"""
import os

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from adsorbdiff_tpu.models.painn import PaiNN as JaxPaiNN
from adsorbdiff_tpu.train.torch_import import painn_state_dict_to_params
from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch.models.layers import RadialBasis
from adsorbdiff_tpu_torch.models.painn import PaiNN, painn_state_dict_from_jax
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_painn import MODEL_KW, make_batch
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "painn_golden.npz")
FIXTURE_KW = dict(hidden_channels=32, num_layers=2, num_rbf=8, cutoff=6.0, max_neighbors=32, cell_reps=(1, 1, 0))


@pytest.fixture(scope="module")
def jax_variables():
    """JAX init with non-unit scale factors, as numpy."""
    batch = make_batch(np.random.default_rng(3))
    variables = JaxPaiNN(**MODEL_KW, so3_denoising=True).init(jax.random.PRNGKey(0), batch)
    variables = jax.tree.map(np.asarray, dict(variables))
    for i, name in enumerate(sorted(variables["scale_factors"])):
        variables["scale_factors"][name] = {"scale": np.float32(0.8 + 0.1 * i)}
    return variables


def _port(variables, **kw) -> PaiNN:
    model = PaiNN(**MODEL_KW, device="cpu", **kw)
    model.load_state_dict(painn_state_dict_from_jax(variables))
    return model


@pytest.mark.parametrize("use_pallas", [True, False], ids=["jax-pallas", "jax-xla"])
def test_painn_matches_jax(jax_variables, use_pallas):
    batch = make_batch(np.random.default_rng(7))
    jmodel = JaxPaiNN(**MODEL_KW, so3_denoising=True, use_pallas=use_pallas, sampling=use_pallas)
    want = jmodel.apply(jax_variables, batch)
    with torch.no_grad():
        got = _port(jax_variables)(to_torch_batch(batch))
    for g, w in zip(got, want):
        assert g.shape == (2, 24, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)
    assert not got[0][:, 20:].any()  # padded rows are exactly zero


def test_painn_static_graph_matches_jax(jax_variables):
    """With the hoisted slab-slab graph, after the adsorbate moved."""
    rng = np.random.default_rng(8)
    batch = make_batch(rng)
    jmodel = JaxPaiNN(**MODEL_KW, so3_denoising=True, use_pallas=True, sampling=True, max_ads=8)
    static = jmodel.prepare_static(batch)
    delta = np.zeros(batch.pos.shape, np.float32)
    ads = np.asarray(batch.ads_mask)
    delta[ads] = rng.normal(0, 0.8, (int(ads.sum()), 3))
    moved = batch.replace(pos=batch.pos + delta)
    want = jmodel.apply(jax_variables, moved, static)

    model = _port(jax_variables, max_ads=8)
    with torch.no_grad():
        got = model(to_torch_batch(moved), model.prepare_static(to_torch_batch(batch)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)


def test_reference_state_dict_loads_and_matches_golden():
    """tests/fixtures/painn_golden.npz: a reference-named state dict loads
    with load_state_dict as it is and reproduces the reference outputs."""
    data = np.load(FIXTURE)
    sd = {k[len("sd."):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd.")}
    model = PaiNN(**FIXTURE_KW, device="cpu")
    model.load_state_dict(sd)  # strict: same names, same shapes
    systems = []
    for i in range(int(data["n_systems"])):
        n = int(data[f"natoms.{i}"])
        systems.append(System(pos=data["pos"][i, :n], atomic_numbers=data["z"][i, :n],
                              cell=data["cell"][i], tags=data["tags"][i, :n], sid=i))
    batch = collate(systems, max_atoms=data["pos"].shape[1], device="cpu")
    with torch.no_grad():
        f1, f2 = model(batch)
    mask = to_numpy(batch.atom_mask)
    # the tolerance of tests/test_torch_import.py
    np.testing.assert_allclose(f1.numpy()[mask], data["out1"][mask], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(f2.numpy()[mask], data["out2"][mask], atol=2e-5, rtol=1e-4)


def test_weight_round_trip_through_torch_import_is_exact(jax_variables):
    sd = painn_state_dict_from_jax(jax_variables)
    assert set(sd) == set(PaiNN(**MODEL_KW, device="cpu").state_dict())
    back = painn_state_dict_to_params({k: v.numpy() for k, v in sd.items()}, num_layers=MODEL_KW["num_layers"])
    flat_want = jax.tree_util.tree_flatten_with_path(jax_variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want), err_msg=str(path))


def test_port_rotation_equivariance():
    batch = to_torch_batch(make_batch(np.random.default_rng(9)))
    model = PaiNN(**MODEL_KW, device="cpu", generator=torch.Generator().manual_seed(0))
    r = torch.from_numpy(Rotation.random(random_state=7).as_matrix().astype(np.float32))
    rot = batch.replace(
        pos=batch.pos @ r.T, pos_relaxed=batch.pos_relaxed @ r.T, cell=batch.cell @ r.T,
    )
    with torch.no_grad():
        f1, f2 = model(batch)
        g1, g2 = model(rot)
    np.testing.assert_allclose(g1.numpy(), (f1 @ r.T).numpy(), atol=2e-4)
    np.testing.assert_allclose(g2.numpy(), (f2 @ r.T).numpy(), atol=2e-4)


@pytest.mark.parametrize("envelope", [{"name": "polynomial", "exponent": 5}, {"name": "exponential"}])
def test_radial_basis_matches_jax(envelope):
    from adsorbdiff_tpu.models.layers import RadialBasis as JaxRadialBasis

    d = np.random.default_rng(10).uniform(0, 7, (5, 9)).astype(np.float32)
    jrb = JaxRadialBasis(num_radial=16, cutoff=6.0, rbf={"name": "gaussian"}, envelope=envelope)
    want = jrb.apply({}, d)
    got = RadialBasis(16, 6.0, rbf={"name": "gaussian"}, envelope=envelope)(torch.from_numpy(d))
    # f32 powers of d/cutoff are evaluated differently by XLA and PyTorch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [dict(mode="s2ef"), dict(compute_dtype="bfloat16"), dict(tag_based_z=True), dict(energy_encoding="scalar"),
     dict(rbf={"name": "spherical_bessel"})],
    ids=["s2ef", "bfloat16", "tag_based_z", "energy_encoding", "bessel"],
)
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        PaiNN(**MODEL_KW, device="cpu", **kw)
