"""PyTorch port: GemNet-OC (s2ef) against the JAX model and the reference oracle.

The port's quadruplet interaction always runs ``gemnet_quad_chain`` and its
triplet bases ``gemnet_cbf_bases``, one call a forward (on the CPU: their
plain versions); the
JAX model is run with its fused quad kernel and with its unfused einsum
chain, each with and without ``use_pallas`` (Pallas in interpret mode).

Tolerances: energy and forces atol 5e-5 / rtol 1e-4 against JAX (f32 sums
over 2 blocks of dense, triplet and quadruplet contractions taken in another
order); the oracle golden at its own test's tolerances
(``tests/test_torch_import.py``: energy 1e-4 * max(1, |e|), forces atol 5e-6 /
rtol 5e-4); rotation 2e-4 (f32 geometry under a rotation).
"""
import collections
import itertools

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from adsorbdiff_tpu.models.gemnet_oc import GemNetOC as JaxGemNetOC
from adsorbdiff_tpu.models.gemnet_oc import _same_edge as jax_same_edge
from adsorbdiff_tpu.train.torch_import import gemnet_state_dict_to_params
from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC, _img_key, _same_edge, gemnet_state_dict_from_jax
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_gemnet_oc import TINY
from tests.test_model_goldens import GOLDEN
from tests.test_painn import make_batch
from tests.test_torch_import import (
    GEMNET_GOLDEN,
    GEMNET_MAP_KW,
    GEMNET_ORACLE_KW,
    _gemnet_oracle_system,
)
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX TINY model's variables and outputs (fused and unfused quad),
    jitted: eager first calls cost more than the compiles here."""
    batch = make_batch(np.random.default_rng(3))
    variables = jax.jit(JaxGemNetOC(**TINY).init)(jax.random.PRNGKey(0), batch)
    outs = {fused: jax.jit(JaxGemNetOC(**TINY, fused_quad=fused).apply)(variables, batch) for fused in (False, True)}
    return batch, variables, outs


@pytest.fixture(scope="module")
def jax_tiny_pallas(jax_tiny):
    """The JAX TINY model with ``use_pallas=True`` (its masked Legendre
    kernels in interpret mode, patched as tests/test_pallas_kernels.py:486
    does), fused and unfused quad, on the same weights."""
    import functools

    import adsorbdiff_tpu.ops.pallas_kernels as pk

    batch, variables, _ = jax_tiny
    orig_q, orig_c = pk.gemnet_quad_basis, pk.gemnet_cbf_basis
    pk.gemnet_quad_basis = functools.partial(orig_q, interpret=True)
    pk.gemnet_cbf_basis = functools.partial(orig_c, interpret=True)
    try:
        return {fused: jax.jit(JaxGemNetOC(**TINY, use_pallas=True, fused_quad=fused).apply)(variables, batch)
                for fused in (False, True)}
    finally:
        pk.gemnet_quad_basis, pk.gemnet_cbf_basis = orig_q, orig_c


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    _, variables, _ = jax_tiny
    model = GemNetOC(**TINY, device="cpu")
    model.load_state_dict(gemnet_state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("fused_quad", [False, True], ids=["jax-einsum-quad", "jax-fused-quad"])
def test_tiny_matches_jax(jax_tiny, port_tiny, fused_quad):
    batch, _, outs = jax_tiny
    with torch.no_grad():
        got = port_tiny(to_torch_batch(batch))
    want = outs[fused_quad]
    np.testing.assert_allclose(to_numpy(got["energy"]), np.asarray(want["energy"]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(to_numpy(got["forces"]), np.asarray(want["forces"]), atol=5e-5, rtol=1e-4)
    assert not to_numpy(got["forces"])[:, 20:].any()  # padded atoms


@pytest.mark.parametrize("fused_quad", [False, True], ids=["jax-pallas-quad-basis", "jax-fused-quad"])
def test_tiny_matches_jax_use_pallas(jax_tiny, jax_tiny_pallas, port_tiny, fused_quad):
    """Against JAX ``GemNetOC(use_pallas=True)``: its e2e and a2e bases from
    ``gemnet_cbf_basis`` (and, unfused, the dihedral basis from
    ``gemnet_quad_basis``) in interpret mode; the port's three triplet bases
    come from its own ``gemnet_cbf_basis`` (the plain version on the CPU)."""
    with torch.no_grad():
        got = port_tiny(to_torch_batch(jax_tiny[0]))
    want = jax_tiny_pallas[fused_quad]
    np.testing.assert_allclose(to_numpy(got["energy"]), np.asarray(want["energy"]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(to_numpy(got["forces"]), np.asarray(want["forces"]), atol=5e-5, rtol=1e-4)


def test_use_pallas_is_accepted_and_changes_nothing(jax_tiny, port_tiny):
    model = GemNetOC(**TINY, use_pallas=True, device="cpu")
    model.load_state_dict(port_tiny.state_dict(), strict=True)
    batch = to_torch_batch(jax_tiny[0])
    with torch.no_grad():
        got, want = model(batch), port_tiny(batch)
    for key in ("energy", "forces"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize(
    "kw",
    [dict(derive_subgraphs=False), dict(cutoff_qint=7.0, max_neighbors_aeaint=14)],
    ids=["derive-off", "beyond-main-graph"],
)
def test_tiny_separate_subgraphs_match_jax(jax_tiny, port_tiny, kw):
    """The aeaint and qint graphs built on their own: with derivation off, or
    with a qint cutoff and an aeaint width beyond the main graph's (so
    neither can be a K-prefix view of it)."""
    batch, variables, _ = jax_tiny
    want = jax.jit(JaxGemNetOC(**dict(TINY, **kw)).apply)(variables, batch)
    model = GemNetOC(**dict(TINY, **kw), device="cpu")
    assert not (model.derive_ae or model.derive_q)
    model.load_state_dict(port_tiny.state_dict(), strict=True)
    with torch.no_grad():
        got = model(to_torch_batch(batch))
    np.testing.assert_allclose(to_numpy(got["energy"]), np.asarray(want["energy"]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(to_numpy(got["forces"]), np.asarray(want["forces"]), atol=5e-5, rtol=1e-4)


def test_model_golden():
    """``tests/fixtures/model_goldens.npz`` (``gem_energy``/``gem_forces``, the
    JAX TINY model at PRNGKey(7) on ``make_batch(rng 77)``) through the port
    with the same weights, at the JAX comparison's tolerance."""
    golden = np.load(GOLDEN)
    batch = make_batch(np.random.default_rng(77))
    variables = jax.jit(JaxGemNetOC(**TINY).init)(jax.random.PRNGKey(7), batch)
    model = GemNetOC(**TINY, device="cpu")
    model.load_state_dict(gemnet_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model(to_torch_batch(batch))
    np.testing.assert_allclose(to_numpy(got["energy"]), golden["gem_energy"], atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(to_numpy(got["forces"]), golden["gem_forces"], atol=5e-5, rtol=1e-4)


def test_weight_round_trip(jax_tiny, port_tiny):
    """The port's state dict maps back onto the JAX variables exactly."""
    import flax

    _, variables, _ = jax_tiny
    sd = {k: v.numpy() for k, v in port_tiny.state_dict().items()}
    back = flax.traverse_util.flatten_dict(gemnet_state_dict_to_params(sd, **GEMNET_MAP_KW))
    want = flax.traverse_util.flatten_dict(jax.tree.map(np.asarray, dict(variables)))
    assert set(back) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def test_oracle_golden_loads_strict_and_matches():
    """The reference-named golden state dict loads as it is and the port
    reproduces the oracle's energy and forces (its qint and aeaint graphs are
    derived from the main table with smaller cutoffs)."""
    data = np.load(GEMNET_GOLDEN)
    sd = {k[len("sd."):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd.")}
    model = GemNetOC(**GEMNET_ORACLE_KW, max_neighbors=32, max_neighbors_qint=16, max_neighbors_aeaint=32,
                     cell_reps=(1, 1, 0), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    pos, z, tags, cell = _gemnet_oracle_system()
    batch = collate([System(pos=pos, atomic_numbers=z, cell=cell, tags=tags)], max_atoms=8, device="cpu")
    with torch.no_grad():
        out = model(batch)
    e_ref = float(data["energy"])
    assert abs(float(out["energy"][0]) - e_ref) <= 1e-4 * max(1.0, abs(e_ref))
    np.testing.assert_allclose(to_numpy(out["forces"])[0, :6], data["forces"], atol=5e-6, rtol=5e-4)


def test_rotation_invariance_and_equivariance(jax_tiny, port_tiny):
    batch = to_torch_batch(jax_tiny[0])
    r = torch.from_numpy(Rotation.random(random_state=11).as_matrix().astype(np.float32))
    rot = batch.replace(pos=batch.pos @ r.T, cell=batch.cell @ r.T)
    with torch.no_grad():
        out, out_r = port_tiny(batch), port_tiny(rot)
    np.testing.assert_allclose(to_numpy(out_r["energy"]), to_numpy(out["energy"]), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(to_numpy(out_r["forces"]), to_numpy(out["forces"] @ r.T), atol=2e-4)


def test_wide_image_key_is_exact_at_cell_reps_4():
    """Over all summed offsets in [-2R, 2R]^3 for R = 4 (and a few sources),
    two keys are equal exactly when the (source, offset) pairs are equal."""
    span = np.arange(-8, 9)
    offs = np.array(list(itertools.product(span, span, span)), np.int32)  # 4913 offsets
    src = np.repeat(np.array([0, 1, 7], np.int32), len(offs))
    off = np.tile(offs, (3, 1))
    keys = to_numpy(_img_key(torch.from_numpy(src), torch.from_numpy(off)))
    assert keys.dtype == np.int32 and (keys >= 0).all()
    assert len(np.unique(keys)) == len(keys)  # injective over the whole grid
    # pairwise against the field-wise test on a sample, including equal pairs
    rng = np.random.default_rng(0)
    i, j = rng.integers(0, len(src), 4000), rng.integers(0, len(src), 4000)
    j[:500] = i[:500]
    same = to_numpy(_same_edge(torch.from_numpy(src[i]), torch.from_numpy(off[i]),
                               torch.from_numpy(src[j]), torch.from_numpy(off[j])))
    np.testing.assert_array_equal(keys[i] == keys[j], same)
    np.testing.assert_array_equal(same, np.asarray(jax_same_edge(src[i], off[i], src[j], off[j])))


# configs/denoising/gemnet_so3.yml's mode at the TINY widths, one block (the s2ef cases above run two; one
# block halves the JAX compile)
SO3 = dict(TINY, num_blocks=1, mode="denoising", so3_denoising=True)


@pytest.fixture(scope="module")
def jax_so3():
    """A JAX denoising GemNet-OC with the scalar energy encoding (its
    variables hold every parameter the other cases need) on a batch with
    non-zero energies."""
    batch = make_batch(np.random.default_rng(5))
    batch = batch.replace(energy=np.asarray([0.9, -1.4], np.float32))
    variables = jax.jit(JaxGemNetOC(**SO3, energy_encoding="scalar").init)(jax.random.PRNGKey(1), batch)
    return batch, jax.tree.map(np.asarray, dict(variables))


def _so3_variables(variables, kw):
    if "energy_encoding" in kw:
        return variables
    return dict(variables, params={k: v for k, v in variables["params"].items() if k != "energy_embedding"})


def _port_so3(variables, **kw) -> GemNetOC:
    model = GemNetOC(**SO3, **kw, device="cpu")
    model.load_state_dict(gemnet_state_dict_from_jax(_so3_variables(variables, kw)), strict=True)
    return model


@pytest.mark.parametrize("kw", [dict(), dict(energy_encoding="scalar")], ids=["so3", "energy-scalar"])
def test_denoising_so3_matches_jax(jax_so3, kw):
    """mode="denoising" with so3_denoising: both heads against the JAX model
    (its fused quad) with converted weights (JAX case
    tests/test_gemnet_oc.py:164); with the scalar energy encoding the energy
    conditions both heads, and sampling=True zeroes it (the same weights give
    the conditioned model's output at zero energy)."""
    batch, variables = jax_so3
    want = jax.jit(JaxGemNetOC(**SO3, fused_quad=True, **kw).apply)(_so3_variables(variables, kw), batch)
    model = _port_so3(variables, **kw)
    with torch.no_grad():
        got = model(to_torch_batch(batch))
        shifted = model(to_torch_batch(batch.replace(energy=batch.energy + 2.0)))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 24, 3)
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=5e-5, rtol=1e-4)
    assert np.abs(to_numpy(got[0]) - to_numpy(got[1])).max() > 1e-8  # distinct heads
    moved = max((a - b).abs().max().item() for a, b in zip(got, shifted))
    if not kw:
        assert moved == 0.0
        return
    assert moved > 1e-7
    sampler = _port_so3(variables, sampling=True, **kw)
    with torch.no_grad():
        zeroed = model(to_torch_batch(batch.replace(energy=np.zeros(2, np.float32))))
        for energy in (batch.energy, batch.energy + 2.0):
            for g, w in zip(sampler(to_torch_batch(batch.replace(energy=energy))), zeroed):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("derive", [True, False], ids=["derived-subgraphs", "three-graphs"])
def test_denoising_prepare_static_matches_no_static_graph(jax_so3, derive):
    """prepare_static hoists the slab-slab part of each graph built on its
    own (the main one, and aeaint and qint unless derived): after the
    adsorbate moved, the forward with it equals the forward without it (the
    tables are the full build's; their order of tied slots may differ)."""
    batch, variables = jax_so3
    kw = dict(derive_subgraphs=derive, max_ads=4)
    rng = np.random.default_rng(6)
    delta = np.zeros(batch.pos.shape, np.float32)
    ads = np.asarray(batch.ads_mask)
    delta[ads] = rng.normal(0, 0.6, (int(ads.sum()), 3))
    moved = to_torch_batch(batch.replace(pos=batch.pos + delta))
    model = _port_so3(variables, **kw)
    static = model.prepare_static(to_torch_batch(batch))
    assert set(static) == ({"main"} if derive else {"main", "aeaint", "qint"})
    with torch.no_grad():
        got = model(moved, static)
        full = model(moved)
    for g, f in zip(got, full):
        np.testing.assert_allclose(to_numpy(g), to_numpy(f), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize(
    "kw,n_problems",
    [(dict(), 3), (dict(edge_atom_interaction=False), 2), (dict(atom_edge_interaction=False,
                                                                edge_atom_interaction=False), 1)],
    ids=["e2e-a2e-e2a", "e2e-a2e", "e2e"],
)
def test_tiny_triplet_bases_come_from_one_grouped_call(jax_tiny, jax_tiny_pallas, port_tiny, kw, n_problems):
    """One forward calls ``gemnet_cbf_bases`` once, with the problems of the
    interactions switched on, and still matches JAX ``GemNetOC(use_pallas=
    True)`` (its triplet bases from Pallas in interpret mode) on the same
    weights."""
    import functools

    import adsorbdiff_tpu.ops.pallas_kernels as pk
    from adsorbdiff_tpu_torch.models import gemnet_oc as port_gemnet_oc

    batch, variables, _ = jax_tiny
    if kw:
        orig_q, orig_c = pk.gemnet_quad_basis, pk.gemnet_cbf_basis
        pk.gemnet_quad_basis = functools.partial(orig_q, interpret=True)
        pk.gemnet_cbf_basis = functools.partial(orig_c, interpret=True)
        try:
            jax_model = JaxGemNetOC(**dict(TINY, **kw), use_pallas=True, fused_quad=True)
            jax_vars = jax.jit(jax_model.init)(jax.random.PRNGKey(0), batch)
            want = jax.jit(jax_model.apply)(jax_vars, batch)
        finally:
            pk.gemnet_quad_basis, pk.gemnet_cbf_basis = orig_q, orig_c
        model = GemNetOC(**dict(TINY, **kw), device="cpu")
        model.load_state_dict(gemnet_state_dict_from_jax(jax_vars), strict=True)
    else:
        want, model = jax_tiny_pallas[True], port_tiny
    calls, original = [], port_gemnet_oc.gemnet_cbf_bases

    def record(problems, s, *out_dtype):
        calls.append(len(problems))
        return original(problems, s, *out_dtype)

    port_gemnet_oc.gemnet_cbf_bases = record
    try:
        with torch.no_grad():
            got = model(to_torch_batch(batch))
    finally:
        port_gemnet_oc.gemnet_cbf_bases = original
    assert calls == [n_problems]
    np.testing.assert_allclose(to_numpy(got["energy"]), np.asarray(want["energy"]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(to_numpy(got["forces"]), np.asarray(want["forces"]), atol=5e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# fused_trip: accepted and ignored (the JAX model's fused and unfused forms are equal)
# --------------------------------------------------------------------------
def _scalar_loss(out):
    return out["energy"].sum() + (out["forces"] ** 2).sum()


@pytest.fixture(scope="module")
def jax_tiny_grads(jax_tiny):
    """JAX's gradient of ``_scalar_loss`` for the TINY model in its XLA form
    (``fused_trip=False``, no kernels), in the port's names and layouts."""
    import jax.numpy as jnp

    batch, variables, _ = jax_tiny
    model = JaxGemNetOC(**TINY)

    def loss(params):
        out = model.apply(dict(variables, params=params), batch)
        return jnp.sum(out["energy"]) + jnp.sum(out["forces"] ** 2)

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(variables["params"]))
    return gemnet_state_dict_from_jax({"params": grads})


def _grads(model, batch):
    out = model(batch)
    names = [n for n, _ in model.named_parameters()]
    return out, dict(zip(names, torch.autograd.grad(_scalar_loss(out), list(model.parameters()))))


def test_fused_trip_matches_jax_and_the_unfused_port(jax_tiny, port_tiny, jax_tiny_grads, monkeypatch):
    """``fused_trip=True`` is accepted and runs the unfused kernels: one
    grouped triplet-basis call a forward and one ``gemnet_quad_chain`` call
    a block.  Against JAX ``GemNetOC(fused_trip=False)`` in its XLA form
    (JAX's own fused and unfused models are equal,
    tests/test_pallas_kernels.py:598): energy and forces at atol 5e-5 / rtol
    1e-4, as above; the gradient of energy.sum() + (forces^2).sum() for
    every parameter within 1e-4 * max|JAX's| of that tensor (f32 sums over
    two blocks forward and back taken in another order).  Against the
    port's model without the flag on the same weights: bit for bit."""
    from adsorbdiff_tpu_torch.models import gemnet_oc as port_gemnet_oc

    batch, _, outs = jax_tiny
    model = GemNetOC(**TINY, fused_trip=True, device="cpu")
    model.load_state_dict(port_tiny.state_dict(), strict=True)
    tb = to_torch_batch(batch)
    calls = collections.Counter()
    chain, bases = port_gemnet_oc.gemnet_quad_chain, port_gemnet_oc.gemnet_cbf_bases

    def counted_chain(*args):
        calls["gemnet_quad_chain"] += 1
        return chain(*args)

    def counted_bases(*args):
        calls["gemnet_cbf_bases"] += 1
        return bases(*args)

    monkeypatch.setattr(port_gemnet_oc, "gemnet_quad_chain", counted_chain)
    monkeypatch.setattr(port_gemnet_oc, "gemnet_cbf_bases", counted_bases)
    got, grads = _grads(model, tb)
    monkeypatch.undo()
    assert calls == {"gemnet_quad_chain": TINY["num_blocks"], "gemnet_cbf_bases": 1}
    plain_out, plain_grads = _grads(port_tiny, tb)
    for key in ("energy", "forces"):
        np.testing.assert_allclose(to_numpy(got[key]), np.asarray(outs[False][key]), atol=5e-5, rtol=1e-4,
                                   err_msg=key)
        np.testing.assert_array_equal(to_numpy(got[key]), to_numpy(plain_out[key]), err_msg=key)
    for name, g in grads.items():
        want = jax_tiny_grads[name].numpy()
        np.testing.assert_allclose(to_numpy(g), want, atol=1e-4 * np.abs(want).max(), rtol=0, err_msg=name)
        np.testing.assert_array_equal(to_numpy(g), to_numpy(plain_grads[name]), err_msg=name)


@pytest.fixture(scope="module")
def jax_bessel():
    """A one-block JAX TINY with the spherical-Bessel basis; each of its four
    bases' ``frequencies`` scaled apart from the init (so the weights, not
    the initialiser, reach the port)."""
    batch = make_batch(np.random.default_rng(8))
    model = JaxGemNetOC(**dict(TINY, num_blocks=1, rbf={"name": "spherical_bessel"}))
    variables = jax.tree.map(np.asarray, dict(jax.jit(model.init)(jax.random.PRNGKey(4), batch)))
    params = dict(variables["params"])
    for i, name in enumerate(("radial_basis", "radial_basis_qint", "radial_basis_aeaint", "radial_basis_aint")):
        params[name] = {"frequencies": params[name]["frequencies"] * np.float32(1.0 + 0.05 * (i + 1))}
    variables = dict(variables, params=params)
    return batch, variables, jax.jit(model.apply)(variables, batch)


@pytest.mark.parametrize("fused_trip", [False, True], ids=["port-unfused", "port-fused-trip"])
def test_tiny_spherical_bessel_matches_jax(jax_bessel, fused_trip):
    """``rbf: spherical_bessel``: four trainable bases (one a graph) carried
    across as ``radial_basis*.rbf.frequencies``, with and without the
    (ignored) ``fused_trip``; energy and forces at atol 5e-5 / rtol 1e-4, as
    above."""
    batch, variables, want = jax_bessel
    model = GemNetOC(**dict(TINY, num_blocks=1, rbf={"name": "spherical_bessel"}), fused_trip=fused_trip,
                     device="cpu")
    model.load_state_dict(gemnet_state_dict_from_jax(variables), strict=True)
    np.testing.assert_array_equal(to_numpy(model.radial_basis_aint.rbf.frequencies),
                                  variables["params"]["radial_basis_aint"]["frequencies"])
    with torch.no_grad():
        got = model(to_torch_batch(batch))
    for key in ("energy", "forces"):
        np.testing.assert_allclose(to_numpy(got[key]), np.asarray(want[key]), atol=5e-5, rtol=1e-4, err_msg=key)
