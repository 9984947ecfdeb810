"""PyTorch port: GemNet-OC (s2ef) against the JAX model and the reference oracle.

The port's quadruplet interaction always runs ``gemnet_quad_chain`` (on the
CPU: its plain version); the JAX model is run both with its fused kernel
(Pallas in interpret mode) and with its unfused einsum chain.

Tolerances: energy and forces atol 5e-5 / rtol 1e-4 against JAX (f32 sums
over 2 blocks of dense, triplet and quadruplet contractions taken in another
order); the oracle golden at its own test's tolerances
(``tests/test_torch_import.py``: energy 1e-4 * max(1, |e|), forces atol 5e-6 /
rtol 5e-4); rotation 2e-4 (f32 geometry under a rotation).
"""
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


def test_unported_options_raise():
    for kw in (dict(mode="denoising"), dict(compute_dtype="bfloat16"), dict(energy_encoding="scalar"),
               dict(use_pallas=True), dict(fused_trip=True)):
        with pytest.raises(NotImplementedError):
            GemNetOC(**TINY, **kw, device="cpu")
