"""PyTorch port in bf16 (``compute_dtype: bfloat16``, ``amp``): GemNet-OC, the
plain versions of its two kernels and the S2EF trainer, against the JAX
package on the CPU.

Inputs come from seeded numpy, weights from the JAX package's init through
``gemnet_state_dict_from_jax``.  JAX's GemNet-OC runs with ``use_pallas`` and
``fused_quad`` (its Legendre kernels and its quadruplet chain in interpret
mode), the port's runs the plain versions of its kernels.

Tolerances:
- the Legendre bases in bf16: 4e-3 * max|JAX|, one bf16 ulp of the largest
  element (both compute in f32 and round once; a cosine an f32 ulp apart can
  round to the neighbouring bf16 number);
- the quadruplet chain: 1e-2 * max|JAX| (f32 xm and qp, as the model passes
  them, and a bf16 output rounded once from f32 sums in another order); its
  VJP 2e-2 * max|JAX| (a recompute from a bf16 cotangent);
- the model: 2e-2 * max|JAX bf16| per output against JAX's bf16 forward
  (the same rounding points; the JAX forward's own spread under 2e-7
  parameter perturbations is 0.1-0.2% of max for the energy and ~1% for the
  forces here), 5e-2 * max|f32| against the f32 forward (the port's, which
  tests/test_torch_gemnet.py holds to JAX's within 1e-4), and more than
  2e-3 * max away from it;
- one amp S2EF step: loss within 2e-2 relative, each gradient within
  5e-2 * max|JAX's| of its tensor; two amp steps from one seed bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.models.gemnet_oc import GemNetOC as JaxGemNetOC
from adsorbdiff_tpu.ops import pallas_kernels as pk
from adsorbdiff_tpu_torch.models import gemnet_oc as port_gemnet_oc
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC, gemnet_state_dict_from_jax
from adsorbdiff_tpu_torch.ops import kernels
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import RelaxationEngine
from adsorbdiff_tpu_torch.train.trainer import S2EFTrainer
from tests.port_bridge import to_torch_batch
from tests.test_gemnet_oc import TINY
from tests.test_painn import make_batch
from tests.test_s2ef_and_tasks import make_s2ef_dataset
from tests.test_torch_gemnet import SO3
from tests.test_torch_kernels import QUAD, _cbf_inputs, _quad_basis_inputs, _quad_inputs
from tests.test_torch_s2ef import GEMNET_MODEL, _config, _pair, jax_legendre_interpret  # noqa: F401
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
CBF = (2, 3, 7, 6, 7)  # b, n, m, k, s


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _f32(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def test_bf16_legendre_references_match_jax():
    """The triplet basis, the flat form and the dihedral basis with a bf16
    output, against the JAX kernel in interpret mode with ``out_dtype``
    bfloat16 (the model's ``out_dtype=compute_dtype()``)."""
    b, n, m, k, s = CBF
    u, v, keep = _cbf_inputs(50, *CBF)
    got = kernels.gemnet_cbf_basis_reference(*(torch.from_numpy(x) for x in (u, v, keep)), s, BF16)
    want = pk.gemnet_cbf_basis(jnp.asarray(u), jnp.asarray(v), jnp.asarray(keep), s, out_dtype=jnp.bfloat16,
                               interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and got.shape == want.shape
    assert _rel(_f32(got), _f32(want)) <= 4e-3
    a, bt, kg = u.reshape(b * n, m, 3), np.moveaxis(v.reshape(b * n, k, 3), -1, -2).copy(), keep.reshape(b * n, m, k)
    got = kernels.masked_legendre_cos_reference(*(torch.from_numpy(x) for x in (a, bt, kg)), s, BF16)
    want = pk.masked_legendre_cos(jnp.asarray(a), jnp.asarray(bt), jnp.asarray(kg), s, out_dtype=jnp.bfloat16,
                                  interpret=True)
    assert _rel(_f32(got), _f32(want)) <= 4e-3
    n1, n2, qkeep = _quad_basis_inputs(51, 2, 3, 5, 4, 6, s)
    got = kernels.gemnet_quad_basis_reference(*(torch.from_numpy(x) for x in (n1, n2, qkeep)), s, BF16)
    want = pk.gemnet_quad_basis(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(qkeep), s, out_dtype=jnp.bfloat16,
                                interpret=True)
    assert got.dtype == BF16 and _rel(_f32(got), _f32(want)) <= 4e-3
    # a bf16 output is the f32 one rounded once
    f32 = kernels.gemnet_quad_basis_reference(*(torch.from_numpy(x) for x in (n1, n2, qkeep)), s)
    torch.testing.assert_close(got, f32.to(BF16), rtol=0, atol=0)


@pytest.mark.parametrize("zero_rows", [False, True])
def test_bf16_quad_chain_reference_and_vjp_match_jax(zero_rows):
    """A bf16 output from f32 xm and qp (GemNet-OC's bf16 path), against the
    JAX kernel in interpret mode with ``out_dtype`` bfloat16; then the
    cotangents of xm and qp against ``jax.vjp`` (JAX's XLA recompute in xm's
    dtype, f32)."""
    s = QUAD[5]
    t = {k: torch.from_numpy(v) for k, v in _quad_inputs(52, *QUAD, zero_rows=zero_rows).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    names = ("n1", "n2", "key1", "key2", "xm", "qp")
    got = kernels.gemnet_quad_chain_reference(**t, num_spherical=s, out_dtype=BF16)
    want = pk.gemnet_quad_chain(*(j[k] for k in names), s, out_dtype=jnp.bfloat16, interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _rel(_f32(got), _f32(want)) <= 1e-2
    # f32 inputs: one rounding of the f32 result
    f32_out = kernels.gemnet_quad_chain_reference(**t, num_spherical=s)
    torch.testing.assert_close(got, f32_out.to(BF16), rtol=0, atol=0)

    g = np.random.default_rng(53).normal(size=tuple(got.shape)).astype(np.float32)
    g_t = torch.from_numpy(g).to(BF16)
    _, pull = jax.vjp(lambda xm, qp: pk.gemnet_quad_chain(j["n1"], j["n2"], j["key1"], j["key2"], xm, qp, s,
                                                         out_dtype=jnp.bfloat16, interpret=True), j["xm"], j["qp"])
    want = pull(jnp.asarray(_f32(g_t), jnp.bfloat16))
    leaves = {k: t[k].clone().requires_grad_() for k in ("xm", "qp")}
    out = kernels.gemnet_quad_chain(**dict(t, **leaves), num_spherical=s, out_dtype=BF16)
    assert out.dtype == BF16
    got = torch.autograd.grad(out, (leaves["xm"], leaves["qp"]), g_t)
    for name, a, w in zip(("dxm", "dqp"), got, want):
        assert a.dtype == t[name[1:]].dtype
        assert _rel(_f32(a), _f32(w)) <= 2e-2, name


@pytest.fixture(scope="module")
def jax_models(jax_legendre_interpret):  # noqa: F811
    """JAX's s2ef (TINY) and so3 (one block) models in bf16, with their
    kernels."""
    out = {}
    for name, kw, seed in (("s2ef", TINY, 3), ("so3", SO3, 5)):
        batch = make_batch(np.random.default_rng(seed))
        variables = jax.jit(JaxGemNetOC(**kw).init)(jax.random.PRNGKey(0), batch)
        want = jax.jit(JaxGemNetOC(**kw, use_pallas=True, fused_quad=True, compute_dtype="bfloat16").apply)(
            variables, batch)
        out[name] = batch, jax.tree.map(np.asarray, dict(variables)), want
    return out


@pytest.mark.parametrize("name", ["s2ef", "so3"])
def test_gemnet_bf16_forward_matches_jax(jax_models, name, monkeypatch):
    """Energy and forces (s2ef) or both score heads (so3), f32, against
    JAX's bf16 forward and the f32 one; the kernels get JAX's dtypes: f32
    geometry with bf16 triplet bases out, f32 xm and qp with a bf16 chain
    out."""
    batch, variables, want = jax_models[name]
    kw = TINY if name == "s2ef" else SO3
    seen = []
    chain = port_gemnet_oc.gemnet_quad_chain

    def spy(n1, n2, key1, key2, xm, qp, s, *out_dtype):
        seen.append((xm.dtype, qp.dtype) + out_dtype)
        return chain(n1, n2, key1, key2, xm, qp, s, *out_dtype)

    monkeypatch.setattr(port_gemnet_oc, "gemnet_quad_chain", spy)
    got = {}
    for cd in ("bfloat16", None):
        model = GemNetOC(**kw, compute_dtype=cd, device="cpu")
        model.load_state_dict(gemnet_state_dict_from_jax(variables), strict=True)
        with torch.no_grad():
            out = model(to_torch_batch(batch))
        got[cd] = out if isinstance(out, dict) else dict(enumerate(out))
    assert seen[0] == (torch.float32, torch.float32, BF16)
    want = want if isinstance(want, dict) else dict(enumerate(want))
    for key in got[None]:
        p16, p32 = got["bfloat16"][key].numpy(), got[None][key].numpy()
        assert p16.dtype == np.float32 and np.isfinite(p16).all()
        assert _rel(p16, np.asarray(want[key])) <= 2e-2, key
        assert 2e-3 < _rel(p16, p32) <= 5e-2, key


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16_s2ef")
    rng = np.random.default_rng(70)
    return {name: make_s2ef_dataset(tmp, rng, count, name) for name, count in
            (("train", 4), ("val", 4), ("relax", 4))} | {"tmp": tmp}


def _amp_config(shards, run_dir):
    """tests/test_torch_s2ef.py's S2EF config of GemNet-OC TINY (one block)
    with amp."""
    return dict(_config(shards, run_dir, dict(GEMNET_MODEL, num_blocks=1)), amp=True)


def test_amp_s2ef_train_step_matches_jax(shards, jax_legendre_interpret, monkeypatch):  # noqa: F811
    """One amp step of the forces trainer from the same weights: the loss and
    every parameter's gradient (JAX's captured before its optimiser)."""
    jt, pt = _pair(_amp_config(shards, shards["tmp"] / "jax"), shards["tmp"] / "port")
    assert jt.train_model.compute_dtype == pt.model.compute_dtype == "bfloat16"
    assert pt.ema_module.compute_dtype == "bfloat16"
    finalize = jt._finalize_train_step

    def keep_grads(loss, aux, grads, state):
        state, aux = finalize(loss, aux, grads, state)
        return state, dict(aux, grads=grads)

    monkeypatch.setattr(jt, "_finalize_train_step", keep_grads)
    first = next(iter(jt.train_batcher))
    scales = jax.tree.map(np.asarray, jt.state.scale_factors)
    _, jaux = jt._get_step_fn(first)(jt.state, first, jax.random.PRNGKey(400))
    want = gemnet_state_dict_from_jax({"params": jax.tree.map(np.asarray, jaux["grads"]), "scale_factors": scales})
    loss, _ = pt._loss_and_aux(to_torch_batch(first))
    assert abs(float(loss.detach()) - float(jaux["loss"])) <= 2e-2 * abs(float(jaux["loss"]))
    names = [n for n, _ in pt.model.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(loss, list(pt.model.parameters()))):
        w = want[name].numpy()
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= 5e-2 * np.abs(w).max() + 1e-12, name


def test_amp_s2ef_step_repeats_and_relaxes_in_f32(shards):
    """Two amp trainers from one seed take the same step bit for bit; then a
    5-step L-BFGS relaxation with the bf16 EMA model returns f32 energies and
    forces into its state and leaves the fixed atoms where they were."""
    runs = []
    for i in range(2):
        pt = S2EFTrainer(dict(_amp_config(shards, shards["tmp"] / f"rep{i}"), cpu=True))
        batch = next(iter(pt.train_batcher))
        aux = pt.train_step(batch)
        runs.append((float(aux["loss"]), [p.detach().clone() for p in pt.model.parameters()]))
    assert runs[0][0] == runs[1][0] and math.isfinite(runs[0][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    assert pt.ema_module.cdt == BF16
    relax_opt = dict(steps=5, fmax=0.0, maxstep=0.04, memory=20, damping=1.0, alpha=70.0)
    res = RelaxationEngine.from_model(pt.ema_module, relax_opt, device="cpu").run(batch)
    for t in (res.energy, res.forces, res.traj_energy, res.traj_forces, res.batch.pos):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert res.traj_pos.shape[0] == 6
    fixed = batch.fixed & batch.atom_mask
    assert fixed.any()
    torch.testing.assert_close(res.batch.pos[fixed], batch.pos[fixed], rtol=0, atol=0)
    moved = (res.batch.pos - batch.pos).abs().amax(-1)
    assert (moved[~batch.fixed & batch.atom_mask] > 0).any()
