"""PyTorch port: batched L-BFGS and the relaxation engine against the JAX package.

Tolerances: trajectories to 1e-5 A on the harmonic surrogate (the two-loop
dot products are f32 sums in another order); 1e-4 A on the ill-conditioned
one (stiffness ratio 20 and maxstep 0.2 amplify that roundoff over 40 steps:
4.1e-5 A measured on the CPU), and 1e-4 A for 8 steps of the small
GemNet-OC (its forces agree to ~1e-5 relative, and L-BFGS carries the
difference into later steps); nsteps and converged exactly.  Early exit and
the Verlet candidate tables must reproduce the full loop exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.models.gemnet_oc import GemNetOC as JaxGemNetOC
from adsorbdiff_tpu.relaxation.lbfgs import lbfgs_relax as jax_lbfgs_relax
from adsorbdiff_tpu.relaxation.ml_relaxation import RelaxationEngine as JaxRelaxationEngine
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC, gemnet_state_dict_from_jax
from adsorbdiff_tpu_torch.relaxation.lbfgs import lbfgs_relax
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import RelaxationEngine
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_painn import make_batch as slab_batch
from tests.test_relaxation import make_batch
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

# the GemNet-OC of tests/test_relaxation.py::test_lbfgs_verlet_graph_parity
# with an edge width that differs from the atom width: at equal widths the
# JAX MLPStack drops the Dense layer that the reference (and the port) keeps
SMALL_GEMNET = dict(
    num_blocks=1, emb_size_atom=16, emb_size_edge=24, cutoff=6.0, cutoff_aeaint=6.0, cutoff_qint=6.0,
    max_neighbors=8, max_neighbors_aeaint=6, max_neighbors_qint=4, cell_reps=(1, 1, 0),
)
RELAX_OPT = dict(steps=8, fmax=0.01, maxstep=0.04, memory=50, damping=1.0, alpha=70.0, k_cand=24)
# 2 candidates past the main graph's 8 neighbours: its margin (~0.016 A here)
# is spent within a few steps, so the loop rebuilds every table
SEPARATE_K_CAND = 10


def _quadratic(stiffness, target, xp):
    """E = 0.5 sum k |p - target|^2 over real atoms, for JAX (xp = jnp) or
    the port (xp = torch); fixed-atom forces zeroed (the calculator's job)."""

    def fn(batch):
        diff = (batch.pos - target) * batch.atom_mask[..., None]
        energy = 0.5 * (stiffness * diff**2).reshape(diff.shape[0], -1).sum(-1)
        return energy, xp.where(batch.fixed[..., None], 0.0, -stiffness * diff)

    return fn


def _surrogate(case, rng):
    """(JAX batch, JAX fn, port fn, steps, fmax, maxstep) for the harmonic
    surrogate of tests/test_relaxation.py:26-35 and its ill-conditioned one."""
    batch = make_batch(rng, spread=2.0 if case == "harmonic" else 1.0)
    noise = rng.normal(0, 0.5 if case == "harmonic" else 0.3, batch.pos.shape).astype(np.float32)
    target = np.asarray(batch.pos) + noise
    k = np.ones((1, 1, 1), np.float32) if case == "harmonic" else \
        np.linspace(0.5, 10.0, batch.pos.shape[1]).astype(np.float32)[None, :, None]
    jfn = _quadratic(jnp.asarray(k), jnp.asarray(target), jnp)
    tfn = _quadratic(torch.from_numpy(k), torch.from_numpy(target), torch)
    kw = dict(steps=150, fmax=0.01, maxstep=0.04) if case == "harmonic" else dict(steps=40, fmax=1e-3, maxstep=0.2)
    return batch, jfn, tfn, kw


@pytest.mark.parametrize("case,atol", [("harmonic", 1e-5), ("ill-conditioned", 1e-4)])
def test_lbfgs_matches_jax(rng, case, atol):
    """The ill-conditioned case converges within 40 steps only if the history
    is read from the ring's tail from the second step on."""
    batch, jfn, tfn, kw = _surrogate(case, rng)
    want = jax.jit(lambda b: jax_lbfgs_relax(jfn, b, memory=50, **kw))(batch)
    got = lbfgs_relax(tfn, to_torch_batch(batch), memory=50, **kw)
    assert got.traj_pos.shape == (kw["steps"] + 1,) + tuple(batch.pos.shape)
    np.testing.assert_allclose(to_numpy(got.traj_pos), np.asarray(want.traj_pos), atol=atol)
    np.testing.assert_allclose(to_numpy(got.traj_energy), np.asarray(want.traj_energy), atol=atol, rtol=1e-5)
    assert got.nsteps == int(want.nsteps) < kw["steps"]
    np.testing.assert_array_equal(to_numpy(got.converged), np.asarray(want.converged))
    assert to_numpy(got.converged).all()
    torch.testing.assert_close(got.traj_pos[-1], got.batch.pos, rtol=0, atol=0)
    torch.testing.assert_close(got.traj_energy[-1], got.energy, rtol=0, atol=0)


def test_fixed_atoms_and_maxstep(rng):
    """tests/test_relaxation.py:79-99 on the port: fixed atoms never move and
    each step moves an atom by at most maxstep."""
    batch = make_batch(rng, spread=2.0)
    fixed = np.zeros(np.asarray(batch.fixed).shape, bool)
    fixed[:, 0] = True
    tb = to_torch_batch(batch).replace(fixed=torch.from_numpy(fixed))
    fn = _quadratic(torch.ones(()), tb.pos + 3.0, torch)
    res = lbfgs_relax(fn, tb, steps=3, fmax=1e-9, maxstep=0.04, damping=1.0)
    moved = to_numpy(res.traj_pos[-1] - tb.pos)
    assert np.abs(moved[fixed]).max() == 0
    assert np.abs(moved).max() <= 3 * 0.04 + 1e-5
    step = np.linalg.norm(to_numpy(res.traj_pos[1:] - res.traj_pos[:-1]), axis=-1)
    assert step.max() <= 0.04 + 1e-6


def test_early_exit_matches_full_loop(rng):
    """Stopping at batch-wide convergence gives the full loop's result,
    trajectory included (later frames repeat the frozen state); a fixed
    budget (fmax=0) runs every step."""
    batch, _, tfn, kw = _surrogate("harmonic", rng)
    tb = to_torch_batch(batch)
    full = lbfgs_relax(tfn, tb, early_exit=False, **kw)
    fast = lbfgs_relax(tfn, tb, early_exit=True, **kw)
    assert fast.nsteps == full.nsteps < kw["steps"]
    for name in ("traj_pos", "traj_energy", "traj_forces", "energy", "forces"):
        torch.testing.assert_close(getattr(fast, name), getattr(full, name), rtol=0, atol=0, msg=name)
    budget = lbfgs_relax(tfn, tb, **dict(kw, fmax=0.0, steps=12))
    assert budget.nsteps == 12 and not to_numpy(budget.converged).any()


@pytest.fixture(scope="module")
def gemnet_pair():
    batch = slab_batch(np.random.default_rng(7))
    jmodel = JaxGemNetOC(mode="s2ef", **SMALL_GEMNET)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch)
    model = GemNetOC(**SMALL_GEMNET, device="cpu")
    model.load_state_dict(gemnet_state_dict_from_jax(variables), strict=True)
    return batch, jmodel, variables, model


def test_relaxation_engine_verlet_and_jax(gemnet_pair):
    """RelaxationEngine.from_model on a small GemNet-OC for 8 steps: Verlet
    candidate tables on and off give the same positions, and the port
    follows JAX's engine."""
    batch, jmodel, variables, model = gemnet_pair
    tb = to_torch_batch(batch)
    verlet = RelaxationEngine.from_model(model, RELAX_OPT, device="cpu").run(tb)
    full = RelaxationEngine.from_model(model, dict(RELAX_OPT, verlet_graph=False), device="cpu").run(tb)
    torch.testing.assert_close(verlet.traj_pos, full.traj_pos, rtol=0, atol=0)
    torch.testing.assert_close(verlet.traj_energy, full.traj_energy, rtol=0, atol=0)
    assert verlet.nsteps == full.nsteps == 8
    assert to_numpy(verlet.traj_pos[-1] - tb.pos)[to_numpy(tb.fixed)].max() == 0
    want = JaxRelaxationEngine.from_model(jmodel, variables, RELAX_OPT).run(batch)
    np.testing.assert_allclose(to_numpy(verlet.traj_pos), np.asarray(want.traj_pos), atol=1e-4)
    assert verlet.nsteps == int(want.nsteps)


def test_relaxation_engine_separate_subgraph_tables(gemnet_pair):
    """With derivation off the model keeps Verlet tables for its aeaint and
    qint graphs too; a small k_cand spends their margins, so the loop
    rebuilds them, and Verlet on still gives Verlet off's result exactly."""
    batch, _, _, derived = gemnet_pair
    model = GemNetOC(**SMALL_GEMNET, derive_subgraphs=False, device="cpu")
    model.load_state_dict(derived.state_dict(), strict=True)
    tb = to_torch_batch(batch)
    assert set(model.prepare_candidates(tb)) == {"main", "aeaint", "qint"}
    opt = dict(RELAX_OPT, k_cand=SEPARATE_K_CAND)
    verlet = RelaxationEngine.from_model(model, opt, device="cpu").run(tb)
    full = RelaxationEngine.from_model(model, dict(opt, verlet_graph=False), device="cpu").run(tb)
    assert verlet.rebuilds > 0
    for name in ("traj_pos", "traj_energy", "traj_forces"):
        torch.testing.assert_close(getattr(verlet, name), getattr(full, name), rtol=0, atol=0, msg=name)


def test_relaxation_engine_needs_a_device_or_cpu(gemnet_pair, tmp_path):
    """Without a card the engine raises unless given the CPU, and on the CPU
    it writes one trajectory per system of the batch."""
    model = gemnet_pair[3]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RelaxationEngine.from_model(model, RELAX_OPT)
    engine = RelaxationEngine.from_model(model, dict(RELAX_OPT, steps=2), device="cpu")
    tb = to_torch_batch(gemnet_pair[0])
    engine.run(tb, traj_dir=str(tmp_path))
    engine.flush()
    assert len(list(tmp_path.glob("*.adtraj.npz"))) == len(set(tb.sid.tolist()))
