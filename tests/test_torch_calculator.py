"""PyTorch port: AdsorbDiffCalculator against the JAX package's.

The small PaiNN of tests/test_calculator.py (H = 32, 2 layers), its JAX
checkpoints written as that test writes them, and the same EMA weights
converted into port checkpoints (``painn_state_dict_from_jax``).
Tolerances:
- ``calculate``: atol 5e-5, rtol 1e-4, tests/test_torch_painn.py's
  tolerance for a PaiNN forward against JAX;
- ``relax``: positions within 1e-4 Å, tests/test_torch_lbfgs.py's
  tolerance for the relaxation engine against JAX's, the energy within
  atol 1e-4, rtol 1e-5 (its trajectory energies' rtol), the final forces
  within the forward's tolerance above.
``run_diffusion`` draws from a torch.Generator where JAX takes a PRNGKey, so
it is held to the port's own ``DiffusionEngine.run`` with the same generator,
exactly.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.data.schema import collate as jax_collate
from adsorbdiff_tpu.relaxation.calculator import AdsorbDiffCalculator as JaxCalculator
from adsorbdiff_tpu.relaxation.calculator import _load_model_state
from adsorbdiff_tpu.runtime.atoms import Atoms as JaxAtoms
from adsorbdiff_tpu.runtime.atoms import atoms_to_system as jax_atoms_to_system
from adsorbdiff_tpu_torch.data.schema import collate
from adsorbdiff_tpu_torch.models.painn import painn_state_dict_from_jax
from adsorbdiff_tpu_torch.relaxation import calculator
from adsorbdiff_tpu_torch.relaxation.calculator import AdsorbDiffCalculator, load_model
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, make_score_fn
from adsorbdiff_tpu_torch.runtime.atoms import Atoms, atoms_to_system
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX
from adsorbdiff_tpu_torch.train import checkpoint as ckpt
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)
from tests.test_calculator import MODEL_CFG, make_atoms, save_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLFF_CFG = dict(MODEL_CFG, so3_denoising=False)


def port_checkpoint(jax_path, out_dir, name, model_cfg, mode=None):
    """The JAX checkpoint's EMA weights and scale factors as a port
    checkpoint with the same model config."""
    example = jax_collate([jax_atoms_to_system(make_atoms(np.random.default_rng(0)))], max_atoms=16)
    _, state = _load_model_state(jax_path, example, sampling=mode is None, mode=mode)
    sd = painn_state_dict_from_jax(jax.tree.map(np.asarray, {"params": state.ema_params,
                                                            "scale_factors": state.scale_factors}))
    scale_factors = {n: v for n, v in sd.items() if n.endswith("scale_factor")}
    params = {n: v for n, v in sd.items() if n not in scale_factors}
    state = {"step": 5, "params": params, "ema_params": params, "scale_factors": scale_factors,
             "opt_state": {"count": torch.zeros((), dtype=torch.int32)}}
    config = {"model": dict(model_cfg, **({"mode": mode} if mode else {}))}
    return ckpt.save_checkpoint(str(out_dir), name, state, config=config)


def as_jax(atoms: Atoms) -> JaxAtoms:
    return JaxAtoms(positions=atoms.positions, numbers=atoms.numbers, cell=atoms.cell, tags=atoms.tags,
                    fixed=atoms.fixed, sid=atoms.sid)


def port_atoms(seed: int) -> Atoms:
    """tests/test_calculator.py's system (10 fixed slab atoms, 3 adsorbate
    atoms) as the port's Atoms."""
    a = make_atoms(np.random.default_rng(seed))
    return Atoms(positions=a.positions, numbers=a.numbers, cell=a.cell, tags=a.tags, fixed=a.fixed, sid=a.sid)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("calculator")
    jax_diff = save_ckpt(root, "jax_diff", MODEL_CFG)
    jax_mlff = save_ckpt(root, "jax_mlff", MLFF_CFG, mode="s2ef")
    return dict(jax_diff=jax_diff, jax_mlff=jax_mlff,
                diff=port_checkpoint(jax_diff, root, "diff", MODEL_CFG),
                mlff=port_checkpoint(jax_mlff, root, "mlff", MLFF_CFG, mode="s2ef"))


def calculators(checkpoints, **kw):
    port = AdsorbDiffCalculator(checkpoint_path=checkpoints["diff"], mlff_checkpoint_path=checkpoints["mlff"],
                                max_atoms=16, device="cpu", **kw)
    jax_calc = JaxCalculator(checkpoint_path=checkpoints["jax_diff"], mlff_checkpoint_path=checkpoints["jax_mlff"],
                             max_atoms=16, **kw)
    return port, jax_calc


@pytest.mark.parametrize("seed", [1, 2])
def test_calculate_matches_jax(checkpoints, seed):
    port, jax_calc = calculators(checkpoints)
    atoms = port_atoms(seed)
    got, want = port.calculate(atoms), jax_calc.calculate(as_jax(atoms))
    assert got["energy"] == pytest.approx(want["energy"], abs=5e-5, rel=1e-4)
    assert got["forces"].shape == (13, 3) and got["forces"].dtype == np.float32
    np.testing.assert_allclose(got["forces"], want["forces"], atol=5e-5, rtol=1e-4)
    assert np.abs(got["forces"][:10]).max() == 0  # fixed slab atoms
    assert port.get_potential_energy() == got["energy"] and port.get_forces() is got["forces"]
    moved = atoms.copy()
    moved.positions[10:] += 0.3
    assert port.get_potential_energy(moved) != got["energy"]
    assert AdsorbDiffCalculator.implemented_properties == ["energy", "forces"]


def test_relax_matches_jax(checkpoints):
    port, jax_calc = calculators(checkpoints)
    atoms = port_atoms(3)
    got = port.relax(atoms, steps=5, fmax=1e-6)
    want = jax_calc.relax(as_jax(atoms), steps=5, fmax=1e-6)
    np.testing.assert_allclose(got.positions, want.positions, atol=1e-4)
    assert got.energy == pytest.approx(want.energy, abs=1e-4, rel=1e-5)
    np.testing.assert_allclose(got.forces, want.forces, atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(got.positions[atoms.fixed], atoms.positions[atoms.fixed].astype(np.float32))
    assert np.abs(got.positions - atoms.positions).max() > 1e-3  # the free atoms moved


def test_run_diffusion_is_the_engine(checkpoints, tmp_path):
    """run_diffusion equals DiffusionEngine.run on the checkpoint's model
    with the same generator; the slab stays, the adsorbate moves rigidly;
    the default generator is seeded with ``seed``."""
    params = {"num_steps": 10}
    port = AdsorbDiffCalculator(checkpoint_path=checkpoints["diff"], denoising_pos_params=params, max_atoms=16,
                                seed=4, device="cpu")
    atoms = port_atoms(5)
    got = port.run_diffusion(atoms, generator=torch.Generator().manual_seed(11), traj_dir=str(tmp_path))
    assert os.path.exists(os.path.join(tmp_path, f"{atoms.sid}{SUFFIX}"))

    model = load_model(checkpoints["diff"], torch.device("cpu"), sampling=True)
    engine = DiffusionEngine(make_score_fn(model), {**calculator.DEFAULT_DENOISING_PARAMS, **params},
                             static_fn=model.prepare_static, device="cpu")
    batch = collate([atoms_to_system(atoms)], max_atoms=16, device="cpu")
    want = engine.run(batch, generator=torch.Generator().manual_seed(11)).batch.pos[0, :13].numpy()
    np.testing.assert_array_equal(got.positions, want)

    slab, ads = atoms.tags < 2, atoms.tags == 2
    np.testing.assert_array_equal(got.positions[slab], atoms.positions[slab].astype(np.float32))
    assert np.abs(got.positions[ads] - atoms.positions[ads]).max() > 1e-2
    d0 = np.linalg.norm(atoms.positions[ads][:, None] - atoms.positions[ads][None], axis=-1)
    d1 = np.linalg.norm(got.positions[ads][:, None] - got.positions[ads][None], axis=-1)
    np.testing.assert_allclose(d1, d0, atol=1e-4)

    default = port.run_diffusion(atoms)
    np.testing.assert_array_equal(default.positions, port.run_diffusion(atoms, torch.Generator().manual_seed(4))
                                  .positions)


def test_checkpoint_checks(checkpoints, tmp_path):
    """A config whose cell_reps is still 'auto' raises and names the
    trainer's resolution; a calculator without a checkpoint raises."""
    state, config = ckpt.load_checkpoint(checkpoints["mlff"])
    path = ckpt.save_checkpoint(str(tmp_path), "auto", state, config={"model": dict(config["model"], cell_reps="auto")})
    calc = AdsorbDiffCalculator(mlff_checkpoint_path=path, device="cpu")
    with pytest.raises(ValueError, match="_resolve_auto_cell_reps"):
        calc.calculate(port_atoms(0))
    with pytest.raises(ValueError, match="no denoising checkpoint"):
        calc.run_diffusion(port_atoms(0))


def test_device_none_raises_without_a_card(checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdsorbDiffCalculator(checkpoint_path=checkpoints["diff"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdsorbDiffCalculator(checkpoint_path=checkpoints["diff"], device="cuda")


def test_lazy_package_export():
    import adsorbdiff_tpu_torch

    assert adsorbdiff_tpu_torch.AdsorbDiffCalculator is AdsorbDiffCalculator
    with pytest.raises(AttributeError):
        adsorbdiff_tpu_torch.NoSuchThing


def test_new_modules_import_nothing_of_jax():
    """The calculator, the placement toolkit, the examples and the common
    helpers in a fresh interpreter: no module of jax, flax, optax or the JAX
    package is loaded."""
    code = ("import sys; before = set(sys.modules); from adsorbdiff_tpu_torch import AdsorbDiffCalculator; "
            "import adsorbdiff_tpu_torch.placement, adsorbdiff_tpu_torch.examples.val_sample, "
            "adsorbdiff_tpu_torch.examples.nrr_screening, adsorbdiff_tpu_torch.common.profiling, "
            "adsorbdiff_tpu_torch.common.compile_cache, adsorbdiff_tpu_torch.common.typing_utils; "
            "print(sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'adsorbdiff_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
