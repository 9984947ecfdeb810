"""PyTorch port: reference checkpoints (PaiNN, GemNet-OC, EquiformerV2 with
the e3nn S^2 grid) against the JAX package's importer, its e3nn-grid model
and the committed oracle fixtures; the convert and eval command lines.

Reference state dicts come from the torch-only oracles' constructors
(``tests/torch_ref_{painn,gemnet,eqv2}.py``, reference names and layouts,
``module.`` prefixes as DDP saves them) and from the fixtures
``tests/fixtures/{painn_golden,gemnet_oracle_golden,eqv2_oracle_golden}.npz``.

Tolerances: the imported tensors within 1e-6 of the JAX importer's; the
e3nn-grid forwards atol 5e-5 / rtol 1e-4 and the parameter gradients atol
1e-5 / rtol 1e-3 against the JAX model (``tests/test_torch_equiformer_v2.py``'s,
the JAX model on its XLA path); the fixtures at the tolerances
``tests/test_torch_import.py`` holds the JAX importer to.
"""
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.data.schema import System as JaxSystem
from adsorbdiff_tpu.data.schema import collate as jax_collate
from adsorbdiff_tpu.models import so3 as jax_so3
from adsorbdiff_tpu.models.equiformer_v2 import EquiformerV2 as JaxEquiformerV2
from adsorbdiff_tpu.train import torch_import as jax_import
from adsorbdiff_tpu_torch.models import so3
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2, eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC
from adsorbdiff_tpu_torch.models.painn import PaiNN
from adsorbdiff_tpu_torch.scripts import convert_checkpoint as convert_cli
from adsorbdiff_tpu_torch.scripts import eval as eval_cli
from adsorbdiff_tpu_torch.train import torch_import
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer, S2EFTrainer
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_eval_tools import make_traj
from tests.test_torch_import import (
    EQV2_GOLDEN,
    EQV2_ORACLE_KW,
    FIXTURE as PAINN_GOLDEN,
    GEMNET_GOLDEN,
    GEMNET_ORACLE_KW,
    KW as PAINN_KW,
    _gemnet_oracle_system,
)
from tests.torch_ref_eqv2 import RefEquiformerV2
from tests.torch_ref_gemnet import RefGemNetOC
from tests.torch_ref_painn import RefPaiNN
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the oracle's widths as model keyword arguments (both packages' names), the
# reference importer's width arguments, and the JAX import test's setting
_K = EQV2_ORACLE_KW
EQV2_WIDTHS = dict(lmax=_K["lmax"], mmax=_K["mmax"], num_layers=_K["num_layers"],
                   sphere_channels=_K["sphere_channels"], attn_hidden_channels=_K["attn_hidden_channels"],
                   num_heads=_K["num_heads"], attn_alpha_channels=_K["attn_alpha_channels"],
                   attn_value_channels=_K["attn_value_channels"])
EQV2_MODEL_KW = dict(EQV2_WIDTHS, ffn_hidden_channels=_K["ffn_hidden_channels"], edge_channels=_K["edge_channels"],
                     num_distance_basis=_K["num_gauss"], cutoff=_K["cutoff"], grid_resolution=_K["grid_res"],
                     max_neighbors=32, cell_reps=(1, 1, 0), mode="denoising", so3_denoising=True,
                     for_denoising=True, subtract_atomic_radii=False)
GEMNET_MODEL_KW = dict(GEMNET_ORACLE_KW, max_neighbors=32, max_neighbors_qint=16, max_neighbors_aeaint=32,
                       cell_reps=(1, 1, 0), mode="s2ef")
PAINN_REF_KW = dict(h=PAINN_KW["hidden_channels"], num_layers=PAINN_KW["num_layers"], num_rbf=PAINN_KW["num_rbf"],
                    cutoff=PAINN_KW["cutoff"])
CONDITIONAL = {"plain": None, "conditional": "scalar"}


def ddp(sd):
    """A state dict as DDP saves it: every name behind ``module.``."""
    return {"module." + k: v for k, v in sd.items()}


def ref_eqv2(energy_encoding=None, seed=0, **kw):
    torch.manual_seed(seed)
    return RefEquiformerV2(**{**EQV2_ORACLE_KW, **kw}, energy_encoding=energy_encoding)


def oracle_batch(energy=None):
    """The JAX import tests' fixed 6-atom system, as a JAX batch."""
    pos, z, tags, cell = _gemnet_oracle_system()
    extra = {} if energy is None else {"energy": energy}
    return jax_collate([JaxSystem(pos=pos, atomic_numbers=z, cell=cell, tags=tags, **extra)], max_atoms=8)


def port_eqv2(sd, energy_encoding=None, grid_mode="e3nn", **kw):
    """The port's EquiformerV2 with a reference state dict imported."""
    model = EquiformerV2(**EQV2_MODEL_KW, energy_encoding=energy_encoding, grid_mode=grid_mode, device="cpu", **kw)
    params, scale_factors = torch_import.reference_state_dict(sd, model)
    assert not scale_factors
    model.load_state_dict(params, strict=True)
    return model


def jax_eqv2(sd, energy_encoding=None, grid_mode="e3nn"):
    """(JAX EquiformerV2 with the JAX importer's tree of ``sd``, that tree)."""
    model = JaxEquiformerV2(**EQV2_MODEL_KW, energy_encoding=energy_encoding, grid_mode=grid_mode)
    return model, jax_import.eqv2_state_dict_to_params(sd, **EQV2_WIDTHS)


# --------------------------------------------------------------------------
# the e3nn S^2 grid
# --------------------------------------------------------------------------
@pytest.mark.parametrize("lmax,res", [(2, 10), (4, 18)])
def test_e3nn_grid_matches_jax(lmax, res):
    np.testing.assert_allclose(so3.soft_grid_weights(res), jax_so3.soft_grid_weights(res), rtol=0, atol=1e-7)
    for got, want in zip(so3.s2_grid_matrices(lmax, res, res, "e3nn"), jax_so3.s2_grid_matrices(lmax, res, res, "e3nn")):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    to_grid, from_grid = so3.s2_grid_matrices(lmax, res, res, "e3nn")
    np.testing.assert_allclose(from_grid @ to_grid, np.eye((lmax + 1) ** 2), atol=1e-5)  # the roundtrip


def test_unknown_grid_mode_raises():
    with pytest.raises(ValueError, match="grid mode"):
        so3.s2_grid_matrices(2, 10, 10, "lebedev")
    with pytest.raises(ValueError, match="grid_mode"):
        EquiformerV2(**EQV2_MODEL_KW, grid_mode="lebedev", device="cpu")


# --------------------------------------------------------------------------
# the EquiformerV2 import against the JAX importer and the JAX e3nn model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("encoding", list(CONDITIONAL.values()), ids=list(CONDITIONAL))
def test_eqv2_import_matches_jax_importer(encoding):
    """Tensor for tensor, on an oracle state dict with ``module.`` prefixes,
    against ``eqv2_state_dict_from_jax(eqv2_state_dict_to_params(sd))``."""
    sd = ddp(ref_eqv2(encoding).state_dict())
    want = eqv2_state_dict_from_jax(jax_import.eqv2_state_dict_to_params(sd, **EQV2_WIDTHS))
    model = EquiformerV2(**EQV2_MODEL_KW, energy_encoding=encoding, grid_mode="e3nn", device="cpu")
    got, _ = torch_import.reference_state_dict(sd, model)
    assert set(got) == set(want) == set(model.state_dict())
    assert ("energy_embedding.weight" in got) == (encoding is not None)
    for name, value in got.items():
        assert value.dtype == torch.float32
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(energy_encoding="scalar"), dict(mode="s2ef")],
                         ids=["plain", "conditional", "s2ef"])
def test_eqv2_reference_shapes_match_the_oracle(kw):
    """The importer's name and shape table is the oracle's state dict (which
    always holds both force heads)."""
    shapes = torch_import.eqv2_reference_shapes(
        **EQV2_WIDTHS, ffn_hidden_channels=_K["ffn_hidden_channels"], edge_channels=_K["edge_channels"],
        num_distance_basis=_K["num_gauss"], energy_encoding=kw.get("energy_encoding"),
        energy_block=kw.get("mode") == "s2ef")
    assert shapes == {k: tuple(v.shape) for k, v in ref_eqv2(**kw).state_dict().items()}


@pytest.mark.parametrize("encoding", list(CONDITIONAL.values()), ids=list(CONDITIONAL))
def test_eqv2_e3nn_forward_matches_jax(encoding):
    """The port's ``grid_mode="e3nn"`` forward against the JAX model's on the
    same reference state dict, both heads (the conditional model on a
    system with an energy)."""
    sd = ddp(ref_eqv2(encoding, seed=1).state_dict())
    batch = oracle_batch(energy=-1.3 if encoding else None)
    jmodel, variables = jax_eqv2(sd, encoding)
    want = jmodel.apply(variables, batch)
    with torch.no_grad():
        got = port_eqv2(sd, encoding)(to_torch_batch(batch))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 1e-4  # the heads see the weights
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if encoding:  # the energy reaches the output
        with torch.no_grad():
            shifted = port_eqv2(sd, encoding)(to_torch_batch(oracle_batch(energy=2.0)))
        assert (shifted[0] - got[0]).abs().max() > 1e-6


def test_eqv2_e3nn_parameter_gradients_match_jax():
    """sum over both heads of mean(f^2), conditional model, e3nn grid: the
    outputs and every parameter's gradient against JAX's."""
    sd = ddp(ref_eqv2("scalar", seed=2).state_dict())
    batch = oracle_batch(energy=-0.7)
    jmodel, variables = jax_eqv2(sd, "scalar")

    def loss(params):
        out = jmodel.apply({"params": params}, batch)
        return sum(jnp.mean(f ** 2) for f in out), out

    (_, want_out), want = jax.value_and_grad(loss, has_aux=True)(jax.tree.map(jnp.asarray, variables["params"]))
    want = eqv2_state_dict_from_jax({"params": jax.tree.map(np.asarray, want)})
    model = port_eqv2(sd, "scalar")
    out = model(to_torch_batch(batch))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(sum(torch.mean(f ** 2) for f in out), [p for _, p in model.named_parameters()])
    for g, w in zip(out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
    assert np.abs(want["energy_embedding.weight"].numpy()).max() > 0  # the energy reaches the loss


# --------------------------------------------------------------------------
# the committed oracle fixtures
# --------------------------------------------------------------------------
def _fixture_sd(path):
    data = np.load(path)
    return data, ddp({k[len("sd."):]: data[k] for k in data.files if k.startswith("sd.")})


def _painn_fixture():
    data, sd = _fixture_sd(PAINN_GOLDEN)
    systems = [JaxSystem(pos=data["pos"][i, :int(data[f"natoms.{i}"])],
                         atomic_numbers=data["z"][i, :int(data[f"natoms.{i}"])], cell=data["cell"][i],
                         tags=data["tags"][i, :int(data[f"natoms.{i}"])], sid=i)
               for i in range(int(data["n_systems"]))]
    batch = jax_collate(systems, max_atoms=data["pos"].shape[1])
    model = PaiNN(**PAINN_KW, so3_denoising=True, device="cpu")
    params, scale_factors = torch_import.reference_state_dict(sd, model)
    model.load_state_dict({**params, **scale_factors}, strict=True)
    with torch.no_grad():
        f1, f2 = model(to_torch_batch(batch))
    mask = np.asarray(batch.atom_mask)
    for got, want in ((f1, data["out1"]), (f2, data["out2"])):
        np.testing.assert_allclose(to_numpy(got)[mask], want[mask], atol=2e-5, rtol=1e-4)


def _gemnet_fixture():
    data, sd = _fixture_sd(GEMNET_GOLDEN)
    model = GemNetOC(**GEMNET_MODEL_KW, device="cpu")
    params, scale_factors = torch_import.reference_state_dict(sd, model)
    assert scale_factors and set(params) | set(scale_factors) == set(model.state_dict())
    model.load_state_dict({**params, **scale_factors}, strict=True)
    with torch.no_grad():
        out = model(to_torch_batch(oracle_batch()))
    e_ref = float(data["energy"])
    assert abs(float(out["energy"][0]) - e_ref) <= 1e-4 * max(1.0, abs(e_ref))
    np.testing.assert_allclose(to_numpy(out["forces"])[0, :6], data["forces"], atol=5e-6, rtol=5e-4)


def _eqv2_fixture():
    """The fixture's outputs are the oracle's on the Gauss-Legendre grid."""
    data, sd = _fixture_sd(EQV2_GOLDEN)
    with torch.no_grad():
        f1, f2 = port_eqv2(sd, grid_mode="gauss")(to_torch_batch(oracle_batch()))
    np.testing.assert_allclose(to_numpy(f1)[0, :6], data["f1"], atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(to_numpy(f2)[0, :6], data["f2"], atol=2e-5, rtol=2e-4)


FIXTURES = {"painn": _painn_fixture, "gemnet_oc": _gemnet_fixture, "equiformer_v2": _eqv2_fixture}


@pytest.mark.parametrize("family", list(FIXTURES))
def test_import_matches_golden_fixture(family):
    FIXTURES[family]()


# --------------------------------------------------------------------------
# configs, failures
# --------------------------------------------------------------------------
REFERENCE_CONFIGS = {
    "equiformer_v2": dict(name="...equiformer_v2_denoising.EquiformerV2S_OC20_DenoisingPos", num_layers=8,
                          sphere_channels=128, lmax_list=[4], mmax_list=[2], max_radius=12.0, max_neighbors=20,
                          use_pbc=True, regress_forces=True, FOR_denoising=True, so3_denoising=True,
                          use_grid_mlp=True, norm_type="layer_norm_sh", alpha_drop=0.1),
    "gemnet_oc": dict(name="gemnet_oc", num_blocks=4, cutoff=12.0, qint_tags=[1, 2], scale_file="x.pt",
                      output_init="HeOrthogonal", activation="silu"),
    "painn": dict(name="experimental.adeesh.denoising.models.painn_denoising.PaiNN", hidden_channels=32,
                  num_layers=2, num_rbf=8, max_radius=6.0, max_neighbors=32, so3_denoising=True, use_pbc=True,
                  otf_graph=True),
}


@pytest.mark.parametrize("family", list(REFERENCE_CONFIGS))
def test_reference_model_config_matches_jax(family):
    cfg = REFERENCE_CONFIGS[family]
    got = torch_import.reference_model_config_to_ours(dict(cfg))
    assert got == jax_import.reference_model_config_to_ours(dict(cfg))
    assert got["name"] == family
    with pytest.raises(ValueError, match="model family"):
        torch_import.reference_model_config_to_ours(dict(cfg, name="schnet"))


def _drop(sd, name):
    return {k: v for k, v in sd.items() if k != name}


@pytest.mark.parametrize("family", ["painn", "gemnet_oc", "equiformer_v2"])
def test_missing_tensor_raises_key_error(family):
    """A missing weight raises KeyError with its name; a missing scale factor
    does not (it may come from a scale file) and is left out."""
    if family == "painn":
        model = PaiNN(**PAINN_KW, device="cpu")
        torch.manual_seed(0)
        sd, name = ddp(RefPaiNN(**PAINN_REF_KW).state_dict()), "message_layers.1.rbf_proj.weight"
        factor = "upd_out_scalar_scale_0.scale_factor"
    elif family == "gemnet_oc":
        model = GemNetOC(**GEMNET_MODEL_KW, device="cpu")
        torch.manual_seed(0)
        sd, name = ddp(RefGemNetOC(**GEMNET_ORACLE_KW).state_dict()), "int_blocks.0.quad_interaction.mlp_cbf.linear.weight"
        factor = "int_blocks.1.atom_update.scale_sum.scale_factor"
    else:
        model = EquiformerV2(**EQV2_MODEL_KW, grid_mode="e3nn", device="cpu")
        sd, name, factor = ddp(ref_eqv2().state_dict()), "blocks.1.ga.so2_conv_1.so2_m_conv.0.fc.weight", None
    with pytest.raises(KeyError, match=name.replace(".", r"\.")):
        torch_import.reference_state_dict(_drop(sd, "module." + name), model)
    bad = dict(sd, **{"module." + name: np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="wrong shape"):
        torch_import.reference_state_dict(bad, model)
    if factor is not None:
        params, scale_factors = torch_import.reference_state_dict(_drop(sd, "module." + factor), model)
        assert factor not in scale_factors and len(scale_factors) == len(
            [k for k in model.state_dict() if k.endswith(".scale_factor")]) - 1


# --------------------------------------------------------------------------
# the command lines
# --------------------------------------------------------------------------
def _reference_pt(tmp_path, family):
    """A reference-shaped .pt: DDP prefixes, the embedded config, an epoch;
    the port's model kwargs for the direct import; the trainer class."""
    torch.manual_seed(3)
    if family == "painn":
        sd = RefPaiNN(**PAINN_REF_KW).state_dict()
        cfg = dict(REFERENCE_CONFIGS["painn"])
        model_attrs, kind = {k: v for k, v in cfg.items() if k != "name"}, DenoisingTrainer
        direct = dict(PAINN_KW, so3_denoising=True)
        override = ["cell_reps=(1, 1, 0)"]
    elif family == "gemnet_oc":
        sd = RefGemNetOC(**GEMNET_ORACLE_KW).state_dict()
        sd = {k: (torch.full_like(v, 1.5) if k.endswith(".scale_factor") else v) for k, v in sd.items()}  # fitted
        model_attrs = {k: v for k, v in GEMNET_MODEL_KW.items() if k not in ("cell_reps", "mode")}
        cfg, kind, direct = dict(model_attrs, name="gemnet_oc"), S2EFTrainer, GEMNET_MODEL_KW
        override = ["cell_reps=(1, 1, 0)"]
    else:
        sd = RefEquiformerV2(**EQV2_ORACLE_KW, energy_encoding="scalar").state_dict()
        model_attrs = dict(lmax_list=[_K["lmax"]], mmax_list=[_K["mmax"]], max_radius=_K["cutoff"], **{
            k: v for k, v in EQV2_MODEL_KW.items() if k not in ("lmax", "mmax", "cutoff", "cell_reps", "mode")},
            energy_encoding="scalar", use_pbc=True, otf_graph=True, use_grid_mlp=True, norm_type="layer_norm_sh")
        cfg = dict(model_attrs, name="equiformer_v2_denoising")
        kind = DenoisingTrainer
        direct = dict(EQV2_MODEL_KW, energy_encoding="scalar", grid_mode="e3nn", radii_pm_bug_compat=True)
        override = ["cell_reps=(1, 1, 0)", f"num_distance_basis={_K['num_gauss']}"]  # the reference fixes 600
    path = str(tmp_path / "ref.pt")
    torch.save({"state_dict": ddp(sd), "config": {"model": cfg["name"], "model_attributes": model_attrs},
                "epoch": 3}, path)
    return path, sd, direct, kind, override


@pytest.mark.parametrize("family", ["painn", "gemnet_oc", "equiformer_v2"])
def test_convert_command_line_to_trainer_checkpoint(tmp_path, family):
    """``python -m adsorbdiff_tpu_torch.scripts.convert_checkpoint`` (its
    ``main``): the trainer built from the sidecar's model section loads the
    file with ``weights_only=True`` and its model and EMA copy give the
    forward of the direct import."""
    import yaml

    pt, sd, direct, kind, override = _reference_pt(tmp_path, family)
    argv = [pt, str(tmp_path / "out"), "--name", "conv", "--cpu"] + [a for o in override for a in ("--override", o)]
    path = convert_cli.main(argv)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["step"] == 0 and int(payload["opt_state"]["count"]) == 0
    with open(path + ".config.yaml") as f:
        model_cfg = yaml.safe_load(f)["model"]
    assert model_cfg == payload["config"]["model"] and model_cfg["name"] == family
    if family == "equiformer_v2":
        assert model_cfg["grid_mode"] == "e3nn" and model_cfg["energy_encoding"] == "scalar"

    trainer = kind({"model": model_cfg, "optim": {"lr_initial": 1e-4}, "cpu": True, "is_debug": True,
                    "run_dir": str(tmp_path)})
    trainer.load_checkpoint(path)
    reference = (EquiformerV2 if family == "equiformer_v2" else GemNetOC if family == "gemnet_oc" else PaiNN)(
        **direct, device="cpu")
    params, scale_factors = torch_import.reference_state_dict(ddp(sd), reference)
    reference.load_state_dict({**params, **scale_factors}, strict=True)
    if family == "gemnet_oc":
        assert all(float(v) == 1.5 for v in scale_factors.values()) and trainer.scale_factors_fitted
    batch = to_torch_batch(oracle_batch(energy=-1.0))
    reference.eval()
    trainer.model.eval()
    with torch.no_grad():
        want = reference(batch)
        for model in (trainer.model, trainer.ema_module):
            got = model(batch)
            pairs = zip(got.values(), want.values()) if isinstance(got, dict) else zip(got, want)
            for g, w in pairs:
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["trajs", "nsite"])
def test_eval_command_line_prints_what_jax_prints(tmp_path, capsys, monkeypatch, mode):
    """The port's eval command against the JAX package's ``scripts/eval.py``
    on one temporary trajectory tree: the same lines."""
    d1 = tmp_path / "0" / "relaxations"
    d2 = tmp_path / "1" / "relaxations"
    d1.mkdir(parents=True)
    d2.mkdir(parents=True)
    make_traj(d1, 1, -1.0)
    make_traj(d2, 1, -2.5, desorbed=True)  # filtered as an anomaly
    make_traj(d1, 2, -2.0)
    make_traj(d2, 2, -3.0)
    targets = tmp_path / "targets.json"
    targets.write_text(json.dumps({"1": -2.0, "2": -3.05, "3": -1.0}))
    sources = [str(d1), str(d2)] if mode == "trajs" else [str(tmp_path)]
    argv = [mode, *sources, "--targets", str(targets)]

    rate, per = eval_cli.main(argv)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
    runpy.run_path(os.path.join(REPO, "scripts", "eval.py"), run_name="__main__")
    theirs = capsys.readouterr().out
    assert ours == theirs
    assert ours.splitlines()[-1] == "success rate: 33.3%  (1/3)" and rate == pytest.approx(1 / 3)
    assert per == {"1": False, "2": True, "3": False}
