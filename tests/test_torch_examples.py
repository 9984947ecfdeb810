"""PyTorch port: both worked examples end to end on the CPU
(``python -m adsorbdiff_tpu_torch.examples.{val_sample,nrr_screening} --cpu``),
with 3 diffusion and 5 relaxation steps."""
import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.examples import nrr_screening, val_sample
from adsorbdiff_tpu_torch.relaxation.calculator import load_model
from adsorbdiff_tpu_torch.train import checkpoint as ckpt
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

STEPS = ["--cpu", "--num-steps", "3", "--relax-steps", "5"]


@pytest.mark.parametrize("checkpoints", ["demo", "given"])
def test_val_sample_end_to_end(tmp_path, checkpoints):
    """The demo's own checkpoints, or the same ones written first and passed
    on the command line: the same placement, energy and relaxation."""
    argv = list(STEPS)
    if checkpoints == "given":
        argv += ["--diffusion-ckpt", val_sample.make_demo_checkpoint(str(tmp_path), val_sample.MODEL_CFG, name="d"),
                 "--mlff-ckpt", val_sample.make_demo_checkpoint(
                     str(tmp_path), dict(val_sample.MODEL_CFG, so3_denoising=False), mode="s2ef", name="m")]
    out = val_sample.main(argv)
    adslab, placed, relaxed = out["adslab"], out["placed"], out["relaxed"]
    assert len(placed) == len(relaxed) == len(adslab) == 110
    slab, ads = adslab.tags < 2, adslab.tags == 2
    assert ads.sum() == 2
    np.testing.assert_array_equal(placed.positions[slab], adslab.positions[slab].astype(np.float32))
    np.testing.assert_allclose(np.linalg.norm(np.diff(placed.positions[ads], axis=0)), 1.15, atol=1e-4)  # rigid CO
    np.testing.assert_array_equal(relaxed.positions[adslab.fixed], placed.positions[adslab.fixed])
    assert np.isfinite(out["energy"]) and np.isfinite(relaxed.energy) and np.isfinite(relaxed.positions).all()
    assert set(out["anomalies"]) == {"dissociated", "desorbed", "surface_changed", "intercalated"}
    assert all(isinstance(v, bool) for v in out["anomalies"].values())
    if checkpoints == "given":
        default = val_sample.main(STEPS)
        np.testing.assert_array_equal(default["placed"].positions, placed.positions)
        assert default["energy"] == out["energy"] and default["relaxed"].energy == relaxed.energy


def test_nrr_screening_end_to_end(capsys):
    out = nrr_screening.main(STEPS + ["--bulks", "1"])
    assert out["runs"] == 2 and len(out["rows"]) + out["anomalies"] == 2
    for row in out["rows"]:
        assert row["bulk"] == "Ag3Mo" and row["adsorbate"] in ("H", "NNH") and np.isfinite(row["e_ml"])
    assert "anomalous runs filtered" in capsys.readouterr().out


def test_demo_checkpoint_holds_the_seeded_model(tmp_path):
    """make_demo_checkpoint writes the port's format with the config inside;
    the calculator's loader gives back its weights."""
    path = val_sample.make_demo_checkpoint(str(tmp_path), nrr_screening.MODEL_CFG, mode="s2ef", name="mlff")
    state, config = ckpt.load_checkpoint(path)
    assert config == {"model": dict(nrr_screening.MODEL_CFG, cell_reps=[1, 1, 0], mode="s2ef")}
    assert set(state) == {"step", "params", "ema_params", "scale_factors", "opt_state"}
    model = load_model(path, torch.device("cpu"), sampling=False, mode="s2ef")
    for name, p in model.named_parameters():
        assert torch.equal(p, state["ema_params"][name])
    assert model.hidden_channels == 48 and not model.training
