"""PyTorch port in bf16: one amp ``DenoisingTrainer`` step on EquiformerV2
against the JAX trainer's, and the amp step's repeatability.

Its own file: JAX's amp step with the Pallas kernels in interpret mode
compiles for about a minute (the other bf16 EquiformerV2 tests are in
``tests/test_torch_bf16_eqv2.py`` and ``tests/test_torch_bf16_eqv2_model.py``).

The step starts from JAX's init, on the same batch and the same noise
draws (``tests/port_bridge.py::jax_schedule_draws``); JAX's gradients are
captured before its optimiser.  JAX runs the kernel forms (``use_pallas``,
``use_pallas_conv1``, ``use_pallas_rotate``: what the port's model runs)
and, to measure how far bf16 alone moves a gradient, the XLA form.

Limits, all fixed (derived on this batch, TINY widths):
- the loss within 2e-2 relative (the port read 5.2e-4; JAX's two bf16 forms
  part by 1.6e-3);
- each gradient within 5e-2 * max|JAX's kernel form| of its tensor, but
  those of GRAD_LIMITS: a gradient that sums many cancelling bf16 terms is
  ill-conditioned, and JAX's own two bf16 forms part by up to 11.5% of max
  (``blocks.0.norm_attn.affine_weight``, which the port read at 8.9%; every
  other gradient read at most 4.2%, JAX's forms 5.8%).  A limit there is
  1.25 x the distance between JAX's two forms as recorded, and no
  gradient's distance between JAX's forms may pass GRAD_SPREAD_CEILING;
- the gradients as one vector: the port's bf16 no further from JAX's bf16
  than the port's f32 is (the port read 1.30% of max against 2.20%), and at
  least half that far from its own f32 (1.54%): the step does round.
Two amp steps from one seed are equal bit for bit.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adsorbdiff_tpu.ops.pallas_kernels as pk
from adsorbdiff_tpu.ops import igso3 as jax_igso3
from adsorbdiff_tpu.train.trainer import DenoisingTrainer as JaxDenoisingTrainer
from adsorbdiff_tpu_torch.models.equiformer_v2 import eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.ops import igso3
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer
from tests.port_bridge import jax_schedule_draws, to_torch_batch
from tests.test_equiformer_v2 import TINY
from tests.test_torch_bf16_eqv2 import KERNEL_FORMS, KERNEL_NAMES
from tests.test_torch_trainer import energy_data  # noqa: F401  (fixture)
from tests.test_trainer import config_for
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
# 1.25 x the distance between JAX's kernel-form and XLA-form bf16 gradients of the tensor on this batch (0.1152),
# rounded up; every other gradient is held to 5e-2
GRAD_LIMITS = {"blocks.0.norm_attn.affine_weight": 0.145}
GRAD_SPREAD_CEILING = 0.15


def _config(train, run_dir, flags, amp=True, **model):
    cfg = config_for(train, run_dir=str(run_dir))
    cfg["model"] = dict(TINY, name="equiformer_v2", so3_denoising=True, for_denoising=True, **flags, **model)
    return dict(cfg, amp=amp)


def _named_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).numpy() for n, g, p in zip(names, grads, model.parameters())}


def test_amp_builds_bf16_eqv2_model_and_ema(energy_data, tmp_path):  # noqa: F811
    """``amp`` builds the EquiformerV2, plain and energy-conditional, and its
    EMA copy in bf16; the parameters and the EMA buffers stay f32."""
    train, _ = energy_data
    for model in ({}, {"energy_encoding": "scalar"}):
        tr = DenoisingTrainer(dict(_config(train, tmp_path, {}, **model), cpu=True))
        tr.init_state()
        assert tr.model.compute_dtype == tr.ema_module.compute_dtype == "bfloat16" and tr.model.cdt == BF16
        assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
        assert {t.dtype for t in tr.ema} == {torch.float32}


def test_amp_eqv2_train_step_matches_jax(energy_data, tmp_path, monkeypatch):  # noqa: F811
    """One amp step: the loss and every parameter's gradient against JAX's
    kernel form at the module docstring's limits, then all gradients as one
    vector against JAX's bf16 and the port's f32 step."""
    repaired = jax_igso3.get_tables()._replace(exp_score_norms=igso3.get_tables().exp_score_norms)
    monkeypatch.setattr(jax_igso3, "get_tables", lambda: repaired)
    for name in KERNEL_NAMES:
        monkeypatch.setattr(pk, name, functools.partial(getattr(pk, name), interpret=True))
    train, _ = energy_data
    key = jax.random.PRNGKey(300)
    state, first, want = None, None, {}
    for form, flags in (("kernel", KERNEL_FORMS), ("xla", {})):
        jt = JaxDenoisingTrainer(_config(train, tmp_path / f"jax-{form}", flags), mesh=None)
        if state is None:
            first = next(iter(jt.train_batcher))
            jt.init_state(first)
            state = jax.tree.map(np.asarray, jt.state)  # the step donates its state
        finalize = jt._finalize_train_step

        def keep_grads(loss, aux, grads, st, finalize=finalize):
            st, aux = finalize(loss, aux, grads, st)
            return st, dict(aux, grads=grads)

        monkeypatch.setattr(jt, "_finalize_train_step", keep_grads)
        _, jaux = jt._get_step_fn(first)(jax.tree.map(jnp.asarray, state), first, key)
        want[form] = float(jaux["loss"]), {n: g.numpy() for n, g in eqv2_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jaux["grads"])}).items()}
    grads, losses = {}, {}
    for amp in (True, False):
        pt = DenoisingTrainer(dict(_config(train, tmp_path / f"port-{amp}", KERNEL_FORMS, amp), cpu=True))
        pt.model.load_state_dict(eqv2_state_dict_from_jax({"params": state.params}))
        pt.init_state()
        loss, _ = pt._loss_and_aux(to_torch_batch(first), jax_schedule_draws(key, first.batch_size), None)
        losses[amp], grads[amp] = float(loss.detach()), _named_grads(pt.model, loss)
    w_loss, jax16 = want["kernel"]
    assert abs(losses[True] - w_loss) <= 2e-2 * abs(w_loss)
    for name, g in grads[True].items():
        w, xla = jax16[name], want["xla"][1][name]
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        assert np.abs(xla - w).max() <= GRAD_SPREAD_CEILING * np.abs(w).max(), name
        assert np.abs(g - w).max() <= GRAD_LIMITS.get(name, 5e-2) * np.abs(w).max() + 1e-12, name
    port16, port32, j16 = (np.concatenate([np.ravel(d[n]) for n in grads[True]]) for d in (grads[True], grads[False],
                                                                                           jax16))
    scale = np.abs(j16).max()
    d32 = np.abs(port32 - j16).max() / scale
    assert np.abs(port16 - j16).max() / scale <= d32
    assert np.abs(port16 - port32).max() / scale >= 0.5 * d32


@pytest.mark.parametrize("conditional", [False, True], ids=["eqv2-so3", "eqv2-conditional"])
def test_amp_eqv2_train_step_repeats_bit_for_bit(energy_data, tmp_path, conditional):  # noqa: F811
    train, _ = energy_data
    model = {"energy_encoding": "scalar"} if conditional else {}
    out = []
    for run in range(2):
        tr = DenoisingTrainer(dict(_config(train, tmp_path / str(run), {}, **model), cpu=True))
        batch = next(iter(tr.train_batcher))
        aux = tr.train_step(batch, generator=torch.Generator().manual_seed(5))
        out.append((float(aux["loss"]), [p.detach().clone() for p in tr.model.parameters()]))
    assert out[0][0] == out[1][0] and math.isfinite(out[0][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
