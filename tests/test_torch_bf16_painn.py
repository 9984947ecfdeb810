"""PyTorch port in bf16 (``compute_dtype: bfloat16``, ``amp``): PaiNN, its
message kernels' plain versions and the DenoisingTrainer, against the JAX
package on the CPU.

Inputs come from seeded numpy (rounded to bf16 once, the same values on both
sides), weights from the JAX package's init through
``painn_state_dict_from_jax``.  JAX runs its Pallas message kernels in
interpret mode (``use_pallas=True``, the production setting).

Tolerances:
- the message kernel's plain version (f32 outputs): 1e-3 * max|JAX|.  Both
  round the basis and W to bf16 before an f32 filter product; what is left is
  f32 sums in another order and, now and then, a basis value that rounds to
  the neighbouring bf16 number after an f32 ulp of difference (0.4% of one
  term of a 20-term sum);
- its backward (f32 outputs, then cast to bf16 as the VJP casts them):
  1e-3 * max|JAX| for the f32 outputs, 4e-3 * max|JAX| (one bf16 ulp of the
  largest element) for the cast ones;
- the model: 2e-2 * max|JAX bf16| per output against JAX's bf16 forward
  (rounding in the same places, two frameworks' f32 kernels and sums in
  another order: one bf16 ulp early on grows through the layers; the JAX
  forward's own spread under 2e-7 parameter perturbations is 0.05-0.8% of
  max here), more than 2e-3 * max away from the port's own f32 forward (it
  does round), and at MODEL_KW's two layers 5e-2 * max|JAX f32| against
  JAX's f32 forward (at three layers JAX's own bf16 forward is already 4.6%
  from its f32 one);
- one amp training step: loss within 2e-2 relative; each gradient within
  5e-2 * max|JAX's| of its tensor, but the six of GRAD_LIMITS: a weight
  gradient that sums many cancelling bf16 terms is ill-conditioned, and
  JAX's own two bf16 forms (its Pallas path and its XLA path, which round at
  other points) part by up to 11.5% of max on this batch.  Each of the six
  has a fixed limit, 1.25 x that distance as recorded, and no gradient's
  distance between JAX's two forms may pass GRAD_SPREAD_CEILING.  For two
  of the six (out_forces.output_network.{0,1}.vec2_proj.weight) JAX's bf16
  is nearer its f32 than its other bf16 form, so no per-tensor limit can
  tell bf16 from f32 there; the gradients as one vector can: the port's is
  at most as far from JAX's bf16 as JAX's f32 is (0.76% against 1.22% of
  max), and at least half that far from f32 (0.94%).  Two amp steps from
  one seed bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.models.painn import PaiNN as JaxPaiNN
from adsorbdiff_tpu.ops import igso3 as jax_igso3
from adsorbdiff_tpu.ops import pallas_kernels as pk
from adsorbdiff_tpu.train.trainer import DenoisingTrainer as JaxDenoisingTrainer
from adsorbdiff_tpu_torch.models import painn as port_painn
from adsorbdiff_tpu_torch.models.painn import PaiNN, painn_state_dict_from_jax
from adsorbdiff_tpu_torch.ops import igso3, kernels
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer
from tests.port_bridge import jax_schedule_draws, to_torch_batch
from tests.test_painn import MODEL_KW, make_batch
from tests.test_torch_kernels import RAGGED, _cotangents, _inputs
from tests.test_trainer import config_for, make_dataset
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
# three layers: the third message reaches the kernel with f32 vec (JAX's f32 scale factor widens x after the first
# layer, and the second layer's message then returns f32 dvec)
KW = dict(MODEL_KW, num_layers=3)
# the amp step's fixed gradient limits past 5e-2 (x max|JAX's|): 1.25 x the distance between JAX's Pallas and XLA
# bf16 gradients of the tensor on this batch (0.1148, 0.0882, 0.0643, 0.0896, 0.0796, 0.0846), rounded up
GRAD_LIMITS = {"out_forces.output_network.0.vec2_proj.weight": 0.15,
               "out_forces.output_network.0.vec1_proj.weight": 0.12,
               "update_layers.1.vec_proj.weight": 0.081,
               "message_layers.0.rbf_proj.weight": 0.12,
               "out_forces.output_network.1.vec2_proj.weight": 0.10,
               "message_layers.0.x_layernorm.weight": 0.11}
GRAD_SPREAD_CEILING = 0.15
MESSAGE_NAMES = ("xh", "vec", "src", "dist", "mask", "unit", "weight", "bias")


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max() / np.abs(want).max())


def _bf16_inputs(seed, vec_bf16):
    """The message kernel's inputs with xh (and vec) rounded to bf16: torch
    tensors and the same values for JAX."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(seed, *RAGGED).items()}
    t["xh"] = t["xh"].to(BF16)
    if vec_bf16:
        t["vec"] = t["vec"].to(BF16)
    j = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if v.dtype == BF16 else jnp.asarray(v.numpy())
         for k, v in t.items()}
    return t, j


@pytest.mark.parametrize("vec_bf16", [True, False], ids=["vec-bf16", "vec-f32"])
def test_bf16_message_reference_matches_jax_kernel(vec_bf16):
    t, j = _bf16_inputs(40, vec_bf16)
    want = pk.painn_message_fused(*(j[k] for k in MESSAGE_NAMES), cutoff=6.0, envelope_exponent=5, ti=8)
    got = kernels.painn_message_fused_reference(**t, cutoff=6.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert _rel(g.numpy(), w) <= 1e-3
    # the bf16 variant is no f32 kernel: the same rows in f32 give another result
    f32 = kernels.painn_message_fused_reference(**dict(t, xh=t["xh"].float(), vec=t["vec"].float()), cutoff=6.0)
    assert max(_rel(a.numpy(), b.numpy()) for a, b in zip(got, f32)) > 1e-4


@pytest.mark.parametrize("vec_bf16", [True, False], ids=["vec-bf16", "vec-f32"])
def test_bf16_message_bwd_matches_jax_kernel(vec_bf16):
    """The plain backward against the TPU backward (interpret mode), then the
    port's autograd Function against ``jax.vjp`` (cotangents cast to the
    input dtypes)."""
    t, j = _bf16_inputs(41, vec_bf16)
    cx, cv = _cotangents(42, *RAGGED[:2], RAGGED[4])
    want = pk._painn_message_fused_bwd_impl(*(j[k] for k in MESSAGE_NAMES), jnp.asarray(cx), jnp.asarray(cv),
                                            cutoff=6.0, envelope_exponent=5, ti=4)
    got = kernels.painn_message_fused_bwd_reference(**t, dx_ct=torch.from_numpy(cx), dvec_ct=torch.from_numpy(cv),
                                                    cutoff=6.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), np.asarray(w).reshape(g.shape)) <= 1e-3

    fixed = {k: j[k] for k in ("src", "dist", "mask", "unit")}
    _, vjp = jax.vjp(lambda xh, vec, w, b: pk.painn_message_fused(xh, vec, fixed["src"], fixed["dist"],
                                                                  fixed["mask"], fixed["unit"], w, b, cutoff=6.0),
                     j["xh"], j["vec"], j["weight"], j["bias"])
    want = vjp((jnp.asarray(cx), jnp.asarray(cv)))
    leaves = {k: t[k].clone().requires_grad_() for k in ("xh", "vec", "weight", "bias")}
    dx, dv = kernels.painn_message_fused(**dict(t, **leaves), cutoff=6.0)
    ((dx * torch.from_numpy(cx)).sum() + (dv * torch.from_numpy(cv)).sum()).backward()
    for name, w in zip(("xh", "vec", "weight", "bias"), want):
        g = leaves[name].grad
        assert g.dtype == t[name].dtype == {jnp.bfloat16: BF16, jnp.float32: torch.float32}[w.dtype.type]
        tol = 4e-3 if g.dtype == BF16 else 1e-3
        assert _rel(g.float().numpy(), np.asarray(w, np.float32).reshape(g.shape)) <= tol, name


def test_message_variants_and_cpu_wrapper():
    """The C entry a dtype pair reaches; on the CPU the wrapper runs the
    plain version and counts no launch under either name."""
    f, b = torch.zeros(1), torch.zeros(1, dtype=BF16)
    assert kernels._message_variant("k", f, f) == "f32"
    assert kernels._message_variant("k", b, b) == "bf16"
    assert kernels._message_variant("k", b, f) == "bf16_vf32"
    with pytest.raises(TypeError):
        kernels._message_variant("k", f, b)
    t, _ = _bf16_inputs(43, True)
    before = dict(kernels.launches)
    for g, w in zip(kernels.painn_message_fused(**t, cutoff=6.0), kernels.painn_message_fused_reference(**t, cutoff=6.0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("layers", [2, 3])
def test_painn_bf16_forward_matches_jax(layers, monkeypatch):
    """The so3 denoising forward: both heads, f32 outputs; the message
    kernel sees the dtypes JAX's sees (bf16 vec in the first two layers, f32
    in the third)."""
    kw = dict(KW, num_layers=layers)
    batch = make_batch(np.random.default_rng(7))
    variables = JaxPaiNN(**kw).init(jax.random.PRNGKey(0), batch)
    jax_dtypes = []
    orig = pk.painn_message_fused

    def jax_spy(xh, vec, *args, **kwargs):
        jax_dtypes.append((xh.dtype, vec.dtype))
        return orig(xh, vec, *args, **kwargs)

    monkeypatch.setattr(pk, "painn_message_fused", jax_spy)
    want = {cd: JaxPaiNN(**kw, use_pallas=True, compute_dtype=cd).apply(variables, batch)
            for cd in ("bfloat16",) + ((None,) if layers == 2 else ())}
    assert jax_dtypes[:layers] == [(jnp.bfloat16, jnp.bfloat16), (jnp.bfloat16, jnp.bfloat16),
                                   (jnp.bfloat16, jnp.float32)][:layers]
    seen = []
    orig = port_painn.painn_message_fused

    def spy(xh, vec, *args, **kwargs):
        seen.append((xh.dtype, vec.dtype))
        return orig(xh, vec, *args, **kwargs)

    monkeypatch.setattr(port_painn, "painn_message_fused", spy)
    sd = painn_state_dict_from_jax(variables)
    got = {}
    for cd in ("bfloat16", None):
        model = PaiNN(**kw, compute_dtype=cd, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got[cd] = [o.numpy() for o in model(to_torch_batch(batch))]
    assert seen[:layers] == [(BF16, BF16), (BF16, BF16), (BF16, torch.float32)][:layers]
    assert model.compute_dtype is None and PaiNN(**kw, compute_dtype="bfloat16", device="cpu").cdt == BF16
    for i in range(2):
        p16, p32 = got["bfloat16"][i], got[None][i]
        assert p16.dtype == np.float32 and np.isfinite(p16).all()
        assert _rel(p16, np.asarray(want["bfloat16"][i])) <= 2e-2, i
        assert _rel(p16, p32) > 2e-3, i
        if layers == 2:
            assert _rel(p16, np.asarray(want[None][i])) <= 5e-2, i


def test_compute_dtype_names():
    with pytest.raises(ValueError, match="compute_dtype"):
        PaiNN(**KW, compute_dtype="float16", device="cpu")


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    return make_dataset(tmp, np.random.default_rng(0), 8, "train")


def _amp_config(train, run_dir, **extra):
    cfg = config_for(train, run_dir=str(run_dir))
    cfg["model"]["use_pallas"] = True
    return dict(cfg, amp=True, **extra)


def test_amp_sets_bf16_on_model_ema_and_sampling(tiny_data, tmp_path):
    """``amp`` builds the model, its EMA copy (the sampling model) in bf16,
    as the JAX trainer does; an explicit ``compute_dtype`` is kept; outputs
    stay f32."""
    tr = DenoisingTrainer(_amp_config(tiny_data, tmp_path, cpu=True))
    assert tr.model.compute_dtype == "bfloat16" and tr.model.cdt == BF16
    tr.init_state()
    assert tr.ema_module.compute_dtype == "bfloat16"
    batch = next(iter(tr.train_batcher))
    tr1, tr2 = tr.predict_denoising(batch)
    assert tr1.dtype == tr2.dtype == torch.float32 and torch.isfinite(tr1).all()
    jt = JaxDenoisingTrainer(_amp_config(tiny_data, tmp_path / "jax"), mesh=None)
    assert jt.model.compute_dtype == jt.sampling_model.compute_dtype == "bfloat16"
    cfg = _amp_config(tiny_data, tmp_path, cpu=True)
    cfg["model"]["compute_dtype"] = None
    assert DenoisingTrainer(cfg).model.compute_dtype is None


def _named_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def test_amp_train_step_matches_jax(tiny_data, tmp_path, monkeypatch):
    """One amp step from JAX's init and the same noise draws: the loss and
    every parameter's gradient (JAX's captured before its optimiser), held
    to JAX's Pallas form at fixed limits, with JAX's XLA form no further
    from it than GRAD_SPREAD_CEILING; then all gradients as one vector
    against JAX's bf16 and the port's f32 step (JAX's f32 to 1e-5)."""
    repaired = jax_igso3.get_tables()._replace(exp_score_norms=igso3.get_tables().exp_score_norms)
    monkeypatch.setattr(jax_igso3, "get_tables", lambda: repaired)
    key = jax.random.PRNGKey(300)
    state, first, want = None, None, {}
    for use_pallas in (True, False):
        cfg = _amp_config(tiny_data, tmp_path / f"jax-{use_pallas}")
        cfg["model"]["use_pallas"] = use_pallas
        jt = JaxDenoisingTrainer(cfg, mesh=None)
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
        want[use_pallas] = float(jaux["loss"]), painn_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jaux["grads"]), "scale_factors": state.scale_factors})
    grads = {}
    for amp in (True, False):
        pt = DenoisingTrainer(dict(_amp_config(tiny_data, tmp_path / f"port-{amp}", cpu=True), amp=amp))
        pt.model.load_state_dict(painn_state_dict_from_jax({"params": state.params,
                                                            "scale_factors": state.scale_factors}))
        pt.init_state()
        loss, _ = pt._loss_and_aux(to_torch_batch(first), jax_schedule_draws(key, first.batch_size), None)
        if amp:
            assert abs(float(loss.detach()) - want[True][0]) <= 2e-2 * abs(want[True][0])
        grads[amp] = {name: g.numpy() for name, g in _named_grads(pt.model, loss).items()}
    jax_grads = {name: g.numpy() for name, g in want[True][1].items()}
    for name, g in grads[True].items():
        w, xla = jax_grads[name], want[False][1][name].numpy()
        assert g.dtype == np.float32
        assert np.abs(xla - w).max() <= GRAD_SPREAD_CEILING * np.abs(w).max(), name
        assert np.abs(g - w).max() <= GRAD_LIMITS.get(name, 5e-2) * np.abs(w).max() + 1e-12, name
    port16, port32, jax16 = (np.concatenate([np.ravel(d[n]) for n in grads[True]])
                             for d in (grads[True], grads[False], jax_grads))
    scale = np.abs(jax16).max()
    d32 = np.abs(port32 - jax16).max() / scale
    assert np.abs(port16 - jax16).max() / scale <= d32
    assert np.abs(port16 - port32).max() / scale >= 0.5 * d32


def test_amp_train_step_repeats_bit_for_bit(tiny_data, tmp_path):
    out = []
    for run in range(2):
        tr = DenoisingTrainer(_amp_config(tiny_data, tmp_path / str(run), cpu=True))
        batch = next(iter(tr.train_batcher))
        aux = tr.train_step(batch, generator=torch.Generator().manual_seed(5))
        out.append((float(aux["loss"]), [p.detach().clone() for p in tr.model.parameters()]))
    assert out[0][0] == out[1][0] and math.isfinite(out[0][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
