"""PyTorch port in bf16 (``compute_dtype: bfloat16``): the EquiformerV2
model, plain with both so3 heads and energy-conditional, against the JAX
package's bf16 forward on the CPU.

Its own file: JAX's bf16 model with its Pallas kernels in interpret mode
(``use_pallas``, ``use_pallas_conv1`` and ``use_pallas_rotate``: the kernel
forms, which the port's model always runs) compiles for ~40 s.  Weights from
the JAX package's init through ``eqv2_state_dict_from_jax``.

Tolerance: 2e-2 * max|JAX bf16| per output against JAX's bf16 forward with
the kernel forms (JAX's own spread under 2e-7 parameter perturbations is
0.7-1.1% of max on this batch, its XLA-form bf16 is 1.7% from its kernel
form; the port read 0.65-0.84%), and more than 5e-3 * max away from the
port's own f32 forward (1.7% here: the model does round).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adsorbdiff_tpu.ops.pallas_kernels as pk
from adsorbdiff_tpu.models.equiformer_v2 import EquiformerV2 as JaxEquiformerV2
from adsorbdiff_tpu_torch.models import equiformer_v2 as port_eqv2
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2, eqv2_state_dict_from_jax
from tests.port_bridge import to_torch_batch
from tests.test_equiformer_v2 import TINY
from tests.test_painn import make_batch
from tests.test_torch_bf16_eqv2 import BF16, KERNEL_FORMS, KERNEL_NAMES, _interpret, _rel
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

MODEL_RTOL, MODEL_SEPARATION = 2e-2, 5e-3


MODES = {"so3": dict(so3_denoising=True, for_denoising=True),
         "conditional": dict(so3_denoising=False, for_denoising=False, energy_encoding="scalar")}


@pytest.mark.parametrize("mode", list(MODES))
def test_eqv2_bf16_forward_matches_jax(mode, monkeypatch):
    """The bf16 model (plain with both so3 heads, and energy-conditional)
    against JAX's bf16 forward with the kernel forms; the kernels see the
    dtypes JAX's see (bf16 per-edge chains, the edge-degree rotation f32)."""
    kw = MODES[mode]
    batch = make_batch(np.random.default_rng(7))
    assert np.abs(np.asarray(batch.energy)).max() > 0  # the conditional model's energies reach it
    variables = jax.tree.map(np.asarray, dict(JaxEquiformerV2(**TINY, **kw).init(jax.random.PRNGKey(0), batch)))
    _interpret(monkeypatch)
    jax_dtypes, port_dtypes = [], []

    def spy(module, name, seen, convert):
        orig = getattr(module, name)

        def fn(*args, **kwargs):
            seen.append((name, convert(args[0].dtype), convert(args[4].dtype) if name == "eqv2_attn_conv1" else None))
            return orig(*args, **kwargs)

        monkeypatch.setattr(module, name, fn)

    for name in KERNEL_NAMES:
        spy(pk, name, jax_dtypes, lambda d: str(jnp.dtype(d)))
        spy(port_eqv2, name, port_dtypes, lambda d: str(d).replace("torch.", ""))
    want = [np.asarray(o) for o in jax.tree.leaves(
        JaxEquiformerV2(**TINY, **kw, compute_dtype="bfloat16", **KERNEL_FORMS).apply(variables, batch))]
    sd = eqv2_state_dict_from_jax(variables)
    got = {}
    for cd in ("bfloat16", None):
        model = EquiformerV2(**TINY, **kw, compute_dtype=cd, device="cpu")
        model.load_state_dict(sd)
        assert model.compute_dtype == cd and model.cdt == (BF16 if cd else None)
        with torch.no_grad():
            out = model(to_torch_batch(batch))
        got[cd] = [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]
        if cd == "bfloat16":
            assert port_dtypes == jax_dtypes
    assert ("eqv2_edge_rotate", "float32", None) in jax_dtypes and ("eqv2_attn_conv1", "float32", "bfloat16") in jax_dtypes
    assert ("s2_grid_silu", "bfloat16", None) in jax_dtypes
    assert len(got["bfloat16"]) == len(want)
    for p16, p32, w in zip(got["bfloat16"], got[None], want):
        assert p16.dtype == np.float32 and p16.shape == w.shape and np.isfinite(p16).all()
        assert _rel(p16, w) <= MODEL_RTOL
        assert _rel(p16, p32) > MODEL_SEPARATION


def test_eqv2_compute_dtype_names():
    with pytest.raises(ValueError, match="compute_dtype"):
        EquiformerV2(**TINY, compute_dtype="float16", device="cpu")
