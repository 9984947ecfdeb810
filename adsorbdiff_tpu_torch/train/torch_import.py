"""Reference AdsorbDiff/OCP ``.pt`` checkpoints -> the port's models and
checkpoint format.

Port of :mod:`adsorbdiff_tpu.train.torch_import`.  The reference saves
``{state_dict, ema, config, ...}`` with DDP ``module.`` prefixes
(base_trainer.py:476-495, 625-684).

- PaiNN and GemNet-OC: the port's modules carry the reference's parameter
  names and layouts, so a reference state dict is the port's after the
  prefixes go.  :func:`reference_state_dict` checks it strictly against the
  model's own ``state_dict()``: a missing tensor raises ``KeyError`` with
  the names, a wrong shape ``ValueError``; a missing ``*.scale_factor`` is
  left out (it stays at the model's value, 1, or comes from a
  ``model.scale_file``); keys the model does not have are logged.
- EquiformerV2: the reference computes in e3nn's real-SH basis and its own
  edge frame (y axis); the port (as the JAX package) in its z-up basis and
  frame.  :func:`eqv2_state_dict_to_params` conjugates every edge-frame
  SO(2) weight with ``M0 = P D(Q_zy)`` (``P`` the basis change of
  ``assets/e3nn_basis_change.npz``, ``Q_zy`` the rotation taking our frame
  axis onto theirs), gives the edge-degree m = 0 coefficients their signs,
  and copies the global-frame weights, which commute with the per-l basis
  change.  It builds the JAX package's variable tree, which
  :func:`adsorbdiff_tpu_torch.models.equiformer_v2.eqv2_state_dict_from_jax`
  turns into the port's names.  e3nn-trained weights also need the e3nn S^2
  grid (``grid_mode: e3nn``, which :func:`reference_model_config_to_ours`
  sets).

:func:`convert_torch_checkpoint` writes the result as a checkpoint of
:mod:`adsorbdiff_tpu_torch.train.checkpoint` that the trainers load
(``python -m adsorbdiff_tpu_torch.scripts.convert_checkpoint``).
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from adsorbdiff_tpu_torch.models.equiformer_v2 import eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.models.so3 import _rotation_matrix_to_D
from adsorbdiff_tpu_torch.train import checkpoint as ckpt_io

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "e3nn_basis_change.npz")


def _strip_prefixes(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Drop DDP ``module.`` prefixes and convert tensors to numpy."""
    out = {}
    for k, v in sd.items():
        while k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint file -> its flat numpy state dict."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return _strip_prefixes(raw.get("state_dict", raw))


def _check_names(sd: Dict[str, np.ndarray], shapes: Dict[str, Tuple[int, ...]], family: str,
                 optional=lambda key: False) -> None:
    """Raise ``KeyError`` listing the names of ``shapes`` that ``sd`` lacks
    (but ``optional`` ones), ``ValueError`` on a shape that differs; log the
    keys of ``sd`` that ``shapes`` does not name."""
    missing = [k for k in shapes if k not in sd and not optional(k)]
    if missing:
        raise KeyError(f"reference {family} tensors missing from the state dict: {missing[:10]}"
                       f"{f' ... ({len(missing)} in all)' if len(missing) > 10 else ''}")
    wrong = [(k, tuple(sd[k].shape), tuple(s)) for k, s in shapes.items() if k in sd and tuple(sd[k].shape) != tuple(s)]
    if wrong:
        raise ValueError(f"reference {family} tensors of the wrong shape (name, got, want): {wrong[:10]}")
    extra = [k for k in sd if k not in shapes]
    if extra:
        logging.info(f"{family} import: {len(extra)} state dict keys not used (e.g. {extra[:5]})")


# ---------------------------------------------------------------------------
# EquiformerV2
# ---------------------------------------------------------------------------
def _load_basis_change(lmax: int) -> np.ndarray:
    """P with Y_e3nn = P Y_ours: D_ref(R) = P D_ours(R) P^T for every rotation."""
    data = np.load(ASSET)
    asset_lmax = int(data["lmax"])
    if lmax > asset_lmax:
        raise ValueError(f"basis-change asset covers lmax<={asset_lmax}, need {lmax}")
    dim = (lmax + 1) ** 2
    return np.asarray(data["P"], np.float64)[:dim, :dim]


def _eqv2_frame_change(lmax: int):
    """M0 = P D_ours(Q_zy), in float64: maps our edge-frame coefficients to
    the reference's.  Returns (sigma[l], the m = 0 signs; B[(l, m)], the
    2x2 blocks on the (l, +-m) pairs), asserting that M0 has no other
    entries."""
    P = _load_basis_change(lmax)
    q_zy = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])  # z -> y
    M0 = P @ _rotation_matrix_to_D(lmax, q_zy)

    sigma = np.zeros(lmax + 1)
    B: Dict[tuple, np.ndarray] = {}
    for l in range(lmax + 1):
        i0 = l * l + l
        sigma[l] = M0[i0, i0]
        assert abs(abs(sigma[l]) - 1) < 1e-6, (l, sigma[l])
        for m in range(1, l + 1):
            p, q = i0 + m, i0 - m
            blk = M0[np.ix_([p, q], [p, q])]
            assert abs(abs(np.linalg.det(blk)) - 1) < 1e-5, (l, m, blk)
            B[(l, m)] = blk
    total = np.abs(M0).sum()
    block_mass = np.abs(sigma).sum() + sum(np.abs(b).sum() for b in B.values())
    assert abs(total - block_mass) < 1e-5 * max(total, 1.0), (total, block_mass)
    return sigma, B


def _conj_so2_fc(w_ref: np.ndarray, m: int, lmax: int, c_in: int, c_out: int, sigma, B) -> tuple:
    """A reference ``SO2_m_Convolution`` fc weight ``[2 c_out n, n c_in]``
    (rows [W_r; W_i], n-major) -> our (wr, wi) kernels ``[n c_in, n c_out]``:
    K_ours = M0^T K_ref M0 blockwise."""
    n = lmax - m + 1
    half = c_out * n
    wr = w_ref[:half].reshape(n, c_out, n, c_in)  # [lo, co, li, ci]
    wi = w_ref[half:].reshape(n, c_out, n, c_in)
    wr_new = np.zeros_like(wr)
    wi_new = np.zeros_like(wi)
    for lo in range(n):
        Bo = B[(lo + m, m)]
        for li in range(n):
            Bi = B[(li + m, m)]
            # K_ref = [[wr, -wi], [wi, wr]] (pair structure); K' = Bo^T K Bi
            blks = {
                (0, 0): wr[lo, :, li, :], (0, 1): -wi[lo, :, li, :],
                (1, 0): wi[lo, :, li, :], (1, 1): wr[lo, :, li, :],
            }
            kp = {}
            for a in range(2):
                for b in range(2):
                    acc = np.zeros_like(wr[lo, :, li, :])
                    for g in range(2):
                        for d in range(2):
                            acc = acc + Bo[g, a] * blks[(g, d)] * Bi[d, b]
                    kp[(a, b)] = acc
            if not (np.allclose(kp[(0, 0)], kp[(1, 1)], atol=1e-5)
                    and np.allclose(kp[(0, 1)], -kp[(1, 0)], atol=1e-5)):
                raise AssertionError(f"SO2 conjugation broke complex structure at m={m}")
            wr_new[lo, :, li, :] = kp[(0, 0)]
            wi_new[lo, :, li, :] = kp[(1, 0)]
    return wr_new.reshape(half, n * c_in).T, wi_new.reshape(half, n * c_in).T


def _conj_fc_m0(w_ref: np.ndarray, b_ref, lmax: int, c_in: int, c_out: int, extra: int, sigma) -> tuple:
    """``fc_m0 [n0 c_out + extra, n0 c_in]`` -> our kernel ``[n0 c_in, extra +
    n0 c_out]`` with the sigma signs (the extra outputs first in both)."""
    n0 = lmax + 1
    w = w_ref * np.repeat(sigma, c_in)[None, :]
    kernel = np.zeros((n0 * c_in, extra + n0 * c_out), w.dtype)
    kernel[:, :extra] = w[:extra].T
    kernel[:, extra:] = (w[extra:] * np.repeat(sigma, c_out)[:, None]).T
    bias = None
    if b_ref is not None:
        bias = np.zeros(extra + n0 * c_out, b_ref.dtype)
        bias[:extra] = b_ref[:extra]
        bias[extra:] = b_ref[extra:] * np.repeat(sigma, c_out)
    return kernel, bias


def eqv2_state_dict_to_params(
    sd: Dict[str, np.ndarray],
    *,
    lmax: int = 4,
    mmax: int = 2,
    num_layers: int = 8,
    sphere_channels: int = 128,
    attn_hidden_channels: int = 64,
    num_heads: int = 8,
    attn_alpha_channels: int = 64,
    attn_value_channels: int = 16,
) -> Dict[str, Any]:
    """A reference EquiformerV2(-denoising) state dict -> the JAX package's
    variable tree ``{"params": ...}`` (nested dicts of numpy arrays), its
    ``eqv2_state_dict_to_params`` step for step (module docstring)."""
    sd = _strip_prefixes(sd)
    sigma, B = _eqv2_frame_change(lmax)
    params: Dict[str, Any] = {}

    def put(path: str, value):
        node = params
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def lin(ref: str, ours: str):
        put(ours + "/kernel", sd[ref + ".weight"].T)
        if ref + ".bias" in sd:
            put(ours + "/bias", sd[ref + ".bias"])

    def layernorm(ref: str, ours: str):
        put(ours + "/scale", sd[ref + ".weight"])
        put(ours + "/bias", sd[ref + ".bias"])

    def embed(ref: str, ours: str):
        put(ours + "/embedding", sd[ref + ".weight"])

    def rad_func(ref: str, ours: str, final_sigma: bool = False, c_last: int = 0):
        """Linear, LN, SiLU, Linear, LN, SiLU, ..., Linear: dense at Sequential
        indices 0, 3, 6, ..., LayerNorm at 1, 4, ..."""
        idxs = sorted(int(k.split(".")[-2]) for k in sd
                      if k.startswith(f"{ref}.net.") and k.endswith(".weight") and sd[k].ndim == 2)
        for di, i in enumerate(idxs):
            kern = sd[f"{ref}.net.{i}.weight"].T
            bias = sd[f"{ref}.net.{i}.bias"]
            if final_sigma and i == idxs[-1]:
                scale = np.repeat(sigma, c_last)
                kern = kern * scale[None, :]
                bias = bias * scale
            put(f"{ours}/dense_{di}/kernel", kern)
            put(f"{ours}/dense_{di}/bias", bias)
            if f"{ref}.net.{i + 1}.weight" in sd and sd[f"{ref}.net.{i + 1}.weight"].ndim == 1:
                put(f"{ours}/ln_{di}/scale", sd[f"{ref}.net.{i + 1}.weight"])
                put(f"{ours}/ln_{di}/bias", sd[f"{ref}.net.{i + 1}.bias"])

    def so2_conv(ref: str, ours: str, c_in: int, c_out: int, extra: int, has_rad: bool):
        kernel, bias = _conj_fc_m0(sd[f"{ref}.fc_m0.weight"], sd.get(f"{ref}.fc_m0.bias"), lmax, c_in, c_out,
                                   extra, sigma)
        put(f"{ours}/fc_m0/kernel", kernel)
        if bias is not None:
            put(f"{ours}/fc_m0/bias", bias)
        for m in range(1, mmax + 1):
            wr, wi = _conj_so2_fc(sd[f"{ref}.so2_m_conv.{m - 1}.fc.weight"], m, lmax, c_in, c_out, sigma, B)
            put(f"{ours}/fc_m{m}_r/kernel", wr)
            put(f"{ours}/fc_m{m}_i/kernel", wi)
        if has_rad:
            rad_func(f"{ref}.rad_func", f"{ours}/rad_func")

    def so3_linear(ref: str, ours: str):
        put(f"{ours}/weight", sd[f"{ref}.weight"])
        put(f"{ours}/bias", sd[f"{ref}.bias"])

    def norm_sh(ref: str, ours: str):
        layernorm(f"{ref}.norm_l0", f"{ours}/norm_l0")
        put(f"{ours}/affine_weight", sd[f"{ref}.affine_weight"])

    def ffn(ref: str, ours: str):
        lin(f"{ref}.scalar_mlp.0", f"{ours}/scalar_mlp")
        so3_linear(f"{ref}.so3_linear_1", f"{ours}/so3_linear_1")
        for j, t in enumerate((0, 2, 4)):
            put(f"{ours}/grid_mlp_{j}/kernel", sd[f"{ref}.grid_mlp.{t}.weight"].T)
        so3_linear(f"{ref}.so3_linear_2", f"{ours}/so3_linear_2")

    def attention(ref: str, ours: str):
        embed(f"{ref}.source_embedding", f"{ours}/source_embedding")
        embed(f"{ref}.target_embedding", f"{ours}/target_embedding")
        extra = num_heads * attn_alpha_channels + attn_hidden_channels
        so2_conv(f"{ref}.so2_conv_1", f"{ours}/so2_conv_1", 2 * sphere_channels, attn_hidden_channels, extra,
                 has_rad=True)
        layernorm(f"{ref}.alpha_norm", f"{ours}/alpha_norm")
        put(f"{ours}/alpha_dot", sd[f"{ref}.alpha_dot"])
        so2_conv(f"{ref}.so2_conv_2", f"{ours}/so2_conv_2", attn_hidden_channels, num_heads * attn_value_channels,
                 0, has_rad=False)
        so3_linear(f"{ref}.proj", f"{ours}/proj")

    embed("sphere_embedding", "sphere_embedding")
    if "energy_embedding.weight" in sd:
        lin("energy_embedding", "energy_embedding")
    embed("edge_degree_embedding.source_embedding", "edge_degree_source_embedding")
    embed("edge_degree_embedding.target_embedding", "edge_degree_target_embedding")
    rad_func("edge_degree_embedding.rad_func", "edge_degree_rad_func", final_sigma=True, c_last=sphere_channels)
    for i in range(num_layers):
        norm_sh(f"blocks.{i}.norm_1", f"norm_attn_{i}")
        attention(f"blocks.{i}.ga", f"attn_{i}")
        norm_sh(f"blocks.{i}.norm_2", f"norm_ffn_{i}")
        ffn(f"blocks.{i}.ffn", f"ffn_{i}")
    norm_sh("norm", "norm_final")
    if "energy_block.so3_linear_1.weight" in sd:
        ffn("energy_block", "energy_block")
    attention("force_block", "force_block")
    if "force_block2.so2_conv_1.fc_m0.weight" in sd:
        attention("force_block2", "force_block2")
    return {"params": params}


def eqv2_reference_shapes(*, lmax: int = 4, mmax: int = 2, num_layers: int = 8, sphere_channels: int = 128,
                          attn_hidden_channels: int = 64, num_heads: int = 8, attn_alpha_channels: int = 64,
                          attn_value_channels: int = 16, ffn_hidden_channels: int = 128, edge_channels: int = 128,
                          num_distance_basis: int = 600, max_num_elements: int = 90,
                          energy_encoding: Optional[str] = None, energy_block: bool = False,
                          force_block2: bool = True) -> Dict[str, Tuple[int, ...]]:
    """The names and shapes of a reference EquiformerV2(-denoising) state
    dict at these widths (equiformer_v2_oc20.py / equiformer_v2_denoising.py
    with the published options): what the importer reads, with the energy
    embedding, the S2EF energy block and the rotation head as asked."""
    c, ec, n0 = sphere_channels, edge_channels, lmax + 1
    shapes: Dict[str, Tuple[int, ...]] = {}

    def lin(name, n_in, n_out, bias=True):
        shapes[name + ".weight"] = (n_out, n_in)
        if bias:
            shapes[name + ".bias"] = (n_out,)

    def layernorm(name, n):
        shapes[name + ".weight"] = shapes[name + ".bias"] = (n,)

    def rad_func(name, channels):
        for j in range(len(channels) - 1):
            lin(f"{name}.net.{3 * j}", channels[j], channels[j + 1])
            if j < len(channels) - 2:
                layernorm(f"{name}.net.{3 * j + 1}", channels[j + 1])

    def so3_linear(name, n_in, n_out):
        shapes[name + ".weight"] = (lmax + 1, n_out, n_in)
        shapes[name + ".bias"] = (n_out,)

    def so2_conv(name, c_in, c_out, extra=0, rad=False):
        lin(name + ".fc_m0", n0 * c_in, n0 * c_out + extra)
        for m in range(1, mmax + 1):
            lin(f"{name}.so2_m_conv.{m - 1}.fc", (lmax - m + 1) * c_in, 2 * c_out * (lmax - m + 1), bias=False)
        if rad:
            gated = n0 * c_in + sum((lmax - m + 1) * c_in for m in range(1, mmax + 1))
            rad_func(name + ".rad_func", (num_distance_basis + 2 * ec, ec, ec, gated))

    def norm_sh(name):
        layernorm(name + ".norm_l0", c)
        shapes[name + ".affine_weight"] = (lmax, c)

    def attention(name, c_out):
        shapes[name + ".source_embedding.weight"] = shapes[name + ".target_embedding.weight"] = (max_num_elements, ec)
        so2_conv(name + ".so2_conv_1", 2 * c, attn_hidden_channels,
                 num_heads * attn_alpha_channels + attn_hidden_channels, rad=True)
        layernorm(name + ".alpha_norm", attn_alpha_channels)
        shapes[name + ".alpha_dot"] = (num_heads, attn_alpha_channels)
        so2_conv(name + ".so2_conv_2", attn_hidden_channels, num_heads * attn_value_channels)
        so3_linear(name + ".proj", num_heads * attn_value_channels, c_out)

    def ffn(name, c_out):
        lin(name + ".scalar_mlp.0", c, ffn_hidden_channels)
        so3_linear(name + ".so3_linear_1", c, ffn_hidden_channels)
        for t in (0, 2, 4):
            lin(f"{name}.grid_mlp.{t}", ffn_hidden_channels, ffn_hidden_channels, bias=False)
        so3_linear(name + ".so3_linear_2", ffn_hidden_channels, c_out)

    shapes["sphere_embedding.weight"] = (max_num_elements, c)
    if energy_encoding == "scalar":
        lin("energy_embedding", 1, c)
    shapes["edge_degree_embedding.source_embedding.weight"] = (max_num_elements, ec)
    shapes["edge_degree_embedding.target_embedding.weight"] = (max_num_elements, ec)
    rad_func("edge_degree_embedding.rad_func", (num_distance_basis + 2 * ec, ec, ec, n0 * c))
    for i in range(num_layers):
        norm_sh(f"blocks.{i}.norm_1")
        attention(f"blocks.{i}.ga", c)
        norm_sh(f"blocks.{i}.norm_2")
        ffn(f"blocks.{i}.ffn", c)
    norm_sh("norm")
    if energy_block:
        ffn("energy_block", 1)
    attention("force_block", 1)
    if force_block2:
        attention("force_block2", 1)
    return shapes


def _eqv2_widths(model) -> Dict[str, Any]:
    """The importer's width arguments, read from an EquiformerV2 of the port."""
    attn = model.force_block
    return dict(lmax=model.lmax, mmax=model.mmax, num_layers=model.num_layers, sphere_channels=model.sphere_channels,
                attn_hidden_channels=attn.attn_hidden, num_heads=attn.num_heads,
                attn_alpha_channels=attn.attn_alpha, attn_value_channels=attn.attn_value)


def eqv2_state_dict_from_reference(sd: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """A reference EquiformerV2 state dict -> the state dict of the port's
    ``model`` (an :class:`EquiformerV2` whose widths and heads it is read
    against): the names checked as :func:`_check_names` checks them, then
    the conjugation of :func:`eqv2_state_dict_to_params` and the renames of
    ``eqv2_state_dict_from_jax``."""
    sd = _strip_prefixes(sd)
    widths = _eqv2_widths(model)
    shapes = eqv2_reference_shapes(
        **widths, ffn_hidden_channels=model.ffn_hidden_channels, edge_channels=model.edge_channels,
        num_distance_basis=model.num_distance_basis,
        max_num_elements=model.max_num_elements, energy_encoding=model.energy_encoding,
        energy_block=hasattr(model, "energy_block"), force_block2=hasattr(model, "force_block2"))
    _check_names(sd, shapes, "EquiformerV2")
    keep = {k: v for k, v in sd.items() if k in shapes}  # so a head the model lacks is not imported
    return eqv2_state_dict_from_jax(eqv2_state_dict_to_params(keep, **widths))


# ---------------------------------------------------------------------------
# every family
# ---------------------------------------------------------------------------
def reference_state_dict(sd: Dict[str, Any], model) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A reference state dict (any family; ``module.`` prefixes allowed) ->
    ``(params, scale_factors)`` for the port's ``model``, by name, as f32
    CPU tensors: every parameter, and the ``*.scale_factor`` buffers the
    state dict holds."""
    from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2

    own = model.state_dict()
    if isinstance(model, EquiformerV2):
        family = "EquiformerV2"
        sd = {k: v.numpy() for k, v in eqv2_state_dict_from_reference(sd, model).items()}
    else:
        family = type(model).__name__
        sd = _strip_prefixes(sd)
    _check_names(sd, {k: tuple(v.shape) for k, v in own.items()}, family,
                 optional=lambda key: key.endswith(".scale_factor"))
    names = [n for n, _ in model.named_parameters()]
    params = {n: torch.from_numpy(np.array(sd[n], dtype=np.float32)) for n in names}
    scale_factors = {n: torch.from_numpy(np.array(sd[n], dtype=np.float32)) for n in own
                     if n.endswith(".scale_factor") and n in sd}
    logging.info(f"imported {len(params)} {family} parameters and {len(scale_factors)} scale factors")
    return params, scale_factors


def reference_model_config_to_ours(ref_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A reference checkpoint's embedded model config -> the port's model
    config (the JAX package's translation): the family from the registry
    name or class path (else ``ValueError``), reference-only keys dropped,
    ``max_radius`` -> ``cutoff``, ``FOR_denoising`` -> ``for_denoising``,
    ``lmax_list``/``mmax_list`` -> ``lmax``/``mmax``; EquiformerV2 gets
    ``radii_pm_bug_compat: True`` (the reference's raw-pm radii offset),
    ``grid_resolution: 18`` and ``grid_mode: e3nn`` unless set."""
    cfg = dict(ref_cfg)
    name = str(cfg.pop("name", "")).lower()
    attrs = {k: v for k, v in cfg.items() if not k.startswith("_")}
    if "painn" in name:
        family = "painn"
    elif "equiformer" in name or "eqv2" in name:
        family = "equiformer_v2"
    elif "gemnet" in name:
        family = "gemnet_oc"
    else:
        raise ValueError(f"cannot detect model family from reference name '{name}'")

    drop = {
        "num_atoms", "bond_feat_dim", "num_targets", "use_pbc", "regress_forces",
        "otf_graph", "direct_forces", "scale_file", "num_sphere_samples",
        "distance_function", "attn_activation", "ffn_activation", "weight_init",
        "use_s2_act_attn", "use_attn_renorm", "use_gate_act", "use_grid_mlp",
        "use_sep_s2_act", "use_m_share_rad", "share_atom_edge_embedding",
        "norm_type", "enforce_max_neighbors_strictly", "scale_backprop_forces",
        "forces_coupled", "output_init", "activation", "num_distance_basis",
        "rbf_spherical", "use_energy_lin_ref", "load_energy_lin_ref",
        "avg_num_nodes", "avg_degree", "enforce_max_strictly",
    }
    out: Dict[str, Any] = {"name": family}
    rename = {"max_radius": "cutoff", "FOR_denoising": "for_denoising"}
    for k, v in attrs.items():
        if k in drop:
            continue
        k = rename.get(k, k)
        if k == "lmax_list":
            out["lmax"] = int(v[0])
        elif k == "mmax_list":
            out["mmax"] = int(v[0])
        elif k == "qint_tags":
            out["qint_tags"] = tuple(int(t) for t in v)
        else:
            out[k] = v
    if family == "equiformer_v2":
        out.setdefault("radii_pm_bug_compat", True)
        out.setdefault("grid_resolution", 18)
        out.setdefault("grid_mode", "e3nn")
    return out


def embedded_model_config(raw: Dict[str, Any]) -> Dict[str, Any]:
    """The reference model config a checkpoint embeds: ``config.model_attributes``
    (or a ``config.model`` dict), named by ``config.model`` where that is a
    string."""
    config = raw.get("config") or {}
    model = config.get("model")
    out = config.get("model_attributes") or (model if isinstance(model, dict) else {})
    if isinstance(model, str):
        out = dict(out or {}, name=model)
    return dict(out or {})


def build_model(model_cfg: Dict[str, Any]):
    """The port's model of ``model_cfg`` on the CPU (a ``cell_reps: auto``
    left to the trainer: the names and shapes do not depend on it)."""
    from adsorbdiff_tpu_torch.train.trainer import _model_from_config

    cfg = {k: v for k, v in model_cfg.items() if not (k == "cell_reps" and v == "auto")}
    return _model_from_config(cfg, mode=None, device=torch.device("cpu"), generator=torch.Generator().manual_seed(0))


def convert_torch_checkpoint(torch_path: str, out_dir: str, name: str = "checkpoint",
                             model_cfg_override: Optional[Dict[str, Any]] = None) -> str:
    """A reference ``.pt`` checkpoint -> the port's checkpoint ``out_dir/name``
    and its sidecar ``<path>.config.yaml`` (``{"model": ...}``).  Returns the
    path.

    The model config is the checkpoint's embedded one translated by
    :func:`reference_model_config_to_ours`, then ``model_cfg_override``.  The
    file holds step 0, the weights, an EMA copy equal to them (the reference
    keeps its EMA as an ordered list, not by name; published checkpoints
    were saved after ``copy_to``, so their weights are the EMA's), a zero
    AdamW state (count 0), the scale factors the state dict holds, and the
    model config: ``DenoisingTrainer``/``S2EFTrainer.load_checkpoint`` load
    it as it is.
    """
    import yaml

    raw = torch.load(torch_path, map_location="cpu", weights_only=False)
    model_cfg = reference_model_config_to_ours(embedded_model_config(raw))
    model_cfg.update(model_cfg_override or {})
    model = build_model(model_cfg)
    params, scale_factors = reference_state_dict(raw.get("state_dict", raw), model)
    state = {
        "step": 0,
        "params": params,
        "ema_params": {n: p.clone() for n, p in params.items()},
        "scale_factors": scale_factors,
        "opt_state": {"count": torch.zeros((), dtype=torch.int32),
                      "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                      "nu": {n: torch.zeros_like(p) for n, p in params.items()}},
    }
    config = {"model": model_cfg}
    path = ckpt_io.save_checkpoint(out_dir, name, state, config=config)
    with open(path + ".config.yaml", "w") as f:
        yaml.safe_dump(ckpt_io._plain(config), f)
    return path
