"""EquiformerV2: the SO(2)-convolution graph-attention transformer on
spherical harmonics, in PyTorch.

Port of :mod:`adsorbdiff_tpu.models.equiformer_v2` on the dense padded
``[B, N, K]`` neighbour table: node features are real-SH coefficient tensors
``[B, N, (lmax+1)^2, C]``; edges rotate into the truncated m-primary edge
frame of :mod:`adsorbdiff_tpu_torch.models.so3`; every attention block runs
three Hopper kernels, as the JAX model's
``use_pallas=True, use_pallas_conv1=True, use_pallas_rotate=True`` branch
does:

- :func:`adsorbdiff_tpu_torch.ops.kernels.eqv2_attn_conv1` (gaussian basis ->
  radial trunk -> per-m gates -> gated first SO(2) conv), fed the radii-offset,
  clamped distances; its VJP recomputes the plain version;
- :func:`adsorbdiff_tpu_torch.ops.kernels.s2_grid_silu` (the separable S^2
  activation on the l > 0 rows, the m-truncation rescale folded into the grid
  matrices), whose backward is the ``s2_grid_silu_bwd`` kernel;
- :func:`adsorbdiff_tpu_torch.ops.kernels.eqv2_edge_rotate` /
  ``eqv2_gather_rotate_to`` (every edge-frame rotation: each attention's
  source half, target half and value rotation back, and the edge-degree
  embedding's), whose VJP is the same kernel in the dual direction.  On the
  card it is faster than the decomposed chain of :mod:`so3` (the kernel's
  plain version, which the JAX package's XLA path runs).

There is no switch for those: ``use_pallas``, ``use_pallas_conv1`` and
``use_pallas_rotate`` are accepted for config compatibility and ignored.

Training: the drop regularisers (post-softmax ``alpha_drop`` in the
transformer blocks' attention; per-graph ``drop_path_rate`` and
per-(graph, node, channel) ``proj_drop`` on both residual branches) apply
only in a train-mode forward, i.e. while ``nn.Module.training`` is True.  The
constructor's ``training`` argument sets that flag (``model.train()`` and
``model.eval()`` switch it later), so the default model is in eval mode and
draws nothing.  A train-mode forward with a non-zero rate takes its masks
from the ``dropout_generator`` the caller passes, never from the global RNG.

Parameter names follow the JAX module tree
(``blocks.3.attn.so2_conv_1.fc_m0.weight`` for flax's
``attn_3/so2_conv_1/fc_m0/kernel``), not the AdsorbDiff reference's: the JAX
package keeps its SO(2) and radial weights in another basis and layout than
the reference (a per-l change of basis, m-primary rows, fused group kernels),
so a reference ``.pt`` does not load into these names as it is.
:func:`eqv2_state_dict_from_jax` converts a JAX variable tree with plain
transposes, and ``adsorbdiff_tpu_torch/train/torch_import.py`` a reference
state dict (the basis change, then that function).

``compute_dtype="bfloat16"`` (the trainers' ``amp``) is the JAX model's bf16
path: it casts where that model casts and keeps the rest f32 (the geometry,
the edge-degree embedding, the layer norms, the attention's alpha, its
softmax and its sum over neighbours, every parameter).  bf16 are each
attention's per-edge chain (its input cast before the rotations, the
rotation, conv1, S^2 activation and internal SO(2) conv, the heads'
weighting and the rotation back, through the bf16 variants of the kernels)
and the FFN's grid MLP (its three Dense layers, SiLUs and the product back
from the grid, then ``so3_linear_2``); the SO3Linear layers that take f32
inputs round input and weight to bf16 and sum in f32.  The outputs are f32.

``grid_mode`` picks the S^2 quadrature of every S^2 activation and grid
MLP: ``"gauss"`` (the training default) or ``"e3nn"``, the soft grid with the
component scale that reference (e3nn-trained) checkpoints need
(:func:`adsorbdiff_tpu_torch.models.so3.s2_grid_matrices`); the kernels take
either set of tables.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.models.base import generate_graph, prepare_candidate_graph, prepare_static_graph
from adsorbdiff_tpu_torch.models.layers import Linear, div, lecun_normal_, resolve_compute_dtype, silu
from adsorbdiff_tpu_torch.models.so3 import (
    edge_euler_angles,
    l1_coeffs_to_vector,
    m_primary_order,
    m_trunc_rescale,
    s2_grid_matrices,
)
from adsorbdiff_tpu_torch.ops.kernels import eqv2_attn_conv1, eqv2_edge_rotate, eqv2_gather_rotate_to, s2_grid_silu
from adsorbdiff_tpu_torch.ops.pbc import CandidateTable, NeighborList, StaticGraphPart

# Reference constants (the JAX package's equiformer_v2.py:75-77)
_AVG_NUM_NODES = 77.81317
_AVG_DEGREE = 23.395238876342773

# Atomic radii, raw picometers as the reference stores them (NaN entries -> 0);
# the denoising offset divides by 100 for Angstroms unless radii_pm_bug_compat
# replicates the reference's discarded division.
ATOMIC_RADII_PM = np.array([
    0.0, 25.0, 120.0, 145.0, 105.0, 85.0, 70.0, 65.0, 60.0, 50.0, 160.0,
    180.0, 150.0, 125.0, 110.0, 100.0, 100.0, 100.0, 71.0, 220.0, 180.0,
    160.0, 140.0, 135.0, 140.0, 140.0, 140.0, 135.0, 135.0, 135.0, 135.0,
    130.0, 125.0, 115.0, 115.0, 115.0, 0.0, 235.0, 200.0, 180.0, 155.0,
    145.0, 145.0, 135.0, 130.0, 135.0, 140.0, 160.0, 155.0, 155.0, 145.0,
    145.0, 140.0, 140.0, 0.0, 260.0, 215.0, 195.0, 185.0, 185.0, 185.0,
    185.0, 185.0, 185.0, 180.0, 175.0, 175.0, 175.0, 175.0, 175.0, 175.0,
    175.0, 155.0, 145.0, 135.0, 135.0, 130.0, 135.0, 135.0, 135.0, 150.0,
    190.0, 180.0, 160.0, 190.0, 0.0, 0.0, 0.0, 215.0, 195.0, 180.0,
    180.0, 175.0, 175.0, 175.0, 175.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
])


def gaussian_smearing(dist: torch.Tensor, cutoff: float, num: int = 600, width_scalar: float = 2.0) -> torch.Tensor:
    """GaussianSmearing(0, cutoff, num, width_scalar), ``[..., num]``."""
    offsets = torch.linspace(0.0, cutoff, num, dtype=dist.dtype, device=dist.device)
    delta = cutoff / (num - 1)
    coeff = -0.5 / (width_scalar * delta) ** 2
    return torch.exp(coeff * (dist[..., None] - offsets) ** 2)


def smooth_leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return ((1 + alpha) / 2) * x + ((1 - alpha) / 2) * x * (2 * torch.sigmoid(x) - 1)


def gather_nodes(a: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``a [B, N, ...]`` at the neighbour table ``src [B, N, K]`` ->
    ``[B, N, K, ...]`` (an index gather)."""
    b = src.shape[0]
    batch = torch.arange(b, device=src.device)[:, None, None]
    return a[batch, src.long()]


def bernoulli_keep(generator: Optional[torch.Generator], keep: float, shape: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """A drop mask: True with probability ``keep``, drawn from ``generator``
    (the JAX model's ``jax.random.bernoulli(rng, keep, shape)``; the two
    frameworks draw different bits from one seed)."""
    if generator is None:
        raise ValueError("a train-mode EquiformerV2 forward with drop rates needs a dropout_generator")
    return torch.rand(shape, generator=generator, device=device) < keep


def _drop(y: torch.Tensor, rate: float, shape: Tuple[int, ...], generator: Optional[torch.Generator]) -> torch.Tensor:
    """``y`` times a keep mask of ``shape`` over ``1 - rate`` (no draw for rate
    0), in y's dtype (a bf16 y is divided by ``1 - rate`` rounded to bf16, as
    JAX divides by the weakly typed float)."""
    if rate <= 0.0:
        return y
    keep = 1.0 - rate
    return div(y * bernoulli_keep(generator, keep, shape, y.device).to(y.dtype), keep)


def _jax_dense(linear: nn.Linear) -> Dict[str, torch.Tensor]:
    """A Linear as flax's Dense tree: ``kernel [in, out]`` (a view) and ``bias``."""
    tree = {"kernel": linear.weight.t()}
    if linear.bias is not None:
        tree["bias"] = linear.bias
    return tree


def s2_act_matrices(lmax: int, mmax: int, grid_res: int, grid_mode: str = "gauss") -> Tuple[np.ndarray, np.ndarray]:
    """The attention's S^2 activation matrices ``(to_eff [G, n_act], from_eff
    [n_act, G])``: the grid matrices of ``grid_mode`` (with e3nn's component
    scale already in them) on the truncated m-primary rows with the
    m-truncation rescale folded in, as f32 products (the JAX model's
    ``equiformer_v2.py:607-618``)."""
    order, ranges = m_primary_order(lmax, mmax)
    keep = order[: ranges[-1][1]]
    rescale = m_trunc_rescale(lmax, mmax)[keep]
    to_grid, from_grid = s2_grid_matrices(lmax, grid_res, grid_res, grid_mode)
    return (np.ascontiguousarray(to_grid[:, keep] * rescale[None, :]),
            np.ascontiguousarray(rescale[:, None] * from_grid[keep, :]))


class RadialFunction(nn.Module):
    """Linear + LayerNorm + SiLU chain; ``channels = [in, hidden..., out]``,
    LayerNorm (eps 1e-6, flax's) and SiLU after every layer but the last."""

    def __init__(self, channels: Tuple[int, ...]) -> None:
        super().__init__()
        self.n = len(channels) - 1
        for i in range(self.n):
            self.add_module(f"dense_{i}", nn.Linear(channels[i], channels[i + 1]))
            if i < self.n - 1:
                self.add_module(f"ln_{i}", nn.LayerNorm(channels[i + 1], eps=1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = F.silu(getattr(self, f"ln_{i}")(x))
        return x

    def jax_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters as the JAX RadialFunction tree (views)."""
        tree = {}
        for i in range(self.n):
            tree[f"dense_{i}"] = _jax_dense(getattr(self, f"dense_{i}"))
            if i < self.n - 1:
                ln = getattr(self, f"ln_{i}")
                tree[f"ln_{i}"] = {"scale": ln.weight, "bias": ln.bias}
        return tree


class EquivariantLayerNormSH(nn.Module):
    """``layer_norm_sh``: LayerNorm on l=0; one shared degree-balanced RMS
    over all l > 0 with per-(l, channel) affine weights."""

    def __init__(self, lmax: int, channels: int) -> None:
        super().__init__()
        self.lmax = lmax
        self.norm_l0 = nn.LayerNorm(channels, eps=1e-6)
        self.affine_weight = nn.Parameter(torch.ones(lmax, channels))
        w_bal = np.zeros((lmax + 1) ** 2 - 1, np.float32)
        l_row = np.zeros((lmax + 1) ** 2 - 1, np.int64)
        for l in range(1, lmax + 1):
            w_bal[l * l - 1 : (l + 1) * (l + 1) - 1] = 1.0 / (2 * l + 1)
            l_row[l * l - 1 : (l + 1) * (l + 1) - 1] = l - 1
        self.register_buffer("w_bal", torch.from_numpy(w_bal / max(lmax, 1)), persistent=False)
        self.register_buffer("l_row", torch.from_numpy(l_row), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [..., (L)^2, C]
        out0 = self.norm_l0(x[..., 0, :])[..., None, :]
        if self.lmax == 0:
            return out0
        rest = x[..., 1:, :]
        norm = torch.einsum("...ic,i->...c", rest**2, self.w_bal)
        inv = (norm.mean(dim=-1)[..., None, None] + 1e-5) ** -0.5
        return torch.cat([out0, rest * inv * self.affine_weight[self.l_row]], dim=-2)


class SO3Linear(nn.Module):
    """Per-l linear, bias on l=0: ``weight [lmax+1, C_out, C_in]`` applied
    over the full coefficient axis.  With ``cdt``, input and weight are
    rounded to it and the output keeps the input's dtype (the JAX layer's
    f32 l-expansion widens the product for an f32 input: sums in f32, an f32
    output; a bf16 input gives a bf16 product and bias)."""

    def __init__(self, c_in: int, c_out: int, lmax: int, cdt: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.c_in, self.cdt = c_in, cdt
        self.weight = nn.Parameter(torch.empty(lmax + 1, c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))
        l_row = np.concatenate([np.full(2 * l + 1, l) for l in range(lmax + 1)])
        self.register_buffer("l_row", torch.from_numpy(l_row), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[self.l_row]
        if self.cdt is not None:
            x, w = x.to(self.cdt).to(x.dtype), w.to(self.cdt).to(x.dtype)
        y = torch.einsum("...ic,ioc->...io", x, w)
        return torch.cat([y[..., :1, :] + self.bias.to(y.dtype), y[..., 1:, :]], dim=-2)


class SO2Conv(nn.Module):
    """SO(2) convolution in the edge frame on the truncated m-primary layout
    ``[..., n_act, C]`` (block ranges m0, +1, -1, +2, -2, ...).

    ``fc_m0`` is ``Linear(n0 C_in, extra + n0 C_out)`` with the ``extra``
    invariant outputs in its first columns; ``fc_m{i}_{r,i}`` are bias-free
    ``Linear(n_i C_in, n_i C_out)`` (inputs flattened n-major).  With
    ``internal_weights=False`` the module also holds ``rad_func``, the radial
    trunk whose output gates the input per m-block; that conv runs only
    through :func:`adsorbdiff_tpu_torch.ops.kernels.eqv2_attn_conv1`
    (:meth:`jax_trees` hands its weights over), so ``forward`` is the
    internal-weights conv.
    """

    def __init__(self, lmax: int, mmax: int, c_in: int, c_out: int, extra_m0_out: int = 0,
                 internal_weights: bool = True, rad_channels: Tuple[int, ...] = (),
                 cdt: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.lmax, self.mmax, self.c_in, self.c_out, self.cdt = lmax, mmax, c_in, c_out, cdt
        self.extra = extra_m0_out
        self.internal_weights = internal_weights
        self.ranges = m_primary_order(lmax, mmax)[1]
        n0 = self.ranges[0][1]
        n_pos = [b - a for a, b in self.ranges[1::2]]
        if not internal_weights:
            self.rad_func = RadialFunction(tuple(rad_channels) + ((n0 + sum(n_pos)) * c_in,))
        self.fc_m0 = nn.Linear(n0 * c_in, extra_m0_out + n0 * c_out)
        for mi, nl in enumerate(n_pos):
            self.add_module(f"fc_m{mi + 1}_r", nn.Linear(nl * c_in, nl * c_out, bias=False))
            self.add_module(f"fc_m{mi + 1}_i", nn.Linear(nl * c_in, nl * c_out, bias=False))

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``layer(x)``; with ``cdt``, input and weight cast to it, the product
        rounded, then the bias added in it (the JAX group linear's order)."""
        if self.cdt is None:
            return layer(x)
        y = F.linear(x.to(self.cdt), layer.weight.to(self.cdt))
        return y if layer.bias is None else y + layer.bias.to(self.cdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.internal_weights:
            raise RuntimeError("the gated conv runs through eqv2_attn_conv1 (see jax_trees)")
        n0 = self.ranges[0][1]
        y0 = self._linear(self.fc_m0, x[..., :n0, :].flatten(-2))
        pieces = [y0[..., self.extra:].unflatten(-1, (n0, self.c_out))]
        for mi in range(self.mmax):
            (pa, pb), (qa, qb) = self.ranges[1 + 2 * mi], self.ranges[2 + 2 * mi]
            xp, xn = x[..., pa:pb, :].flatten(-2), x[..., qa:qb, :].flatten(-2)
            wr, wi = getattr(self, f"fc_m{mi + 1}_r"), getattr(self, f"fc_m{mi + 1}_i")
            pieces.append((self._linear(wr, xp) - self._linear(wi, xn)).unflatten(-1, (pb - pa, self.c_out)))
            pieces.append((self._linear(wi, xp) + self._linear(wr, xn)).unflatten(-1, (pb - pa, self.c_out)))
        return torch.cat(pieces, dim=-2)

    def jax_trees(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(rad_func tree, conv tree) as the JAX ``_SO2ConvP`` declares them."""
        conv = {"fc_m0": _jax_dense(self.fc_m0)}
        for mi in range(self.mmax):
            for part in ("r", "i"):
                name = f"fc_m{mi + 1}_{part}"
                conv[name] = _jax_dense(getattr(self, name))
        return self.rad_func.jax_tree(), conv


class GridMLPFFN(nn.Module):
    """FeedForwardNetwork, the published branch (``use_grid_mlp`` +
    ``use_sep_s2_act``): scalar SiLU MLP on l=0, SO3Linear, a bias-free
    3-layer MLP on the S^2 grid (plain matmuls), l=0 replaced by the scalar
    branch, SO3Linear out.  With ``cdt`` the grid MLP computes in it (flax's
    ``nn.Dense(dtype=cdt)``), and so do the product back from the grid and
    ``so3_linear_2``: the output is in ``cdt``."""

    def __init__(self, lmax: int, c_in: int, hidden: int, c_out: int, grid_res: int = 18,
                 cdt: Optional[torch.dtype] = None, grid_mode: str = "gauss") -> None:
        super().__init__()
        self.scalar_mlp = nn.Linear(c_in, hidden)
        self.so3_linear_1 = SO3Linear(c_in, hidden, lmax, cdt)
        for i in range(3):
            self.add_module(f"grid_mlp_{i}", Linear(hidden, hidden, bias=False, cdt=cdt))
        self.so3_linear_2 = SO3Linear(hidden, c_out, lmax, cdt)
        to_grid, from_grid = s2_grid_matrices(lmax, grid_res, grid_res, grid_mode)
        self.register_buffer("to_grid", torch.from_numpy(to_grid), persistent=False)
        self.register_buffer("from_grid", torch.from_numpy(from_grid), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scalars = F.silu(self.scalar_mlp(x[..., 0, :]))
        g = torch.matmul(self.to_grid, self.so3_linear_1(x))
        g = silu(self.grid_mlp_0(g))
        g = silu(self.grid_mlp_1(g))
        g = self.grid_mlp_2(g)
        y = torch.matmul(self.from_grid.to(g.dtype), g)
        y = torch.cat([scalars[..., None, :].to(y.dtype), y[..., 1:, :]], dim=-2)
        return self.so3_linear_2(y)


class SO2Attention(nn.Module):
    """SO2EquivariantGraphAttention, the published wiring: per-block atom-pair
    embeddings -> :func:`eqv2_attn_conv1` -> [alpha | gating scalars] ->
    :func:`s2_grid_silu` -> internal SO2Conv -> alpha-weighted heads (the
    weights dropped at ``alpha_drop`` in train mode) -> rotate back
    (+ m-truncation rescale) -> sum over neighbours -> SO3Linear."""

    def __init__(self, lmax: int, mmax: int, channels: int, attn_hidden: int, num_heads: int, attn_alpha: int,
                 attn_value: int, c_out: int, max_num_elements: int, rad_channels: Tuple[int, ...],
                 grid_res: int = 18, cutoff: float = 12.0, num_gauss: int = 600, alpha_drop: float = 0.0,
                 cdt: Optional[torch.dtype] = None, grid_mode: str = "gauss") -> None:
        super().__init__()
        self.lmax, self.mmax, self.cdt = lmax, mmax, cdt
        self.alpha_drop = alpha_drop
        self.num_heads, self.attn_alpha, self.attn_value = num_heads, attn_alpha, attn_value
        self.attn_hidden = attn_hidden
        self.cutoff, self.num_gauss = cutoff, num_gauss
        self.extra = num_heads * attn_alpha + attn_hidden
        emb_dim = rad_channels[-1]
        self.source_embedding = nn.Embedding(max_num_elements, emb_dim)
        self.target_embedding = nn.Embedding(max_num_elements, emb_dim)
        self.so2_conv_1 = SO2Conv(lmax, mmax, 2 * channels, attn_hidden, extra_m0_out=self.extra,
                                  internal_weights=False, rad_channels=rad_channels)
        self.so2_conv_2 = SO2Conv(lmax, mmax, attn_hidden, num_heads * attn_value, cdt=cdt)
        self.alpha_norm = nn.LayerNorm(attn_alpha, eps=1e-6)
        self.alpha_dot = nn.Parameter(torch.empty(num_heads, attn_alpha))
        self.proj = SO3Linear(num_heads * attn_value, c_out, lmax, cdt)

        to_eff, from_eff = s2_act_matrices(lmax, mmax, grid_res, grid_mode)
        self.register_buffer("to_eff", torch.from_numpy(to_eff), persistent=False)
        self.register_buffer("from_eff", torch.from_numpy(from_eff), persistent=False)
        self.register_buffer("rescale_out", torch.from_numpy(m_trunc_rescale(lmax, mmax)), persistent=False)

    def forward(self, x: torch.Tensor, z: torch.Tensor, z_src: torch.Tensor, nl: NeighborList,
                gamma: torch.Tensor, beta: torch.Tensor, dist: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb_s = self.source_embedding(z_src)
        emb_t = self.target_embedding(z)[:, :, None, :].expand_as(emb_s).contiguous()
        if self.cdt is not None:  # the whole per-edge chain in the compute dtype, as the JAX model casts
            x = x.to(self.cdt)
        # the source half from the source rows; the target half rotates from
        # the node table, shared by the K edges of each target
        msg_s = eqv2_gather_rotate_to(x, nl.src, gamma, beta, self.lmax, self.mmax)
        msg_t = eqv2_edge_rotate(x[:, :, None], gamma, beta, self.lmax, self.mmax, direction="to")
        rad, conv = self.so2_conv_1.jax_trees()
        h, x0_extra = eqv2_attn_conv1(
            dist, nl.mask, emb_s, emb_t, msg_s, msg_t, rad, conv, lmax=self.lmax, mmax=self.mmax,
            c_out=self.attn_hidden, extra=self.extra, num_gauss=self.num_gauss, cutoff=self.cutoff,
        )
        ha = self.num_heads * self.attn_alpha
        x0_alpha, x0_gating = x0_extra[..., :ha], x0_extra[..., ha:]

        # separable S^2 activation: l=0 <- silu(gating scalars), l>0 <- grid silu
        h_act = s2_grid_silu(h, self.to_eff, self.from_eff)
        h = torch.cat([silu(x0_gating)[..., None, :], h_act[..., 1:, :]], dim=-2)
        v = self.so2_conv_2(h)

        # alpha: LayerNorm + SmoothLeakyReLU + per-head dot, masked softmax over K (f32 in every compute dtype)
        a = self.alpha_norm(x0_alpha.float().unflatten(-1, (self.num_heads, self.attn_alpha)))
        logits = torch.einsum("...ha,ha->...h", smooth_leaky_relu(a), self.alpha_dot)
        mask = nl.mask[..., None]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        attn = torch.where(mask, torch.softmax(logits, dim=2), torch.zeros_like(logits))
        if self.training:
            attn = _drop(attn, self.alpha_drop, tuple(attn.shape), dropout_generator)

        v = v * attn.repeat_interleave(self.attn_value, dim=-1)[..., None, :].to(v.dtype)
        v_rot = eqv2_edge_rotate(v, gamma, beta, self.lmax, self.mmax, direction="from", n_sel=v.shape[-2])
        v_rot = v_rot * self.rescale_out[:, None].to(v_rot.dtype)
        v_rot = torch.where(mask[..., None], v_rot, torch.zeros_like(v_rot))
        return self.proj(v_rot.sum(dim=2, dtype=torch.float32))


class TransBlock(nn.Module):
    """One transformer block: ``norm_attn``, ``attn``, ``norm_ffn``, ``ffn``
    (the JAX model's ``{norm_attn,attn,norm_ffn,ffn}_{i}``)."""

    def __init__(self, lmax: int, channels: int, attn: SO2Attention, ffn_hidden: int, grid_res: int,
                 cdt: Optional[torch.dtype] = None, grid_mode: str = "gauss") -> None:
        super().__init__()
        self.norm_attn = EquivariantLayerNormSH(lmax, channels)
        self.attn = attn
        self.norm_ffn = EquivariantLayerNormSH(lmax, channels)
        self.ffn = GridMLPFFN(lmax, channels, ffn_hidden, channels, grid_res, cdt, grid_mode)


@registry.register_model("equiformer_v2")
@registry.register_model("equiformer_v2_denoising")
class EquiformerV2(nn.Module):
    """EquiformerV2 with the denoising heads (or ``mode="s2ef"``).

    Hyperparameters default to ``configs/denoising/eqv2_so3.yml``.  Returns
    the per-atom translation score ``[B, N, 3]`` and, with ``so3_denoising``
    and ``for_denoising``, the rotation score as a second ``[B, N, 3]``; in
    ``mode="s2ef"`` a dict with ``energy [B]`` and ``forces [B, N, 3]``.

    ``device``: the CUDA card unless ``"cpu"`` is passed (raises without a
    card).  ``generator``: seeds the initial weights (flax's default init
    distributions); weights are usually loaded afterwards.
    ``use_atom_edge_embedding``, ``use_pallas``, ``use_pallas_conv1`` and
    ``use_pallas_rotate`` are accepted for config compatibility and change
    nothing, as in the JAX model (the first) or because the kernels always
    run (the others).  ``training`` sets ``nn.Module.training`` (see the
    module docstring): in train mode a forward with a non-zero
    ``alpha_drop``, ``drop_path_rate`` or ``proj_drop`` draws its masks from
    ``forward``'s ``dropout_generator``; with zero rates it is the eval forward.
    """

    def __init__(
        self,
        num_layers: int = 8,
        sphere_channels: int = 128,
        attn_hidden_channels: int = 64,
        num_heads: int = 8,
        attn_alpha_channels: int = 64,
        attn_value_channels: int = 16,
        ffn_hidden_channels: int = 128,
        lmax: int = 4,
        mmax: int = 2,
        grid_resolution: int = 18,
        grid_mode: str = "gauss",
        edge_channels: int = 128,
        num_distance_basis: int = 600,
        cutoff: float = 12.0,
        max_neighbors: int = 20,
        max_num_elements: int = 90,
        use_atom_edge_embedding: bool = True,
        mode: str = "denoising",
        so3_denoising: bool = True,
        for_denoising: bool = True,
        energy_encoding: Optional[str] = None,
        sampling: bool = False,
        subtract_atomic_radii: bool = True,
        radii_pm_bug_compat: bool = False,
        cell_reps: Tuple[int, int, int] = (2, 2, 1),
        max_ads: int = 16,
        avg_degree: float = _AVG_DEGREE,
        avg_num_nodes: float = _AVG_NUM_NODES,
        alpha_drop: float = 0.0,
        drop_path_rate: float = 0.0,
        proj_drop: float = 0.0,
        training: bool = False,
        use_pallas: Optional[bool] = None,
        use_pallas_rotate: Optional[bool] = None,
        use_pallas_conv1: Optional[bool] = None,
        compute_dtype: Optional[str] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.cdt = cdt = resolve_compute_dtype(compute_dtype)
        if grid_mode not in ("gauss", "e3nn"):
            raise ValueError(f"unknown EquiformerV2 grid_mode {grid_mode!r}")
        self.grid_mode = grid_mode
        if mode not in ("denoising", "s2ef"):
            raise ValueError(f"unknown EquiformerV2 mode {mode!r}")
        if energy_encoding not in (None, "scalar"):
            raise ValueError(f"unknown energy_encoding {energy_encoding!r}")
        self.num_layers = num_layers
        self.sphere_channels = sphere_channels
        self.ffn_hidden_channels, self.edge_channels = ffn_hidden_channels, edge_channels
        self.lmax, self.mmax = lmax, mmax
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.max_num_elements = max_num_elements
        self.num_distance_basis = num_distance_basis
        self.mode = mode
        self.so3_denoising = so3_denoising
        self.for_denoising = for_denoising
        self.energy_encoding = energy_encoding
        self.sampling = sampling
        self.subtract_atomic_radii = subtract_atomic_radii
        self.radii_pm_bug_compat = radii_pm_bug_compat
        self.cell_reps = tuple(int(r) for r in cell_reps)
        self.max_ads = max_ads
        self.avg_degree = avg_degree
        self.avg_num_nodes = avg_num_nodes
        self.drop_path_rate, self.proj_drop = drop_path_rate, proj_drop
        self.has_drops = max(alpha_drop, drop_path_rate, proj_drop) > 0.0

        c = sphere_channels
        rad = (num_distance_basis + 2 * edge_channels, edge_channels, edge_channels)
        n0 = m_primary_order(lmax, mmax)[1][0][1]

        def attention(c_out, alpha_drop=0.0):  # the force heads drop nothing, as in JAX
            return SO2Attention(lmax, mmax, c, attn_hidden_channels, num_heads, attn_alpha_channels,
                                attn_value_channels, c_out, max_num_elements, rad, grid_resolution, cutoff,
                                num_distance_basis, alpha_drop, cdt, grid_mode)

        self.sphere_embedding = nn.Embedding(max_num_elements, c)
        if energy_encoding == "scalar":
            self.energy_embedding = nn.Linear(1, c)
        self.edge_degree_source_embedding = nn.Embedding(max_num_elements, edge_channels)
        self.edge_degree_target_embedding = nn.Embedding(max_num_elements, edge_channels)
        self.edge_degree_rad_func = RadialFunction(rad + (n0 * c,))
        self.blocks = nn.ModuleList(
            TransBlock(lmax, c, attention(c, alpha_drop), ffn_hidden_channels, grid_resolution, cdt, grid_mode)
            for _ in range(num_layers))
        self.norm_final = EquivariantLayerNormSH(lmax, c)
        self.force_block = attention(1)
        if mode == "s2ef":
            self.energy_block = GridMLPFFN(lmax, c, ffn_hidden_channels, 1, grid_resolution, cdt, grid_mode)
        elif so3_denoising and for_denoising:
            self.force_block2 = attention(1)
        scale = 1.0 if radii_pm_bug_compat else 0.01
        self.register_buffer("atomic_radii", torch.from_numpy((ATOMIC_RADII_PM * scale).astype(np.float32)),
                             persistent=False)
        self.register_buffer("rescale", torch.from_numpy(m_trunc_rescale(lmax, mmax)), persistent=False)
        self.reset_parameters(generator)
        self.to(device)
        self.train(training)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's default inits: lecun-normal Dense kernels and zero biases,
        LayerNorm (1, 0), the sphere embedding N(0, 1/C), the atom-pair
        embeddings U(-0.001, 0.001), SO3Linear weights U(-1, 1)/sqrt(C_in),
        ``alpha_dot`` U(-1, 1)/sqrt(alpha channels), affine weights 1."""

        def uniform(shape, scale):
            return (2 * torch.rand(shape, generator=generator) - 1) * scale

        with torch.no_grad():
            for name, module in self.named_modules():
                if isinstance(module, nn.Linear):
                    lecun_normal_(module.weight, generator)
                    if module.bias is not None:
                        module.bias.zero_()
                elif isinstance(module, nn.LayerNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                elif isinstance(module, nn.Embedding):
                    if name == "sphere_embedding":
                        module.weight.copy_(torch.randn(module.weight.shape, generator=generator)
                                            / math.sqrt(module.weight.shape[1]))
                    else:
                        module.weight.copy_(uniform(module.weight.shape, 0.001))
                elif isinstance(module, SO3Linear):
                    module.weight.copy_(uniform(module.weight.shape, 1 / math.sqrt(module.c_in)))
                    module.bias.zero_()
                elif isinstance(module, EquivariantLayerNormSH):
                    module.affine_weight.fill_(1.0)
                elif isinstance(module, SO2Attention):
                    module.alpha_dot.copy_(uniform(module.alpha_dot.shape, 1 / math.sqrt(module.attn_alpha)))

    def prepare_static(self, batch: AtomsBatch) -> StaticGraphPart:
        """Hoist the slab-slab neighbour candidates out of a sampling loop."""
        return prepare_static_graph(batch, cutoff=self.cutoff, max_neighbors=self.max_neighbors,
                                    cell_reps=self.cell_reps)

    def prepare_candidates(self, batch: AtomsBatch, k_cand: int = 64) -> CandidateTable:
        """Verlet candidate table for relaxation loops."""
        return prepare_candidate_graph(batch, max_neighbors=self.max_neighbors, cell_reps=self.cell_reps,
                                       k_cand=k_cand)

    def _branch_drop(self, y: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Residual-branch regularisation of a train-mode forward: per-graph
        drop path, then per-(graph, node, channel) projection drop."""
        if not self.training:
            return y
        b, n, _, c = y.shape
        y = _drop(y, self.drop_path_rate, (b, 1, 1, 1), generator)
        return _drop(y, self.proj_drop, (b, n, 1, c), generator)

    def forward(self, batch: AtomsBatch, static_graph=None, dropout_generator: Optional[torch.Generator] = None):
        dim = (self.lmax + 1) ** 2
        nl, dist, unit = generate_graph(
            batch, cutoff=self.cutoff, max_neighbors=self.max_neighbors, cell_reps=self.cell_reps,
            static_graph=static_graph, max_ads=self.max_ads,
        )
        z = torch.clamp(batch.atomic_numbers.long(), 0, self.max_num_elements - 1)
        z_src = gather_nodes(z, nl.src)
        if self.mode == "denoising" and self.subtract_atomic_radii:
            radii = self.atomic_radii[z]
            dist = dist - (radii[:, :, None] + gather_nodes(radii, nl.src))
            if not self.radii_pm_bug_compat:
                dist = torch.clamp(dist, min=1e-3)
        gamma, beta = edge_euler_angles(unit)
        mask = nl.mask

        # initial node irreps: the atom embedding (+ energy conditioning) on l=0
        x0 = self.sphere_embedding(z)
        if self.energy_encoding == "scalar":
            e_cond = torch.zeros_like(batch.energy) if self.sampling else batch.energy
            x0 = x0 + self.energy_embedding(e_cond[:, None].float())[:, None, :]
        x = torch.cat([x0[:, :, None, :], x0.new_zeros(x0.shape[:2] + (dim - 1, x0.shape[-1]))], dim=-2)

        # edge-degree embedding: atom-pair embeddings + radial trunk -> m=0
        # coefficients (the leading n0 rows of the truncated layout) -> rotate out
        edge_gauss = gaussian_smearing(dist, self.cutoff, self.num_distance_basis)
        edge_gauss = torch.where(mask[..., None], edge_gauss, torch.zeros_like(edge_gauss))
        emb_s = self.edge_degree_source_embedding(z_src)
        emb_t = self.edge_degree_target_embedding(z)[:, :, None, :].expand_as(emb_s)
        deg = self.edge_degree_rad_func(torch.cat([edge_gauss, emb_s, emb_t], dim=-1))
        deg = deg.unflatten(-1, (-1, self.sphere_channels))
        deg_full = eqv2_edge_rotate(deg, gamma, beta, self.lmax, self.mmax, direction="from", n_sel=deg.shape[-2])
        deg_full = deg_full * self.rescale[:, None]
        deg_full = torch.where(mask[..., None, None], deg_full, torch.zeros_like(deg_full))
        x = x + deg_full.sum(dim=2) / self.avg_degree

        atoms = batch.atom_mask[..., None, None]
        for blk in self.blocks:
            y = blk.attn(blk.norm_attn(x), z, z_src, nl, gamma, beta, dist, dropout_generator)
            x = x + self._branch_drop(y, dropout_generator)
            x = x + self._branch_drop(blk.ffn(blk.norm_ffn(x)), dropout_generator)
            x = torch.where(atoms, x, torch.zeros_like(x))
        x = self.norm_final(x)

        def force_head(head: SO2Attention) -> torch.Tensor:
            f = head(x, z, z_src, nl, gamma, beta, dist)
            vec = l1_coeffs_to_vector(f[..., 1:4, 0])
            return torch.where(batch.atom_mask[..., None], vec, torch.zeros_like(vec))

        if self.mode == "s2ef":
            e_atom = self.energy_block(x)[..., 0, 0]
            energy = div(torch.where(batch.atom_mask, e_atom, torch.zeros_like(e_atom)).sum(dim=1),
                         self.avg_num_nodes)
            return {"energy": energy.float(), "forces": force_head(self.force_block)}
        forces = force_head(self.force_block)
        if self.so3_denoising and self.for_denoising:
            return forces, force_head(self.force_block2)
        return forces


_BLOCK_MODULES = ("norm_attn", "attn", "norm_ffn", "ffn")


def eqv2_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX EquiformerV2 variables ``{"params": ...}`` (nested dicts of
    arrays) -> this port's state dict.

    Plain transposes and renames: the top-level ``{norm_attn,attn,norm_ffn,
    ffn}_{i}`` become ``blocks.{i}.{...}``; a Dense or group-linear
    ``kernel [in, out]`` becomes ``weight [out, in]``; LayerNorm ``scale`` and
    Embed ``embedding`` become ``weight``; everything else (SO3Linear
    ``weight [lmax+1, C_out, C_in]``, ``affine_weight``, ``alpha_dot``,
    biases) keeps its name and layout.
    """
    sd: Dict[str, torch.Tensor] = {}

    def top_name(key: str) -> str:
        head, _, idx = key.rpartition("_")
        if head in _BLOCK_MODULES and idx.isdigit():
            return f"blocks.{idx}.{head}"
        return key

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{top_name(key) if not prefix else key}.")
                continue
            arr = np.array(value, dtype=np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key in ("scale", "embedding"):
                key = "weight"
            sd[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables["params"], "")
    return sd
