"""GemNet-OC: the quadruplet/triplet/pair GNN force field, in PyTorch.

Port of :mod:`adsorbdiff_tpu.models.gemnet_oc` in ``mode="s2ef"`` (energy and
direct forces), the relaxation model of ``configs/relaxation/gemnet_oc/
gemnet_relax.yml``, and in ``mode="denoising"`` (the direct-force head as a
translation score, with ``so3_denoising`` a second head as the rotation
score), the score model of ``configs/denoising/gemnet_so3.yml``.  It keeps
the dense padded layout: every graph is a ``[B, N, K]`` neighbour table,
triplets and quadruplets are masked dense tensors, and every aggregation is
an einsum over fixed axes.

Module, parameter and buffer names are the AdsorbDiff reference's (the names
``tests/torch_ref_gemnet.py`` uses and ``train/torch_import.py`` maps), so a
reference state dict loads with ``load_state_dict(strict=True)`` as it is.
Layouts are the reference's too: ``Linear.weight`` is ``[out, in]``; a
``BasisEmbedding`` without spherical axis stores ``[F, R]``, one with it
stores ``[R, S, F]``, and its forward reads the coefficient of
``rad[r] * sph[s]`` into channel ``f`` at ``weight.reshape(R, -1)[r, f*S + s]``
(the reference's ``rad_W1`` reinterpretation).
:func:`gemnet_state_dict_from_jax` turns a JAX variable tree into such a
state dict.

The quadruplet interaction always runs :func:`adsorbdiff_tpu_torch.ops.
kernels.gemnet_quad_chain`, the JAX model's ``fused_quad=True`` path, and the
e2e, a2e and e2a triplet bases always come from one call of
:func:`adsorbdiff_tpu_torch.ops.kernels.gemnet_cbf_bases` (the masked
Legendre kernel, one launch for the bases of the interactions switched on;
the JAX model's ``use_pallas=True`` path for the first two, and the same
function for the third, which JAX leaves to XLA).  There is no switch:
``fused_quad``, ``fused_trip`` and ``use_pallas`` are accepted for config
compatibility and ignored (``fused_trip``, the triplet consumers through
the quad-chain kernel, computes the same function).  Training runs the
same two kernels: the chain's gradient reaches ``xm`` and ``qp`` through
its VJP (a recompute of the plain version, :class:`adsorbdiff_tpu_torch.
ops.kernels.GemnetQuadChain`), and the triplet bases take only geometry,
which carries no gradient (the force heads are direct).  The quadruplet's
c == d exclusion compares integer image keys (:func:`_img_key`), which the
port packs in base 64: exact wherever the JAX package's base-16 key is
exact, and still injective where that one collides (offsets past 7).

``compute_dtype="bfloat16"`` is the JAX model's bf16 feature path: every
Dense layer and basis embedding computes in bf16 (f32 parameters, cast where
used), the triplet bases come out of the Legendre kernel in bf16, the
quadruplet chain writes a bf16 ``outer`` (its ``xm`` and ``qp`` stay f32: the
f32 scale factors widen them, as in JAX), and the heads' final products, the
pair bilinear and the outputs are f32 (JAX's promotion of a bf16 input
against an f32 parameter).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.models.base import (derive_subgraph, generate_graph, prepare_candidate_graph,
                                              prepare_static_graph)
from adsorbdiff_tpu_torch.models.layers import (AtomEmbedding, Linear, RadialBasis, ScaleFactor, lecun_normal_, mul,
                                                resolve_compute_dtype, scaled_silu)
from adsorbdiff_tpu_torch.ops import pbc
from adsorbdiff_tpu_torch.ops.kernels import gemnet_cbf_bases, gemnet_quad_chain, legendre_y_l0

INV_SQRT_2 = 1 / math.sqrt(2.0)
KEY_BASE, KEY_BIAS = 64, 32  # _img_key digits: offsets in [-32, 31]


# --------------------------------------------------------------------------
# small layers (reference layers/base_layers.py, efficient.py)
# --------------------------------------------------------------------------
class DenseLayer(nn.Module):
    """Bias-free linear layer (``.linear``, computing in its ``cdt`` where
    the model sets one), then scaled SiLU unless ``activation=False``."""

    def __init__(self, d_in: int, d_out: int, activation: bool = True) -> None:
        super().__init__()
        self.linear = Linear(d_in, d_out, bias=False)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        return scaled_silu(x) if self.activation else x


class ResidualLayer(nn.Module):
    """``(x + Dense(Dense(x))) / sqrt(2)``."""

    def __init__(self, units: int) -> None:
        super().__init__()
        self.dense_mlp = nn.Sequential(DenseLayer(units, units), DenseLayer(units, units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mul(x + self.dense_mlp(x), INV_SQRT_2)


class MLPStack(nn.Sequential):
    """A Dense layer into ``units`` (when ``dense_in``), then ``n_hidden``
    residual layers: the reference's ``get_mlp``, indexed ``.0``, ``.1``..."""

    def __init__(self, d_in: int, units: int, n_hidden: int, dense_in: bool = True) -> None:
        layers = [DenseLayer(d_in, units)] if dense_in else []
        super().__init__(*layers, *(ResidualLayer(units) for _ in range(n_hidden)))


class BasisEmbedding(nn.Module):
    """Radial (x spherical) basis -> embedding by a learned tensor, in the
    reference's layouts (see the module docstring); with ``cdt`` (set by the
    model) the bases and the weight are cast to it, as JAX casts them."""

    def __init__(self, num_radial: int, emb_size: int, num_spherical: Optional[int] = None) -> None:
        super().__init__()
        self.num_spherical = num_spherical
        shape = (emb_size, num_radial) if num_spherical is None else (num_radial, num_spherical, emb_size)
        self.weight = nn.Parameter(torch.empty(shape))
        self.cdt: Optional[torch.dtype] = None

    def forward(self, rad: torch.Tensor, sph: Optional[torch.Tensor] = None, radw_only: bool = False) -> torch.Tensor:
        """``rad [..., R]`` -> ``[..., F]``.  With a spherical axis:
        ``radw_only`` returns the radial contraction ``[..., F, S]``;
        otherwise ``sph [..., S]`` (broadcast against ``rad``) is contracted
        too."""
        w = self.weight
        if self.cdt is not None:
            rad, w = rad.to(self.cdt), w.to(self.cdt)
            sph = None if sph is None else sph.to(self.cdt)
        if self.num_spherical is None:
            return rad @ w.t()
        r, s, f = w.shape
        radw = (rad @ w.reshape(r, s * f)).unflatten(-1, (f, s))
        if radw_only:
            return radw
        return torch.matmul(radw, sph[..., None])[..., 0]


class EfficientBilinear(nn.Module):
    """``outer [..., F, E]`` flattened F-major -> ``[..., out]`` (the
    reference's EfficientInteractionBilinear after its sums)."""

    def __init__(self, emb_size_in: int, emb_size_basis: int, emb_size_out: int) -> None:
        super().__init__()
        self.bilinear = DenseLayer(emb_size_basis * emb_size_in, emb_size_out, activation=False)

    def forward(self, outer: torch.Tensor) -> torch.Tensor:
        return self.bilinear(outer.flatten(-2))


class EdgeEmbedding(nn.Module):
    """``Dense(cat[h_source, h_target, m])`` over the neighbour table."""

    def __init__(self, atom_features: int, edge_features: int, out_features: int) -> None:
        super().__init__()
        self.dense = DenseLayer(2 * atom_features + edge_features, out_features)

    def forward(self, h: torch.Tensor, m: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        h_src = _gather_rows(h, src)
        return self.dense(torch.cat([h_src, h[:, :, None, :].expand_as(h_src), m], dim=-1))


# --------------------------------------------------------------------------
# geometry helpers (dense)
# --------------------------------------------------------------------------
def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a: [B, N, ...], idx: [B, ...] -> a[b, idx[b, ...]] as [B, ..., ...]."""
    rest = a.shape[2:]
    flat = pbc._gather_rows(a.reshape(a.shape[0], a.shape[1], -1), idx)
    return flat.reshape(idx.shape + rest)


def _cos_clamped(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    num = torch.sum(u * v, dim=-1)
    den = torch.linalg.norm(u, dim=-1) * torch.linalg.norm(v, dim=-1)
    return torch.clamp(num / torch.clamp(den, min=1e-9), -1.0, 1.0)


def _img_key(src: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Fold (periodic source atom, summed cell offset) into one int32 key, so
    the kernel tests edge identity with one compare.  Digits are base 64 with
    a +32 bias: injective for offsets in [-32, 31] per axis and sources below
    8192.  (The JAX package's base-16 digits collide once a summed quad offset
    passes 7, i.e. from ``cell_reps`` 4 on.)"""
    k = src.to(torch.int64)
    for ci in range(3):
        k = k * KEY_BASE + (off[..., ci].to(torch.int64) + KEY_BIAS)
    return k.to(torch.int32)


def _same_edge(src_a, off_a, src_b, off_b) -> torch.Tensor:
    """True where (src, offset) pairs denote the same periodic neighbour."""
    return (src_a == src_b) & torch.all(off_a == off_b, dim=-1)


def _reverse_edge_table(nl: pbc.NeighborList) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each edge's reverse in the dense table: the reverse of (i, k), edge
    ``src[i,k] -> i`` at offset ``-off[i,k]``, is the slot of row ``src[i,k]``
    whose (source, offset) is (i, -off).  Returns ``(rev_flat [B,N,K] flat
    index src*K + rev_k, rev_valid [B,N,K])``; the first match wins, as
    ``jnp.argmax`` picks it."""
    b, n, k = nl.src.shape
    src_rows = _gather_rows(nl.src, nl.src)  # [B,N,K,K']
    off_rows = _gather_rows(nl.cell_offsets, nl.src)  # [B,N,K,K',3]
    mask_rows = _gather_rows(nl.mask, nl.src)
    i_idx = torch.arange(n, device=nl.src.device, dtype=nl.src.dtype)[None, :, None, None]
    match = (
        (src_rows == i_idx)
        & torch.all(off_rows == -nl.cell_offsets[:, :, :, None, :], dim=-1)
        & mask_rows
        & nl.mask[..., None]
    )
    rev_k = torch.argmax(match.to(torch.int32), dim=-1)
    return nl.src.long() * k + rev_k, match.any(dim=-1)


# --------------------------------------------------------------------------
# interaction blocks (reference layers/interaction_block.py,
# atom_update_block.py); the model's forward drives their layers
# --------------------------------------------------------------------------
class TripletInteraction(nn.Module):
    def __init__(self, d_in, d_out, emb_trip_in, emb_trip_out, emb_rbf, emb_cbf, symmetric: bool) -> None:
        super().__init__()
        self.dense_ba = DenseLayer(d_in, d_in)
        self.mlp_rbf = DenseLayer(emb_rbf, d_in, activation=False)
        self.scale_rbf = ScaleFactor()
        self.mlp_cbf = EfficientBilinear(emb_trip_in, emb_cbf, emb_trip_out)
        self.scale_cbf_sum = ScaleFactor()
        self.down_projection = DenseLayer(d_in, emb_trip_in)
        self.up_projection_ca = DenseLayer(emb_trip_out, d_out)
        if symmetric:
            self.up_projection_ac = DenseLayer(emb_trip_out, d_out)


class QuadrupletInteraction(nn.Module):
    def __init__(self, emb_edge, emb_quad_in, emb_quad_out, emb_rbf, emb_cbf, emb_sbf, symmetric: bool) -> None:
        super().__init__()
        self.dense_db = DenseLayer(emb_edge, emb_edge)
        self.mlp_rbf = DenseLayer(emb_rbf, emb_edge, activation=False)
        self.scale_rbf = ScaleFactor()
        self.mlp_cbf = DenseLayer(emb_cbf, emb_quad_in, activation=False)
        self.scale_cbf = ScaleFactor()
        self.mlp_sbf = EfficientBilinear(emb_quad_in, emb_sbf, emb_quad_out)
        self.scale_sbf_sum = ScaleFactor()
        self.down_projection = DenseLayer(emb_edge, emb_quad_in)
        self.up_projection_ca = DenseLayer(emb_quad_out, emb_edge)
        if symmetric:
            self.up_projection_ac = DenseLayer(emb_quad_out, emb_edge)


class PairInteraction(nn.Module):
    def __init__(self, emb_atom, emb_aint_in, emb_aint_out, emb_rbf) -> None:
        super().__init__()
        self.bilinear = DenseLayer(emb_rbf * emb_aint_in, emb_aint_out, activation=False)
        self.scale_rbf_sum = ScaleFactor()
        self.down_projection = DenseLayer(emb_atom, emb_aint_in)
        self.up_projection = DenseLayer(emb_aint_out, emb_atom)


class AtomUpdateBlock(nn.Module):
    def __init__(self, emb_atom, emb_edge, emb_rbf, n_hidden) -> None:
        super().__init__()
        self.dense_rbf = DenseLayer(emb_rbf, emb_edge, activation=False)
        self.scale_sum = ScaleFactor()
        self.layers = MLPStack(emb_edge, emb_atom, n_hidden)


class OutputBlock(nn.Module):
    def __init__(self, emb_atom, emb_edge, emb_rbf, n_hidden, n_afteratom) -> None:
        super().__init__()
        self.dense_rbf = DenseLayer(emb_rbf, emb_edge, activation=False)
        self.scale_sum = ScaleFactor()
        self.layers = MLPStack(emb_edge, emb_atom, n_hidden)
        self.seq_energy2 = MLPStack(emb_atom, emb_atom, n_afteratom, dense_in=False)
        self.seq_forces = MLPStack(emb_edge, emb_edge, n_hidden, dense_in=False)
        self.dense_rbf_F = DenseLayer(emb_rbf, emb_edge, activation=False)
        self.scale_rbf_F = ScaleFactor()

    def forward(self, h, m, basis_output, emask):
        """OutputBlock: per-atom energy features and per-edge force features."""
        be = self.dense_rbf(basis_output)
        xe = self.scale_sum(torch.sum(torch.where(emask[..., None], m * be, 0.0), dim=2))
        xe = mul(self.layers(xe) + h, INV_SQRT_2)
        xe = self.seq_energy2(xe)
        xf = self.scale_rbf_F(self.seq_forces(m) * self.dense_rbf_F(basis_output))
        return xe, xf


class InteractionBlock(nn.Module):
    def __init__(self, *, emb_size_atom, emb_size_edge, emb_size_trip_in, emb_size_trip_out, emb_size_quad_in,
                 emb_size_quad_out, emb_size_aint_in, emb_size_aint_out, emb_size_rbf, emb_size_cbf,
                 emb_size_sbf, num_before_skip, num_after_skip, num_concat, num_atom, num_atom_emb_layers,
                 quad_interaction, atom_edge_interaction, edge_atom_interaction, atom_interaction,
                 symmetric_mp) -> None:
        super().__init__()
        a, e = emb_size_atom, emb_size_edge
        trip = (emb_size_trip_in, emb_size_trip_out, emb_size_rbf, emb_size_cbf)
        self.dense_ca = DenseLayer(e, e)
        self.trip_interaction = TripletInteraction(e, e, *trip, symmetric=symmetric_mp)
        if quad_interaction:
            self.quad_interaction = QuadrupletInteraction(
                e, emb_size_quad_in, emb_size_quad_out, emb_size_rbf, emb_size_cbf, emb_size_sbf,
                symmetric=symmetric_mp,
            )
        if atom_edge_interaction:
            self.atom_edge_interaction = TripletInteraction(a, e, *trip, symmetric=symmetric_mp)
        if edge_atom_interaction:
            self.edge_atom_interaction = TripletInteraction(e, a, *trip, symmetric=False)
        if atom_interaction:
            self.atom_interaction = PairInteraction(a, emb_size_aint_in, emb_size_aint_out, emb_size_rbf)
        self.layers_before_skip = nn.ModuleList(ResidualLayer(e) for _ in range(num_before_skip))
        self.layers_after_skip = nn.ModuleList(ResidualLayer(e) for _ in range(num_after_skip))
        self.atom_emb_layers = nn.ModuleList(ResidualLayer(a) for _ in range(num_atom_emb_layers))
        self.atom_update = AtomUpdateBlock(a, e, emb_size_rbf, num_atom)
        self.concat_layer = EdgeEmbedding(a, e, e)
        self.residual_m = nn.ModuleList(ResidualLayer(e) for _ in range(num_concat))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@registry.register_model("gemnet_oc")
class GemNetOC(nn.Module):
    """GemNet-OC.  ``mode="s2ef"`` returns ``{"energy": [B], "forces": [B, N,
    3]}``; ``mode="denoising"`` returns the forces head ``[B, N, 3]`` as the
    translation score, and with ``so3_denoising`` (the default) also a second
    head's ``[B, N, 3]`` (``out_mlp_F_so3``, ``out_forces_so3``) as the
    rotation score.  The energy head's weights exist in both modes, as in
    JAX; in denoising mode its output is not computed.

    Hyperparameters and defaults are the JAX model's (``gemnet_relax.yml``
    widths).  ``energy_encoding="scalar"`` adds a ``Dense(1 -> A)`` of the
    system's energy (``energy_embedding``) to every atom embedding, zeroed
    with ``sampling=True``.  ``max_ads`` bounds the adsorbate atoms that an
    incremental graph rebuilds (:meth:`prepare_static`).  ``device``: the
    CUDA card unless ``"cpu"`` is passed (raises without a card).
    ``generator`` seeds the initial weights (orthogonal Dense and basis
    weights, embeddings uniform in [-sqrt(3), sqrt(3)], the energy embedding
    lecun-normal as flax's Dense, scale factors 1); weights are usually
    loaded afterwards.

    ``rbf``: ``{"name": "gaussian"}`` (the default), ``spherical_bessel`` or
    ``bernstein``, one trainable basis for each of the four graphs
    (:class:`~adsorbdiff_tpu_torch.models.layers.RadialBasis`).
    ``compute_dtype``: ``None`` or ``"bfloat16"`` (the module docstring).
    ``fused_quad``, ``fused_trip`` and ``use_pallas`` are accepted and
    ignored: the quadruplet interaction and the triplet bases always run
    their kernels.
    """

    def __init__(
        self,
        num_spherical: int = 7,
        num_radial: int = 128,
        num_blocks: int = 4,
        emb_size_atom: int = 256,
        emb_size_edge: int = 512,
        emb_size_trip_in: int = 64,
        emb_size_trip_out: int = 64,
        emb_size_quad_in: int = 32,
        emb_size_quad_out: int = 32,
        emb_size_aint_in: int = 64,
        emb_size_aint_out: int = 64,
        emb_size_rbf: int = 16,
        emb_size_cbf: int = 16,
        emb_size_sbf: int = 32,
        num_before_skip: int = 2,
        num_after_skip: int = 2,
        num_concat: int = 1,
        num_atom: int = 3,
        num_output_afteratom: int = 3,
        num_atom_emb_layers: int = 2,
        num_global_out_layers: int = 2,
        cutoff: float = 12.0,
        cutoff_qint: float = 12.0,
        cutoff_aeaint: float = 12.0,
        cutoff_aint: float = 12.0,
        max_neighbors: int = 30,
        max_neighbors_qint: int = 8,
        max_neighbors_aeaint: int = 20,
        rbf: Optional[dict] = None,
        envelope: Optional[dict] = None,
        extensive: bool = True,
        quad_interaction: bool = True,
        atom_edge_interaction: bool = True,
        edge_atom_interaction: bool = True,
        atom_interaction: bool = True,
        qint_tags: Tuple[int, ...] = (1, 2),
        symmetric_mp: bool = True,
        num_elements: int = 83,
        cell_reps: Tuple[int, int, int] = (2, 2, 1),
        max_ads: int = 16,
        mode: str = "s2ef",
        so3_denoising: bool = True,
        energy_encoding: Optional[str] = None,
        sampling: bool = False,
        use_pallas: bool = False,
        fused_quad: bool = False,
        fused_trip: bool = False,
        derive_subgraphs: bool = True,
        compute_dtype: Optional[str] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.cdt = resolve_compute_dtype(compute_dtype)
        if mode not in ("s2ef", "denoising"):
            raise ValueError(f"GemNetOC mode must be 's2ef' or 'denoising', got {mode!r}")
        if energy_encoding not in (None, "scalar"):
            raise ValueError(f"GemNetOC energy_encoding must be None or 'scalar', got {energy_encoding!r}")
        if 2 * max(cell_reps) >= KEY_BIAS:
            raise ValueError(f"cell_reps {cell_reps} too large for the image keys (summed offsets must be < 32)")
        self.num_spherical = num_spherical
        self.num_blocks = num_blocks
        self.emb_size_rbf = emb_size_rbf
        self.emb_size_quad_in, self.emb_size_sbf = emb_size_quad_in, emb_size_sbf  # the quad-chain kernel's E, F
        self.cutoff, self.cutoff_qint, self.cutoff_aeaint, self.cutoff_aint = cutoff, cutoff_qint, cutoff_aeaint, cutoff_aint
        self.max_neighbors = max_neighbors
        self.max_neighbors_qint = max_neighbors_qint
        self.max_neighbors_aeaint = max_neighbors_aeaint
        self.extensive = extensive
        self.quad_interaction = quad_interaction
        self.atom_edge_interaction = atom_edge_interaction
        self.edge_atom_interaction = edge_atom_interaction
        self.atom_interaction = atom_interaction
        self.qint_tags = tuple(int(t) for t in qint_tags)
        self.symmetric_mp = symmetric_mp
        self.cell_reps = tuple(int(r) for r in cell_reps)
        self.max_ads = max_ads
        self.mode = mode
        self.so3_denoising = mode == "denoising" and so3_denoising
        self.sampling = sampling
        self.derive_ae = derive_subgraphs and cutoff_aeaint <= cutoff and max_neighbors_aeaint <= max_neighbors
        self.derive_q = derive_subgraphs and cutoff_qint <= cutoff and max_neighbors_qint <= max_neighbors

        def radial(c):
            return RadialBasis(num_radial, c, rbf=rbf, envelope=envelope)

        r, s = num_radial, num_spherical
        # one basis a graph, each with its own parameters where the basis has any (as the JAX model's four)
        self.radial_basis = radial(cutoff)
        if quad_interaction:
            self.radial_basis_qint = radial(cutoff_qint)
        self.radial_basis_aeaint = radial(cutoff_aeaint)
        if atom_interaction:
            self.radial_basis_aint = radial(cutoff_aint)

        self.atom_emb = AtomEmbedding(emb_size_atom, num_elements)
        if energy_encoding == "scalar":
            self.energy_embedding = nn.Linear(1, emb_size_atom)
        self.edge_emb = EdgeEmbedding(emb_size_atom, r, emb_size_edge)
        self.mlp_rbf_h = DenseLayer(r, emb_size_rbf, activation=False)
        self.mlp_rbf_out = DenseLayer(r, emb_size_rbf, activation=False)
        self.mlp_rbf_tint = DenseLayer(r, emb_size_rbf, activation=False)
        self.mlp_cbf_tint = BasisEmbedding(r, emb_size_cbf, s)
        if quad_interaction:
            self.mlp_rbf_qint = DenseLayer(r, emb_size_rbf, activation=False)
            self.mlp_cbf_qint = BasisEmbedding(r, emb_size_cbf, s)
            self.mlp_sbf_qint = BasisEmbedding(r, emb_size_sbf, s * s)
        if atom_edge_interaction:
            self.mlp_rbf_aeint = DenseLayer(r, emb_size_rbf, activation=False)
            self.mlp_cbf_aeint = BasisEmbedding(r, emb_size_cbf, s)
        if edge_atom_interaction:
            self.mlp_rbf_eaint = DenseLayer(r, emb_size_rbf, activation=False)
            self.mlp_cbf_eaint = BasisEmbedding(r, emb_size_cbf, s)
        if atom_interaction:
            self.mlp_rbf_aint = BasisEmbedding(r, emb_size_rbf)

        self.int_blocks = nn.ModuleList(
            InteractionBlock(
                emb_size_atom=emb_size_atom, emb_size_edge=emb_size_edge, emb_size_trip_in=emb_size_trip_in,
                emb_size_trip_out=emb_size_trip_out, emb_size_quad_in=emb_size_quad_in,
                emb_size_quad_out=emb_size_quad_out, emb_size_aint_in=emb_size_aint_in,
                emb_size_aint_out=emb_size_aint_out, emb_size_rbf=emb_size_rbf, emb_size_cbf=emb_size_cbf,
                emb_size_sbf=emb_size_sbf, num_before_skip=num_before_skip, num_after_skip=num_after_skip,
                num_concat=num_concat, num_atom=num_atom, num_atom_emb_layers=num_atom_emb_layers,
                quad_interaction=quad_interaction, atom_edge_interaction=atom_edge_interaction,
                edge_atom_interaction=edge_atom_interaction, atom_interaction=atom_interaction,
                symmetric_mp=symmetric_mp,
            )
            for _ in range(num_blocks)
        )
        self.out_blocks = nn.ModuleList(
            OutputBlock(emb_size_atom, emb_size_edge, emb_size_rbf, num_atom, num_output_afteratom)
            for _ in range(num_blocks + 1)
        )
        self.out_mlp_E = MLPStack(emb_size_atom * (num_blocks + 1), emb_size_atom, num_global_out_layers)
        self.out_energy = DenseLayer(emb_size_atom, 1, activation=False)
        self.out_mlp_F = MLPStack(emb_size_edge * (num_blocks + 1), emb_size_edge, num_global_out_layers)
        self.out_forces = DenseLayer(emb_size_edge, 1, activation=False)
        if self.so3_denoising:
            self.out_mlp_F_so3 = MLPStack(emb_size_edge * (num_blocks + 1), emb_size_edge, num_global_out_layers)
            self.out_forces_so3 = DenseLayer(emb_size_edge, 1, activation=False)
        # the compute dtype of every Dense layer and basis embedding, but the
        # layers JAX builds as plain f32 products (the pair bilinear's
        # ``h_a2a_f @ w_aa``, the heads' ``nn.Dense(1)``): those promote
        for module in self.modules():
            if isinstance(module, (Linear, BasisEmbedding)):
                module.cdt = self.cdt
        f32_layers = [self.out_energy, self.out_forces] + ([self.out_forces_so3] if self.so3_denoising else [])
        f32_layers += [blk.atom_interaction.bilinear for blk in self.int_blocks if atom_interaction]
        for layer in f32_layers:
            layer.linear.cdt = None
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init: orthogonal Dense and basis weights,
        embeddings uniform in [-sqrt(3), sqrt(3)], the energy embedding
        flax's default Dense init; scale factors 1."""
        with torch.no_grad():
            for module in self.modules():
                if module is getattr(self, "energy_embedding", None):
                    lecun_normal_(module.weight, generator)
                    module.bias.zero_()
                elif isinstance(module, nn.Linear):
                    nn.init.orthogonal_(module.weight, generator=generator)
                elif isinstance(module, BasisEmbedding):
                    w = module.weight
                    nn.init.orthogonal_(w.view(w.shape[0], -1), generator=generator)
                elif isinstance(module, nn.Embedding):
                    u = torch.rand(module.weight.shape, generator=generator, dtype=module.weight.dtype)
                    module.weight.copy_((2 * u - 1) * math.sqrt(3.0))

    def _own_graphs(self) -> Dict[str, Tuple[float, int]]:
        """``{name: (cutoff, max_neighbors)}`` of the graphs built on their
        own; a derived subgraph is a K-prefix view of the main table."""
        out = {"main": (self.cutoff, self.max_neighbors)}
        if not self.derive_ae:
            out["aeaint"] = (self.cutoff_aeaint, self.max_neighbors_aeaint)
        if not self.derive_q:
            out["qint"] = (self.cutoff_qint, self.max_neighbors_qint)
        return out

    def prepare_candidates(self, batch: AtomsBatch, k_cand: int = 64) -> Dict[str, pbc.CandidateTable]:
        """Verlet candidate tables for a relaxation loop, keyed like the
        graphs; derived subgraphs need none of their own."""
        return {name: prepare_candidate_graph(batch, max_neighbors=k, cell_reps=self.cell_reps, k_cand=k_cand)
                for name, (_, k) in self._own_graphs().items()}

    def prepare_static(self, batch: AtomsBatch) -> Dict[str, pbc.StaticGraphPart]:
        """Slab-slab neighbour candidates of every graph built on its own,
        hoisted out of a sampling loop (only adsorbate atoms move)."""
        return {name: prepare_static_graph(batch, cutoff=c, max_neighbors=k, cell_reps=self.cell_reps)
                for name, (c, k) in self._own_graphs().items()}

    def _graph(self, batch, sg, name, cutoff, max_neighbors):
        return generate_graph(batch, cutoff=cutoff, max_neighbors=max_neighbors, cell_reps=self.cell_reps,
                              static_graph=sg.get(name), max_ads=self.max_ads)

    def forward(self, batch: AtomsBatch, static_graph: Optional[Dict[str, Any]] = None):
        if batch.max_atoms >= 8192:
            raise ValueError("GemNetOC's image keys need fewer than 8192 atoms per system")
        sg = static_graph or {}
        s = self.num_spherical
        # ---------------- graphs ---------------------------------------------
        nl, dist, unit = self._graph(batch, sg, "main", self.cutoff, self.max_neighbors)
        emask = nl.mask  # [B, N, K1]
        if self.derive_ae:
            nl_ae, dist_ae, unit_ae = derive_subgraph(nl, max_neighbors=self.max_neighbors_aeaint,
                                                      cutoff=self.cutoff_aeaint)
        else:
            nl_ae, dist_ae, unit_ae = self._graph(batch, sg, "aeaint", self.cutoff_aeaint, self.max_neighbors_aeaint)
        if self.derive_q:
            nl_q, dist_q, unit_q = derive_subgraph(nl, max_neighbors=self.max_neighbors_qint, cutoff=self.cutoff_qint)
        else:
            nl_q, dist_q, unit_q = self._graph(batch, sg, "qint", self.cutoff_qint, self.max_neighbors_qint)
        tagged = torch.zeros_like(batch.tags, dtype=torch.bool)
        for t in self.qint_tags:
            tagged |= batch.tags == t
        # a qint edge is kept if either end carries a qint tag
        qmask = nl_q.mask & (tagged[:, :, None] | _gather_rows(tagged, nl_q.src))
        # `unit` points target -> source; the reference's vectors point
        # source -> target, and the angle formulas below are written so that
        # the two signs cancel

        # ---------------- bases ----------------------------------------------
        rad_main = self.radial_basis(dist)  # [B,N,K1,R]
        basis_atom_update = self.mlp_rbf_h(rad_main)
        basis_output = self.mlp_rbf_out(rad_main)

        # e2e triplets: in-edge b->a and out-edge c->a are slots of row a;
        # only the identical slot is excluded
        k1 = nl.src.shape[2]
        not_self = ~torch.eye(k1, dtype=torch.bool, device=emask.device)[None, None]
        trip_mask_e2e = emask[:, :, :, None] & emask[:, :, None, :] & not_self
        unit = unit.contiguous()
        # the triplet bases' masks (a2e, e2a below) come first, so that one launch computes every basis
        trip_problems = [(unit, unit, trip_mask_e2e.contiguous())]  # e2e: [B,N,S,K1,K1], mask folded
        if self.atom_edge_interaction or self.edge_atom_interaction:
            same_ae = _same_edge(
                nl_ae.src[:, :, None, :], nl_ae.cell_offsets[:, :, None, :, :],
                nl.src[:, :, :, None], nl.cell_offsets[:, :, :, None, :],
            )  # [B,N,K1,Kae]
            unit_ae = unit_ae.contiguous()
        if self.atom_edge_interaction:
            trip_mask_a2e = emask[:, :, :, None] & nl_ae.mask[:, :, None, :] & ~same_ae
            trip_problems.append((unit, unit_ae, trip_mask_a2e.contiguous()))  # a2e: [B,N,S,K1,Kae]
        if self.edge_atom_interaction:
            trip_mask_e2a = nl_ae.mask[:, :, :, None] & emask[:, :, None, :] & ~same_ae.transpose(2, 3)
            trip_problems.append((unit_ae, unit, trip_mask_e2a.contiguous()))  # e2a: [B,N,S,Kae,K1]
        cbf_e2e, *cbf_ae = gemnet_cbf_bases(trip_problems, s, self.cdt or torch.float32)
        radw_tint = self.mlp_cbf_tint(rad_main, radw_only=True)  # [B,N,K1,F,S]
        rad_e2e = self.mlp_rbf_tint(rad_main)

        if self.quad_interaction:
            # out edge c->a (a, k1), qint edge b->a (a, kq; source b), main
            # in-edge d->b of b (b, k2)
            q_in_unit = _gather_rows(unit, nl_q.src)  # [B,N,Kq,K2,3]
            q_in_mask = _gather_rows(emask, nl_q.src)
            cos_abd = _cos_clamped(unit_q[:, :, :, None, :], q_in_unit)  # [B,N,Kq,K2]
            rad_q = self.radial_basis_qint(dist_q)
            cir_q = self.mlp_cbf_qint(rad_q[:, :, :, None, :], legendre_y_l0(cos_abd, s))  # [B,N,Kq,K2,Fc]
            cos_cab_q = _cos_clamped(unit[:, :, :, None, :], unit_q[:, :, None, :, :])  # [B,N,K1,Kq]
            # dihedral normals: n1 = unit x unit_q, n2 = q_in_unit x unit_q
            n1 = torch.linalg.cross(unit[:, :, :, None, :].expand(-1, -1, -1, unit_q.shape[2], -1),
                                    unit_q[:, :, None, :, :].expand(-1, -1, k1, -1, -1), dim=-1)
            n2 = torch.linalg.cross(q_in_unit, unit_q[:, :, :, None, :].expand_as(q_in_unit), dim=-1)
            radw_sbf = self.mlp_sbf_qint(rad_main, radw_only=True).unflatten(-1, (s, s))  # [B,N,K1,F,S(i),S(j)]
            y_cab = legendre_y_l0(cos_cab_q, s)  # [B,N,K1,Kq,S]
            rad_qint_edges = self.mlp_rbf_qint(rad_main)
            # quad validity: b != c, d != a, c != d as periodic atoms
            b_is_c = _same_edge(
                nl_q.src[:, :, None, :], nl_q.cell_offsets[:, :, None, :, :],
                nl.src[:, :, :, None], nl.cell_offsets[:, :, :, None, :],
            )  # [B,N,K1,Kq]
            q_src_rows = _gather_rows(nl.src, nl_q.src)  # [B,N,Kq,K2]
            q_off_rows = _gather_rows(nl.cell_offsets, nl_q.src)  # [B,N,Kq,K2,3]
            a_idx = torch.arange(nl.src.shape[1], device=nl.src.device, dtype=nl.src.dtype)
            d_is_a = _same_edge(q_src_rows, q_off_rows, a_idx[None, :, None, None],
                                -nl_q.cell_offsets[:, :, :, None, :])  # [B,N,Kq,K2]
            quad_m1 = emask[:, :, :, None] & qmask[:, :, None, :] & ~b_is_c  # [B,N,K1,Kq]
            quad_m2 = q_in_mask & ~d_is_a  # [B,N,Kq,K2]
            # c == d: same source atom and off_main[b,k2] + off_q[a,kq] ==
            # off_main[a,k1]; the kernel compares these as image keys
            key1 = _img_key(nl.src, nl.cell_offsets)  # [B,N,K1]
            key2 = _img_key(q_src_rows, q_off_rows + nl_q.cell_offsets[:, :, :, None, :])  # [B,N,Kq,K2]
            ya_m1 = torch.where(quad_m1[..., None], y_cab, 0.0)
            # (cab x radW) factor with m1 folded in, in the kernel's
            # [B,N,U,S(j),Q,F] order; computed once for all blocks (in bf16:
            # both factors in it, as JAX's cdt_cast)
            quad_p = torch.einsum("bnuqi,bnufij->bnujqf", ya_m1.to(radw_sbf.dtype), radw_sbf).contiguous()
            n1, n2 = n1.contiguous(), n2.contiguous()

        if self.atom_edge_interaction or self.edge_atom_interaction:
            rad_ae = self.radial_basis_aeaint(dist_ae)
        if self.atom_edge_interaction:
            cbf_a2e = cbf_ae.pop(0)
            radw_aeint = self.mlp_cbf_aeint(rad_main, radw_only=True)  # [B,N,K1,F,S]
            rad_a2e = self.mlp_rbf_aeint(rad_ae)
        if self.edge_atom_interaction:
            cbf_e2a = cbf_ae.pop(0)
            radw_eaint = self.mlp_cbf_eaint(rad_ae, radw_only=True)  # [B,N,Kae,F,S]
            rad_e2a = self.mlp_rbf_eaint(rad_main)

        if self.atom_interaction:
            # all pairs within cutoff_aint over in-plane periodic images
            # (z-images skipped: the slab vacuum exceeds the cutoff); the
            # embedded basis is linear, so images fold into one sum
            pair_mask = batch.atom_mask[:, :, None] & batch.atom_mask[:, None, :]
            rx, ry = self.cell_reps[0], self.cell_reps[1]
            basis_a2a = 0.0
            for oi in range(-rx, rx + 1):
                for oj in range(-ry, ry + 1):
                    shift = oi * batch.cell[:, 0] + oj * batch.cell[:, 1]  # [B,3]
                    diff = batch.pos[:, None, :, :] + shift[:, None, None, :] - batch.pos[:, :, None, :]
                    d_img = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
                    m_img = pair_mask & (d_img <= self.cutoff_aint) & (d_img > 1e-2)
                    emb = self.mlp_rbf_aint(self.radial_basis_aint(d_img))
                    basis_a2a = basis_a2a + torch.where(m_img[..., None], emb, 0.0)
            basis_a2a = torch.where(pair_mask[..., None], basis_a2a, 0.0)[..., : self.emb_size_rbf]

        # ---------------- embeddings -----------------------------------------
        h = self.atom_emb(batch.atomic_numbers)  # [B,N,A]
        if hasattr(self, "energy_embedding"):
            e = torch.zeros_like(batch.energy) if self.sampling else batch.energy
            h = h + self.energy_embedding(e[:, None].to(h.dtype))[:, None, :]
        m = torch.where(emask[..., None], self.edge_emb(h, rad_main, nl.src), 0.0)  # [B,N,K1,E]
        xs_e, xs_f = [], []
        xe, xf = self.out_blocks[0](h, m, basis_output, emask)
        xs_e.append(xe)
        xs_f.append(xf)

        if self.symmetric_mp:
            rev_flat, rev_valid = _reverse_edge_table(nl)
            bsz, n_atoms = nl.src.shape[:2]

            def swap_gather(x):
                """x at each edge's reverse (zero where the reverse is absent)."""
                flat = x.reshape(bsz, n_atoms * k1, x.shape[-1])
                idx = rev_flat.reshape(bsz, n_atoms * k1, 1).expand(-1, -1, x.shape[-1])
                got = torch.gather(flat, 1, idx).reshape(x.shape)
                return torch.where(rev_valid[..., None], got, 0.0)

        def up(interaction, x):
            out = interaction.up_projection_ca(x)
            if self.symmetric_mp:
                out = mul(out + swap_gather(interaction.up_projection_ac(x)), INV_SQRT_2)
            return out

        n_eint = 2 + int(self.quad_interaction) + int(self.atom_edge_interaction)
        n_aint = 1 + int(self.edge_atom_interaction) + int(self.atom_interaction)
        for blk_idx, blk in enumerate(self.int_blocks):
            x_skip = blk.dense_ca(m)

            # e2e triplets
            ti = blk.trip_interaction
            x_ba = ti.down_projection(ti.scale_rbf(ti.dense_ba(m) * ti.mlp_rbf(rad_e2e)))
            d_t = torch.einsum("bnsuk,bnke->bnuse", cbf_e2e, x_ba)
            outer_t = torch.einsum("bnufs,bnuse->bnufe", radw_tint, d_t)
            x = x_skip + up(ti, ti.scale_cbf_sum(ti.mlp_cbf(outer_t)))

            # quadruplets: the fused chain kernel
            if self.quad_interaction:
                qi = blk.quad_interaction
                x_db = qi.down_projection(qi.scale_rbf(qi.dense_db(m) * qi.mlp_rbf(rad_qint_edges)))
                x_db_t = qi.scale_cbf(_gather_rows(x_db, nl_q.src) * qi.mlp_cbf(cir_q))  # [B,N,Kq,K2,Qi]
                xm = torch.where(quad_m2[..., None], x_db_t, 0.0).contiguous()
                # qp in xm's dtype (JAX's quad_p.astype(xm.dtype)); outer in the compute dtype
                outer = gemnet_quad_chain(n1, n2, key1, key2, xm, quad_p.to(xm.dtype), s,
                                          self.cdt or torch.float32)  # [B,N,K1,Fs,Qi]
                x = x + up(qi, qi.scale_sbf_sum(qi.mlp_sbf(outer)))

            # atom -> edge triplets
            if self.atom_edge_interaction:
                ai = blk.atom_edge_interaction
                x_h = _gather_rows(ai.dense_ba(h), nl_ae.src)  # [B,N,Kae,A]
                x_h = ai.down_projection(ai.scale_rbf(x_h * ai.mlp_rbf(rad_a2e)))
                d_ae = torch.einsum("bnsuk,bnke->bnuse", cbf_a2e, x_h)
                outer_ae = torch.einsum("bnufs,bnuse->bnufe", radw_aeint, d_ae)
                x = x + up(ai, ai.scale_cbf_sum(ai.mlp_cbf(outer_ae)))
            x = mul(x, 1 / math.sqrt(n_eint))

            # edge -> atom triplets, aggregated into the atom
            h_new = h
            if self.edge_atom_interaction:
                ei = blk.edge_atom_interaction
                x_m = ei.down_projection(ei.scale_rbf(ei.dense_ba(m) * ei.mlp_rbf(rad_e2a)))
                d_ea = torch.einsum("bnsak,bnke->bnase", cbf_e2a, x_m)  # [B,N,Kae,S,Ti]
                outer_ea = torch.einsum("bnafs,bnase->bnfe", radw_eaint, d_ea)
                h_new = h_new + ei.up_projection_ca(ei.scale_cbf_sum(ei.mlp_cbf(outer_ea)))

            # atom -> atom pairs
            if self.atom_interaction:
                pi = blk.atom_interaction
                x_a = pi.down_projection(h)
                h_a2a = torch.einsum("bnjf,bje->bnfe", basis_a2a, x_a).flatten(-2)
                h_new = h_new + pi.up_projection(pi.scale_rbf_sum(pi.bilinear(h_a2a)))
            h_mid = mul(h_new, 1 / math.sqrt(n_aint))

            # edge update residuals and skip
            for layer in blk.layers_before_skip:
                x = layer(x)
            m = mul(m + x, INV_SQRT_2)
            for layer in blk.layers_after_skip:
                m = layer(m)
            m = torch.where(emask[..., None], m, 0.0)

            # atom update
            for layer in blk.atom_emb_layers:
                h_mid = layer(h_mid)
            au = blk.atom_update
            h2 = torch.sum(torch.where(emask[..., None], m * au.dense_rbf(basis_atom_update), 0.0), dim=2)
            h = mul(h_mid + au.layers(au.scale_sum(h2)), INV_SQRT_2)

            # concat layer: refresh m with the updated atoms
            m2 = blk.concat_layer(h, m, nl.src)
            for layer in blk.residual_m:
                m2 = layer(m2)
            m = torch.where(emask[..., None], mul(m + m2, INV_SQRT_2), 0.0)

            xe, xf = self.out_blocks[blk_idx + 1](h, m, basis_output, emask)
            xs_e.append(xe)
            xs_f.append(xf)

        # ---------------- global output --------------------------------------
        x_f = torch.cat(xs_f, dim=-1)

        def force_head(mlp, dense):
            f_st = dense(mlp(x_f))[..., 0]  # [B,N,K1]
            f_st = torch.where(emask, f_st, 0.0)
            # F_target += F_st * (source -> target) = F_st * -unit
            forces = torch.sum(f_st[..., None] * -unit, dim=2)
            return torch.where(batch.atom_mask[..., None], forces, 0.0)

        forces = force_head(self.out_mlp_F, self.out_forces)
        if self.mode == "denoising":
            return (forces, force_head(self.out_mlp_F_so3, self.out_forces_so3)) if self.so3_denoising else forces
        e_atom = self.out_energy(self.out_mlp_E(torch.cat(xs_e, dim=-1)))[..., 0]
        e_atom = torch.where(batch.atom_mask, e_atom, 0.0)
        energy = torch.sum(e_atom, dim=1)
        if not self.extensive:
            energy = energy / torch.clamp(torch.sum(batch.atom_mask, dim=1), min=1)
        return {"energy": energy, "forces": forces}


def _count(names, prefix: str) -> int:
    """Number of consecutive ``prefix{i}`` entries in ``names``."""
    i = 0
    while f"{prefix}{i}" in names:
        i += 1
    return i


def gemnet_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GemNet-OC variables ``{"params": ..., "scale_factors": ...}``
    (nested dicts of arrays) -> this port's state dict (the reference's names
    and layouts).

    The inverse of ``adsorbdiff_tpu/train/torch_import.py::
    gemnet_state_dict_to_params``: flax Dense kernels are ``[in, out]``, torch
    ``[out, in]``; the JAX basis weights are ``[R, F]`` and ``[R, S*F]``
    (``w[r, s*F + f]``), the reference's ``[F, R]`` and ``[R, S, F]`` read as
    ``w.reshape(R, -1)[r, f*S + s]``.  The architecture (block and layer
    counts, which interactions) is read from the tree.  ScaleFactors missing
    from ``scale_factors`` are 1.
    """
    params = variables["params"]
    scales = variables.get("scale_factors", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, value) -> None:
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    def lin(dest: str, node: Dict[str, Any]) -> None:
        put(dest + ".linear.weight", np.asarray(node["kernel"]).T)

    def dense(dest: str, name: str) -> None:
        lin(dest, params[name]["Dense_0"])

    def scale(dest: str, name: str) -> None:
        put(dest + ".scale_factor", np.asarray(scales.get(name, {}).get("scale", 1.0)).reshape(()))

    def residual(dest: str, node: Dict[str, Any]) -> None:
        for j in range(2):
            lin(f"{dest}.dense_mlp.{j}", node[f"DenseLayer_{j}"]["Dense_0"])

    def mlp(dest: str, name: str) -> None:
        node = params[name]
        i0 = 0
        if "DenseLayer_0" in node:
            lin(f"{dest}.0", node["DenseLayer_0"]["Dense_0"])
            i0 = 1
        for r in range(_count(node, "ResidualLayer_")):
            residual(f"{dest}.{i0 + r}", node[f"ResidualLayer_{r}"])

    def basis(dest: str, name: str, num_sph: Optional[int] = None) -> None:
        w = np.asarray(params[name]["weight"])
        if num_sph is None:  # [R, F] -> [F, R]
            put(dest, w.T)
            return
        # ours[r, s*F + f] = ref.reshape(R, -1)[r, f*S + s], ref stored [R, S, F]
        r, sf = w.shape
        f = sf // num_sph
        put(dest, w.reshape(r, num_sph, f).transpose(0, 2, 1).reshape(r, num_sph, f))

    def bilinear_basis_size(name: str, down: str) -> int:
        """F of an EfficientBilinear: its weight is [F * E_in, E_out]."""
        e_in = np.asarray(params[down]["Dense_0"]["kernel"]).shape[1]
        return np.asarray(params[name]["weight"]).shape[0] // e_in

    # the spherical size from the e2e triplet factor [R, S * F_cbf]
    num_sph = np.asarray(params["mlp_cbf_tint"]["weight"]).shape[1] // bilinear_basis_size(
        "int_block_0_tint_bilinear", "int_block_0_tint_down")

    put("atom_emb.embeddings.weight", params["atom_emb"]["embeddings"])
    if "energy_embedding" in params:
        put("energy_embedding.weight", np.asarray(params["energy_embedding"]["kernel"]).T)
        put("energy_embedding.bias", params["energy_embedding"]["bias"])
    lin("edge_emb.dense", params["edge_emb"]["Dense_0"])
    for nm in ("mlp_rbf_h", "mlp_rbf_out", "mlp_rbf_tint", "mlp_rbf_qint", "mlp_rbf_aeint", "mlp_rbf_eaint"):
        if nm in params:
            put(nm + ".linear.weight", np.asarray(params[nm]["weight"]).T)
    for nm in ("mlp_cbf_tint", "mlp_cbf_qint", "mlp_cbf_aeint", "mlp_cbf_eaint"):
        if nm in params:
            basis(nm + ".weight", nm, num_sph)
    if "mlp_sbf_qint" in params:
        basis("mlp_sbf_qint.weight", "mlp_sbf_qint", num_sph * num_sph)
    if "mlp_rbf_aint" in params:
        basis("mlp_rbf_aint.weight", "mlp_rbf_aint")
    for nm in ("radial_basis", "radial_basis_qint", "radial_basis_aeaint", "radial_basis_aint"):
        for leaf in ("frequencies", "pregamma"):  # the trainable bases' parameters
            if leaf in params.get(nm, {}):
                put(f"{nm}.rbf.{leaf}", params[nm][leaf])

    interactions = (
        ("trip_interaction", "tint", True),
        ("quad_interaction", "qint", False),
        ("atom_edge_interaction", "aeint", True),
        ("edge_atom_interaction", "eaint", True),
    )
    for b in range(_count({k[: -len("_dense_ca")] for k in params}, "int_block_")):
        rb, ob = f"int_blocks.{b}", f"int_block_{b}"
        dense(f"{rb}.dense_ca", f"{ob}_dense_ca")
        for ref, ours, triplet in interactions:
            if f"{ob}_{ours}_dense" not in params:
                continue
            ri = f"{rb}.{ref}"
            dense(f"{ri}.{'dense_ba' if triplet else 'dense_db'}", f"{ob}_{ours}_dense")
            dense(f"{ri}.mlp_rbf", f"{ob}_{ours}_rbf")
            scale(f"{ri}.scale_rbf", f"{ob}_{ours}_scale_rbf")
            dense(f"{ri}.down_projection", f"{ob}_{ours}_down")
            bil = f"{ri}.{'mlp_cbf' if triplet else 'mlp_sbf'}.bilinear.linear.weight"
            put(bil, np.asarray(params[f"{ob}_{ours}_bilinear"]["weight"]).T)
            if triplet:
                scale(f"{ri}.scale_cbf_sum", f"{ob}_{ours}_scale_sum")
            else:
                dense(f"{ri}.mlp_cbf", f"{ob}_qint_cbf_gate")
                scale(f"{ri}.scale_cbf", f"{ob}_qint_scale_cbf")
                scale(f"{ri}.scale_sbf_sum", f"{ob}_qint_scale_sbf")
            dense(f"{ri}.up_projection_ca", f"{ob}_{ours}_up")
            if f"{ob}_{ours}_up_ac" in params:
                dense(f"{ri}.up_projection_ac", f"{ob}_{ours}_up_ac")
        if f"aint_bilinear_{b}" in params:
            pi = f"{rb}.atom_interaction"
            put(f"{pi}.bilinear.linear.weight", np.asarray(params[f"aint_bilinear_{b}"]).T)
            scale(f"{pi}.scale_rbf_sum", f"{ob}_aint_scale")
            dense(f"{pi}.down_projection", f"{ob}_aint_down")
            dense(f"{pi}.up_projection", f"{ob}_aint_up")
        for ref, ours in (("layers_before_skip", "before_skip"), ("layers_after_skip", "after_skip"),
                          ("atom_emb_layers", "atom_emb"), ("residual_m", "concat_res")):
            for r in range(_count(params, f"{ob}_{ours}_")):
                residual(f"{rb}.{ref}.{r}", params[f"{ob}_{ours}_{r}"])
        dense(f"{rb}.atom_update.dense_rbf", f"{ob}_au_rbf")
        scale(f"{rb}.atom_update.scale_sum", f"{ob}_au_scale")
        mlp(f"{rb}.atom_update.layers", f"{ob}_au_mlp")
        dense(f"{rb}.concat_layer.dense", f"{ob}_concat")

    for i in range(_count({k[: -len("_rbf_E")] for k in params}, "out_block_")):
        rb, ob = f"out_blocks.{i}", f"out_block_{i}"
        dense(f"{rb}.dense_rbf", f"{ob}_rbf_E")
        scale(f"{rb}.scale_sum", f"{ob}_scale_sum")
        mlp(f"{rb}.layers", f"{ob}_seq_E")
        mlp(f"{rb}.seq_energy2", f"{ob}_seq_E2")
        mlp(f"{rb}.seq_forces", f"{ob}_seq_F")
        dense(f"{rb}.dense_rbf_F", f"{ob}_rbf_F")
        scale(f"{rb}.scale_rbf_F", f"{ob}_scale_rbf_F")

    mlp("out_mlp_E", "out_mlp_E_in")
    for r in range(_count(params, "out_mlp_E_")):
        residual(f"out_mlp_E.{1 + r}", params[f"out_mlp_E_{r}"])
    put("out_energy.linear.weight", np.asarray(params["out_energy"]["kernel"]).T)
    for tag in ("", "_so3"):  # the forces head; in denoising mode with so3_denoising, the rotation head
        if f"out_mlp_F_in{tag}" not in params:
            continue
        mlp(f"out_mlp_F{tag}", f"out_mlp_F_in{tag}")
        for r in range(_count(params, f"out_mlp_F{tag}_")):
            residual(f"out_mlp_F{tag}.{1 + r}", params[f"out_mlp_F{tag}_{r}"])
        put(f"out_forces{tag}.linear.weight", np.asarray(params[f"out_forces{tag}"]["kernel"]).T)
    return sd
