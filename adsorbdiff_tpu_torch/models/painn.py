"""PaiNN: the equivariant message-passing score network, in PyTorch.

Port of :mod:`adsorbdiff_tpu.models.painn` in denoising mode with both so3
heads, on the dense ``[B, N, K]`` neighbour table.  Module and parameter names
are the AdsorbDiff reference's (``atom_emb.embeddings``,
``message_layers.i.{x_layernorm,x_proj.0,x_proj.2,rbf_proj}``,
``update_layers.i.{vec_proj,xvec_proj.0,xvec_proj.2}``,
``upd_out_scalar_scale_i.scale_factor``, ``out_forces{,2}.output_network.j.*``),
so a reference ``.pt`` state dict loads with ``load_state_dict`` as it is, and
:func:`painn_state_dict_from_jax` turns a JAX variable tree into one.

The message block always runs :func:`adsorbdiff_tpu_torch.ops.kernels.
painn_message_fused`, which recomputes the gaussian radial basis x polynomial
envelope from the raw neighbour distances, as the JAX model's
``use_pallas=True`` path does; under autograd its backward is the
``painn_message_fused_bwd`` kernel, so training runs both.  There is no
switch: ``use_pallas`` is accepted for config compatibility and ignored.
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
from adsorbdiff_tpu_torch.models.base import generate_graph, prepare_static_graph
from adsorbdiff_tpu_torch.models.layers import AtomEmbedding, ScaledSiLU, ScaleFactor, lecun_normal_, scaled_silu
from adsorbdiff_tpu_torch.ops.kernels import painn_message_fused
from adsorbdiff_tpu_torch.ops.pbc import NeighborList, StaticGraphPart


class PaiNNMessage(nn.Module):
    """Message block (reference painn_denoising.py:498-572)."""

    def __init__(self, hidden_channels: int, num_rbf: int, cutoff: float = 12.0, envelope_exponent: int = 5) -> None:
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.cutoff = cutoff
        self.envelope_exponent = envelope_exponent
        # flax nn.LayerNorm's epsilon (torch's default is 1e-5)
        self.x_layernorm = nn.LayerNorm(h, eps=1e-6)
        self.x_proj = nn.Sequential(nn.Linear(h, h), ScaledSiLU(), nn.Linear(h, 3 * h))
        self.rbf_proj = nn.Linear(num_rbf, 3 * h)

    def forward(
        self, x: torch.Tensor, vec: torch.Tensor, nl: NeighborList, edge_unit: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, k = nl.src.shape
        h = self.hidden_channels
        xh = self.x_proj(self.x_layernorm(x))  # [B, N, 3H]
        # the kernel takes the raw nl.dist (not the 1e-3-clamped edge_dist);
        # the two differ only on masked slots
        dx, dvec = painn_message_fused(
            xh,
            vec.reshape(b, n, 3 * h).contiguous(),
            nl.src,
            nl.dist,
            nl.mask,
            edge_unit,
            self.rbf_proj.weight.t().contiguous(),  # [R, 3H]
            self.rbf_proj.bias,
            cutoff=self.cutoff,
            envelope_exponent=self.envelope_exponent,
        )
        return dx.to(x.dtype), (dvec * (1.0 / math.sqrt(h))).to(x.dtype)


class PaiNNUpdate(nn.Module):
    """Node update block (reference painn_denoising.py:575-623)."""

    def __init__(self, hidden_channels: int) -> None:
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.vec_proj = nn.Linear(h, 2 * h, bias=False)
        self.xvec_proj = nn.Sequential(nn.Linear(2 * h, h), ScaledSiLU(), nn.Linear(h, 3 * h))

    def forward(self, x: torch.Tensor, vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.hidden_channels
        vec1, vec2 = torch.split(self.vec_proj(vec), h, dim=-1)  # [B, N, 3, H] each
        vec_dot = torch.sum(vec1 * vec2, dim=-2) * (1.0 / math.sqrt(h))
        # epsilon under the sqrt keeps the gradient finite at vec2 == 0
        vec2_norm = torch.sqrt(torch.sum(vec2 * vec2, dim=-2) + 1e-8)
        xvec = self.xvec_proj(torch.cat([x, vec2_norm], dim=-1))
        xvec1, xvec2, xvec3 = torch.split(xvec, h, dim=-1)
        dx = (xvec1 + xvec2 * vec_dot) * (1.0 / math.sqrt(2.0))
        dvec = xvec3[:, :, None, :] * vec1
        return dx, dvec


class GatedEquivariantBlock(nn.Module):
    """TorchMD-Net gated equivariant block (reference painn_denoising.py:654-697),
    with an eps-safe norm: padded atoms carry exactly-zero vec features."""

    def __init__(self, hidden_channels: int, out_channels: int) -> None:
        super().__init__()
        h = hidden_channels
        self.out_channels = out_channels
        self.vec1_proj = nn.Linear(h, h, bias=False)
        self.vec2_proj = nn.Linear(h, out_channels, bias=False)
        self.update_net = nn.Sequential(nn.Linear(2 * h, h), ScaledSiLU(), nn.Linear(h, 2 * out_channels))

    def forward(self, x: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        v1 = self.vec1_proj(v)
        vec1 = torch.sqrt(torch.sum(v1 * v1, dim=-2) + 1e-8)
        vec2 = self.vec2_proj(v)  # [B, N, 3, out]
        x_out, gate = torch.split(self.update_net(torch.cat([x, vec1], dim=-1)), self.out_channels, dim=-1)
        return scaled_silu(x_out), gate[:, :, None, :] * vec2


class PaiNNOutput(nn.Module):
    """Two gated equivariant blocks -> per-atom 3-vector."""

    def __init__(self, hidden_channels: int) -> None:
        super().__init__()
        h = hidden_channels
        self.output_network = nn.ModuleList([GatedEquivariantBlock(h, h // 2), GatedEquivariantBlock(h // 2, 1)])

    def forward(self, x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        for block in self.output_network:
            x, vec = block(x, vec)
        return vec[..., 0]  # [B, N, 3]


@registry.register_model("painn")
class PaiNN(nn.Module):
    """PaiNN trunk with the denoising heads.

    Returns the per-atom translation score ``[B, N, 3]`` and, with
    ``so3_denoising=True``, the rotation score as a second ``[B, N, 3]``.
    Hyperparameters default to ``configs/denoising/painn_so3.yml``.

    ``device``: the CUDA card unless ``"cpu"`` is passed (raises without a
    card).  ``generator``: seeds the initial weights (flax's default init
    distributions); weights are usually loaded afterwards.

    Not ported yet (raise ``NotImplementedError``): ``mode="s2ef"``,
    ``compute_dtype="bfloat16"``, ``tag_based_z``, ``energy_encoding``.
    ``sampling`` and ``use_pallas`` are accepted for config compatibility and
    change nothing: ``sampling`` only zeroes the energy conditioning, and the
    message block always runs the fused kernel.
    """

    def __init__(
        self,
        hidden_channels: int = 512,
        num_layers: int = 6,
        num_rbf: int = 128,
        cutoff: float = 12.0,
        max_neighbors: int = 50,
        rbf: Optional[dict] = None,
        envelope: Optional[dict] = None,
        num_elements: int = 83,
        mode: str = "denoising",
        so3_denoising: bool = True,
        energy_encoding: Optional[str] = None,
        sampling: bool = False,
        tag_based_z: bool = False,
        cell_reps: Tuple[int, int, int] = (2, 2, 1),
        compute_dtype: Optional[str] = None,
        use_pallas: Optional[bool] = None,
        max_ads: int = 16,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        for name, value, default in (
            ("mode", mode, "denoising"),
            ("compute_dtype", compute_dtype, None),
            ("tag_based_z", tag_based_z, False),
            ("energy_encoding", energy_encoding, None),
        ):
            if value != default:
                raise NotImplementedError(f"PaiNN {name}={value!r} is not ported yet")
        rbf_name = (rbf or {"name": "gaussian"}).get("name", "gaussian")
        env = envelope or {"name": "polynomial", "exponent": 5}
        if rbf_name != "gaussian" or env.get("name", "polynomial") != "polynomial":
            raise NotImplementedError(
                f"the fused message kernel needs the gaussian/polynomial radial basis, got "
                f"rbf={rbf_name!r} envelope={env.get('name')!r}"
            )
        self.hidden_channels = hidden_channels
        self.num_layers = num_layers
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.so3_denoising = so3_denoising
        self.cell_reps = tuple(int(r) for r in cell_reps)
        self.max_ads = max_ads
        exponent = int(env.get("exponent", 5))

        h = hidden_channels
        self.atom_emb = AtomEmbedding(h, num_elements)
        self.message_layers = nn.ModuleList(
            PaiNNMessage(h, num_rbf, cutoff=cutoff, envelope_exponent=exponent) for _ in range(num_layers)
        )
        self.update_layers = nn.ModuleList(PaiNNUpdate(h) for _ in range(num_layers))
        for i in range(num_layers):
            self.add_module(f"upd_out_scalar_scale_{i}", ScaleFactor())
        self.out_forces = PaiNNOutput(h)
        if so3_denoising:
            self.out_forces2 = PaiNNOutput(h)
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's default init: lecun-normal Dense kernels, zero biases,
        LayerNorm (1, 0), embeddings uniform in [-sqrt(3), sqrt(3)]."""
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, nn.Linear):
                    lecun_normal_(module.weight, generator)
                    if module.bias is not None:
                        module.bias.zero_()
                elif isinstance(module, nn.LayerNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                elif isinstance(module, nn.Embedding):
                    u = torch.rand(module.weight.shape, generator=generator, dtype=module.weight.dtype)
                    module.weight.copy_((2 * u - 1) * math.sqrt(3.0))

    def prepare_static(self, batch: AtomsBatch) -> StaticGraphPart:
        """Hoist the slab-slab neighbour candidates out of a sampling loop."""
        return prepare_static_graph(
            batch, cutoff=self.cutoff, max_neighbors=self.max_neighbors, cell_reps=self.cell_reps
        )

    def forward(self, batch: AtomsBatch, static_graph: Optional[StaticGraphPart] = None):
        nl, _, edge_unit = generate_graph(
            batch, cutoff=self.cutoff, max_neighbors=self.max_neighbors, cell_reps=self.cell_reps,
            static_graph=static_graph, max_ads=self.max_ads,
        )
        x = self.atom_emb(batch.atomic_numbers)  # [B, N, H]
        vec = torch.zeros(x.shape[:2] + (3, self.hidden_channels), dtype=x.dtype, device=x.device)
        inv_sqrt_2 = 1 / math.sqrt(2.0)
        for i in range(self.num_layers):
            dx, dvec = self.message_layers[i](x, vec, nl, edge_unit)
            x = (x + dx) * inv_sqrt_2
            vec = vec + dvec
            dx, dvec = self.update_layers[i](x, vec)
            x = x + dx
            vec = vec + dvec
            x = getattr(self, f"upd_out_scalar_scale_{i}")(x)

        atom3 = batch.atom_mask[..., None]
        forces = torch.where(atom3, self.out_forces(x, vec), 0.0)
        if not self.so3_denoising:
            return forces
        forces2 = torch.where(atom3, self.out_forces2(x, vec), 0.0)
        return forces, forces2


def painn_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX PaiNN variables ``{"params": ..., "scale_factors": ...}`` (nested
    dicts of arrays) -> this port's state dict.

    The inverse of ``adsorbdiff_tpu/train/torch_import.py::
    painn_state_dict_to_params``: flax Dense kernels are ``[in, out]``, torch
    ``Linear.weight`` is ``[out, in]``.
    """
    params = variables["params"]
    scales = variables.get("scale_factors", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, value) -> None:
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    def lin(dest: str, node: Dict[str, Any]) -> None:
        put(dest + ".weight", np.asarray(node["kernel"]).T)
        if "bias" in node:
            put(dest + ".bias", node["bias"])

    put("atom_emb.embeddings.weight", params["AtomEmbedding_0"]["embeddings"])
    num_layers = sum(1 for k in params if k.startswith("message_"))
    for i in range(num_layers):
        msg, upd = params[f"message_{i}"], params[f"update_{i}"]
        put(f"message_layers.{i}.x_layernorm.weight", msg["LayerNorm_0"]["scale"])
        put(f"message_layers.{i}.x_layernorm.bias", msg["LayerNorm_0"]["bias"])
        lin(f"message_layers.{i}.x_proj.0", msg["Dense_0"])
        lin(f"message_layers.{i}.x_proj.2", msg["Dense_1"])
        lin(f"message_layers.{i}.rbf_proj", msg["Dense_2"])
        lin(f"update_layers.{i}.vec_proj", upd["Dense_0"])
        lin(f"update_layers.{i}.xvec_proj.0", upd["Dense_1"])
        lin(f"update_layers.{i}.xvec_proj.2", upd["Dense_2"])
        scale = scales.get(f"upd_out_scalar_scale_{i}", {}).get("scale", 1.0)
        put(f"upd_out_scalar_scale_{i}.scale_factor", np.asarray(scale).reshape(()))
    for head in ("out_forces", "out_forces2"):
        if head not in params:
            continue
        for j in range(2):
            blk = params[head][f"GatedEquivariantBlock_{j}"]
            prefix = f"{head}.output_network.{j}"
            lin(prefix + ".vec1_proj", blk["Dense_0"])
            lin(prefix + ".vec2_proj", blk["Dense_1"])
            lin(prefix + ".update_net.0", blk["Dense_2"])
            lin(prefix + ".update_net.2", blk["Dense_3"])
    return sd
