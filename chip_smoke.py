#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (adsorbdiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises and the exit code is then non-zero:
1. device: the card's name and power limit (nvidia-smi); CUDA required;
   TF32 off (both paths are f32).
2. build: every kernel, from csrc/ with nvcc (one process per source, all
   started together); ptxas register and spill lines for each.
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at its main path's shape and at ragged shapes, with
   |kernel - plain| <= 1e-4 * max|plain| + 1e-5 (f32 sums in another order);
   times from CUDA events after warm-up.  painn_message_fused: at the
   sampling shape (16, 80, 50, 128, 512) on the sampling path's neighbour
   table and at ragged shapes (two older ones; the training shape; N = 300
   and N = 1200, rows read through L1/L2; an all-masked system; sources
   outside [0, N); unmasked slots past the cutoff; H = 200; R = 16; the
   bench graph's slots shuffled within every target), each with its launch
   plan (painn_fwd_plan); its time with its share of the bound, the 8-slot
   windows' products over the needed ones, and ptxas's register and spill
   lines.  gemnet_quad_chain: at the
   relaxation shape (640 cells, U=K2=30, Q=8, S=7, E=F=32) and at ragged
   shapes (an older one; E=40 and F=48, two passes of 32 columns each; S=9,
   two level passes; S*Q*F odd, 4-byte copies into padded rows; every main
   key -1, exact zeros; U=1; one cell's main edges over two blocks), its time
   printed with its launch plan (quad_chain_plan), its share of the bound
   and ptxas's register and spill lines.  masked_legendre_cos (phase 3c):
   gemnet_cbf_basis at the e2e, a2e and e2a inputs one B=8 GemNet-OC forward
   gives it, gemnet_quad_basis at [8, 80, 30, 8, 30] with S=7, and ragged
   shapes (M, K not multiples of 32, zero rows, an all-false keep), each
   against its plain version; times per launch against a bytes bound.
   painn_message_consumer and painn_message_consumer_tiled (phase 3d, ti 1
   and 8): at the second message layer's inputs of one B=16 PaiNN forward
   (M = 1280 targets, K=50, H=512; features gathered in torch), each against
   its plain version and against painn_message_fused on the same layer, and
   at ragged shapes (M not a multiple of 8, K not of 32, an all-false row,
   shared memory over 48 KB).  fused_rbf_filter (phase 3e): at that layer's
   distances, mask and filter weights (the [1280, 50, 1536] filter of the
   plain message versions) and ragged lead shapes with an unmasked edge past
   the cutoff (output = bias).  No model calls these three: every path
   run's exact counts leave them at 0, and the kernels line reports their
   launches summed over those runs.
4. sampling path: PaiNN at the painn_so3.yml widths (H=512, 6 layers, 128
   RBF, cutoff 12 A, K=50; random weights from a seeded generator) drives 100
   ODE reverse-diffusion steps through DiffusionEngine with the hoisted
   static graph, on bench.py's 16 synthetic 80-atom systems.  Launch counts
   are zeroed just before and read just after: 6 layers x 100 steps.
5. card vs CPU, PaiNN: one full-width forward at B=2 on the card against the
   same forward on the CPU (plain versions), |card - cpu| <= 1e-4 * max|cpu|
   (f32 matmuls and sums in another order, over 6 layers; tight enough that
   TF32 or bf16 products, ~1e-3 relative each, would fail it).  The CPU
   runs the forward three times on equal inputs; the reference is an output
   that two of them give bit for bit (on some hosts one CPU forward parts
   from the others; with no two agreeing the phase fails).  Printed before
   the check: each CPU forward against the first, with the first of its
   records that differs (the neighbour search's squared distances before
   and after the sort, the first message layer's src, cell offsets, vec,
   dist and mask, then every submodule's output) and the host's CPU model,
   torch's CPU capability and thread count; both sides' max |output|; and
   whether the card's and the CPU's B=2 neighbour tables agree exactly (if
   not, how many slots differ and the largest distance among them).
6. relaxation path: GemNet-OC at the gemnet_relax.yml widths (4 blocks, atom
   256, edge 512, 128 RBF, 7 spherical, cutoff 12 A, 30/8/20 neighbours, all
   interactions; random weights from a seeded generator; cell_reps from
   auto_cell_reps) relaxes 8 of the bench systems with RelaxationEngine at
   the published relax_opt and the Verlet graph on, for 100 L-BFGS steps
   (cut from 300).  Launch counts are zeroed just before and read just
   after: per model forward 4 gemnet_quad_chain launches (one per block) and
   3 masked_legendre_cos (the e2e, a2e and e2a triplet bases), forwards
   counted by a wrapper around the engine's energy/forces function.
7. card vs CPU, GemNet-OC: one full-width forward at B=2, energy and forces
   within 1e-4 * max|cpu|.
8. training path: the painn_message_fused_bwd kernel against the plain VJP
   at the training shape (a live B=48 neighbour table) and ragged cases (two
   older shapes; N = 300, where the plan takes 16-column slices, and
   N = 1200, where it scatters with global atomics; B = 5, where it takes
   16-column slices to fill a wave; a system whose slots are all masked;
   sources outside [0, N); H = 200), |kernel - plain| <=
   1e-4 * max|plain| + 1e-5 (atomics sum in another order on every run),
   each with its launch plan; its time beside its bound, its share of the
   bound and ptxas's register and spill lines; the forward kernel at the
   same live table against its plain version, its time beside its bound;
   then
   DenoisingTrainer.train() for one epoch of 31 steps at the painn_so3.yml
   + base.yml settings (B=48, AdamW at 1e-4, weight decay 1e-3, cosine
   LambdaLR with warm-up, clip 100, EMA 0.999; random weights from a seeded
   generator; max_epochs cut from 100 to 1) on bench systems written to shards in a temporary directory
   (pos_relaxed = pos).  Launch counts are zeroed just before train() and
   read at every step: exactly 6 forward and 6 backward launches per step.
   Systems/s over the 30 steps after the first; every loss finite; params
   and EMA moved; EMA != params.
9. card vs CPU, one training step at B=2: loss, grad_norm and every
   parameter's gradient within 1e-3 * max|cpu| of that tensor (f32 sums and
   atomics in another order, through 6 layers forward and back).
10. EquiformerV2 kernels: s2_grid_silu and eqv2_attn_conv1 against their
   plain versions on the card at the inputs the B=16 sampling path gives its
   first attention block (captured from one forward) and at ragged shapes,
   |kernel - plain| <= 1e-4 * max|plain| + 1e-5 per output; times from CUDA
   events against their f32 bounds, each with its launch plan (tile,
   cluster, blocks, shared bytes), its share of the bound and ptxas's
   register and spill lines.  s2_grid_silu's ragged shapes: column counts
   (M x C) that are not a multiple of a thread's 4 or a block's 512, at NC
   5, 9 and 19, and two TINY leads.  eqv2_attn_conv1's, at the TINY widths
   of tests/test_equiformer_v2.py and the CONV1_L4 widths of
   tests/test_torch_kernels.py: E one 64-edge tile - 1, one tile a block
   and 1 edge more (a leftover tile split into units), 65 edges a block's
   worth (three leftover tiles, one partial), a tile
   whose every slot is masked, a tile whose distances all lie past the
   cutoff, and two older ragged leads (every plan takes over 48 KB of shared
   memory; no clusters).  Phase 10c: eqv2_attn_conv1's wide route (the
   16-edge kernel that attn_conv1_route picks where the 64-edge plan does not
   fit) at edge-embedding and trunk widths of 256 and the published conv
   widths, E = 25,600 random edges, under the same gate, timed beside its
   plain version and bound.
11. EquiformerV2 sampling path: the eqv2_so3.yml widths (8 layers, 128
   sphere channels, lmax 4 / mmax 2, grid 18, 600 gaussians, cutoff 12 A,
   K=20; random weights from a seeded generator; cell_reps=(2,2,0),
   max_ads=8) drives 100 ODE reverse-diffusion steps through DiffusionEngine
   with the hoisted static graph on the 16 bench systems.  Launch counts are
   zeroed just before and read just after: 10 launches of s2_grid_silu and
   of eqv2_attn_conv1 per step (8 blocks + 2 force heads) and 31 of
   eqv2_edge_rotate (the edge-degree embedding, then source half, target
   half and value rotation back in each of the 10 attentions).  Finite
   outputs, slab atoms unmoved.
12. card vs CPU, EquiformerV2: one full-width forward at B=2, both heads
   within 1e-4 * max|cpu| (TF32 off).
13. EquiformerV2 backward kernels against their plain versions on the card,
   |kernel - plain| <= 1e-4 * max|plain| + 1e-5: eqv2_edge_rotate in every
   form the model runs, at the B=16 sampling graph (to on gathered rows, to
   on the node-level target half, from with n_sel 19 and with n_sel 5, the
   gather variant eqv2_gather_rotate_to), each form's VJP against autograd
   of the plain chain, and two ragged TINY shapes; s2_grid_silu_bwd at the
   first attention block's input of a B=12 training forward (bit for bit
   on a second launch), two ragged TINY shapes, column counts (M x C) that
   are not a multiple of a thread's 2 or a block's 256 at NC 5, 9 and 19,
   random NC = 32 tables, and h scaled so that max |to_eff @ h| = 100 (the
   fast sigmoid's e^-g overflows; the output must stay finite); times from
   CUDA events against their f32 bounds, the backward's with its launch
   plan, its share of the bound and ptxas's lines for its NC = 19
   instance; the conv1 VJP (a plain recompute, no kernel of its own) timed
   at that shape.
14. EquiformerV2 training path: DenoisingTrainer.train() for one epoch at
   the eqv2_so3.yml + base.yml settings (the model block above with
   cell_reps auto; B=12, AdamW at 4e-4, weight decay 1e-3, cosine LambdaLR
   with warm-up, clip 100, EMA 0.999; random weights from a seeded
   generator; max_epochs cut from 100 to 1, of 20 steps) on bench systems
   written to shards.  Launch counts are zeroed just before train() and read
   at every step: exactly 10 s2_grid_silu, 10 eqv2_attn_conv1, 10
   s2_grid_silu_bwd and 31 + 31 eqv2_edge_rotate launches per step (each
   forward rotation and its dual in the backward).  Every loss finite;
   params and EMA moved; EMA != params; validation loss finite; systems/s
   over the steps after the first.
15. card vs CPU, one EquiformerV2 training step at B=2: loss, grad_norm and
   every parameter's gradient within 1e-3 * max|cpu| of that tensor (the
   CPU runs every kernel's plain version, the rotations' decomposed chain
   included).
16. the main path end to end: run_pipeline once, nsites 1, on the 16 bench
   systems written to a shard in a temporary directory.  Sampler: a
   DenoisingTrainer at the painn_so3.yml widths (random weights from its
   seed, cell_reps (2, 2, 0) and max_ads 8 as bench.py sets them), 100 ODE
   steps at B=16.  Relaxer: a GemNet-OC at the gemnet_relax.yml widths
   (random weights from a seeded generator) behind a small relax-trainer
   object; relax_opt as published with 8 slots and continuous unset, so
   "auto" picks the slot-refill engine; fmax 0.01; relaxation_steps cut from
   300 to 100 (random weights never converge, so every system runs its
   budget).  Synthetic DFT targets, one per sid.  Launch counts are zeroed
   just before run_pipeline and read just after: 600 painn_message_fused
   while sampling, and per GemNet-OC forward 4 + 3 while relaxing.  Checks:
   one sampled and one relaxed trajectory per sid; every relaxed frame
   finite with fixed atoms where the converted input has them; each relaxed
   trajectory's last frame is its RelaxedSystem (energy, positions, frame
   count).  Prints wall time per stage, relax system-steps/s, the success
   rate and the per-system anomaly flags.
17. run-relaxations with the GemNet-OC so3 score model: a DenoisingTrainer
   at the gemnet_so3.yml + base.yml settings (4 blocks, atom 256, edge 512,
   128 RBF, 7 spherical, cutoff 12 A, 30/8/20 neighbours, all interactions,
   both heads; random weights from its seed; cell_reps auto) saves a
   checkpoint; the run-relaxations task, built by new_trainer_context as
   the command line builds it, loads it and runs 100 reverse-diffusion
   steps over 8 bench systems in a shard (one batch of 8), writing
   trajectories and relaxed_positions.npz.  Launch counts are zeroed just
   before the task runs and read just after: per score forward 4
   gemnet_quad_chain and 3 masked_legendre_cos, forwards counted by a
   wrapper around the trainer's score_fn.  Then the predict task on the same
   data writes predictions.npz.
18. card vs CPU at B=2, within 1e-4 * max|cpu|: one GemNet-OC so3
   denoising forward at full width (both heads), and one PaiNN forward at
   the painn_conditional.yml widths with non-zero energies (both heads; the
   energy must move the output).
19. the kernels line, then the device line as the last line.  A row's ms,
   plain_ms and bound_ms are per launch; eqv2_edge_rotate's are the mean
   over the four forms in the proportions one forward launches them, and
   its launches are the EquiformerV2 sampling run's; masked_legendre_cos's
   are the mean over the three triplet bases, and its launches are the
   relaxation path's; the consumers' and fused_rbf_filter's launches are
   their counts summed over every path run (0: no path calls them).

It imports nothing of JAX and nothing of the JAX package.
"""
import collections
import copy
import dataclasses
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch import eval_tools, pipeline
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from adsorbdiff_tpu_torch.device import resolve_device
from adsorbdiff_tpu_torch.diffusion.schedules import draw_schedule
from adsorbdiff_tpu_torch.models import equiformer_v2, gemnet_oc
from adsorbdiff_tpu_torch.models.base import generate_graph
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC
from adsorbdiff_tpu_torch.models import painn, so3
from adsorbdiff_tpu_torch.models.painn import PaiNN
from adsorbdiff_tpu_torch.ops import build, kernels, pbc
from adsorbdiff_tpu_torch.relaxation.continuous import ContinuousRelaxationEngine
from adsorbdiff_tpu_torch.relaxation.lbfgs import candidate_fn_for, make_mlff_energy_forces
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, make_score_fn
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory
from adsorbdiff_tpu_torch.tasks import new_trainer_context
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer

# NVIDIA H100 SXM data sheet: dense f32 outside the tensor cores, HBM3 rate
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# every main-path run's launch counts, summed: the kernels line reads the standalone kernels' launches here
PATH_LAUNCHES = collections.Counter()
MODEL_RTOL = 1e-4
CPU_FORWARDS = 3  # phase 5: the CPU reference is an output two of them give bit for bit
PARAMS = dict(num_steps=100, ads_std_low=0.1, ads_std_high=10.0, rot_std_low=0.01, rot_std_high=1.55, ode=True)
MODEL_KW = dict(sampling=True, cell_reps=(2, 2, 0), max_ads=8)  # painn_so3.yml widths by default
# configs/relaxation/gemnet_oc/gemnet_relax.yml, model block; cell_reps: auto
GEMNET_KW = dict(
    mode="s2ef", num_spherical=7, num_radial=128, num_blocks=4, emb_size_atom=256, emb_size_edge=512,
    cutoff=12.0, max_neighbors=30, max_neighbors_qint=8, max_neighbors_aeaint=20, quad_interaction=True,
    atom_edge_interaction=True, edge_atom_interaction=True, atom_interaction=True, qint_tags=(1, 2),
    extensive=True, fused_quad=True,
)
# the published relax_opt; steps cut from 300 (relaxation_steps) to fit the time limit
RELAX_OPT = dict(steps=100, fmax=0.01, maxstep=0.04, memory=50, damping=1.0, alpha=70.0,
                 verlet_graph=True, k_cand=64)
RELAX_BATCH = 8
# run_pipeline's relaxer: gemnet_relax.yml's relax_opt as published (continuous unset: auto picks the slot-refill
# engine at fmax 0.01; run_pipeline writes the trajectories under its out_dir) with 8 slots; relaxation_steps cut
# from 300 as above.  Energies denormalised by the config's dataset block.
PIPELINE_RELAX_OPT = dict(maxstep=0.04, memory=50, damping=1.0, alpha=70.0, slots=8)
PIPELINE_STEPS = 100
GEMNET_TARGET_MEAN, GEMNET_TARGET_STD = -0.7554450631141663, 2.887317180633545
# configs/denoising/painn_so3.yml (model) over configs/denoising/base.yml (optim, task), as a dict: the card
# machine may have no PyYAML.  Cut: max_epochs 100 -> 1 (one epoch of TRAIN_STEPS steps); no checkpoint or
# validation inside the timed epoch.
TRAIN_BATCH, TRAIN_STEPS = 48, 31
TRAIN_CONFIG = dict(
    trainer="denoising",
    model=dict(name="painn", hidden_channels=512, num_layers=6, num_rbf=128, cutoff=12.0, max_neighbors=50,
               so3_denoising=True, use_pallas=True, cell_reps="auto"),
    optim=dict(batch_size=TRAIN_BATCH, eval_batch_size=TRAIN_BATCH, lr_initial=1e-4, optimizer="AdamW",
               optimizer_params=dict(weight_decay=0.001), scheduler="LambdaLR",
               scheduler_params=dict(lambda_type="cosine", warmup_factor=0.2, warmup_epochs=4, lr_min_factor=0.01),
               max_epochs=1, clip_grad_norm=100, ema_decay=0.999, use_denoising_pos=True,
               denoising_pos_params=dict(num_steps=100, ads_std_low=0.1, ads_std_high=10, rot_std_low=0.01,
                                         rot_std_high=1.55),
               eval_every=10**9, checkpoint_every=10**9),
    task=dict(dataset="shards", train_on_free_atoms=True, eval_on_free_atoms=True, primary_metric="loss"),
    logger="tensorboard", seed=0, identifier="smoke", print_every=100,
)
GRAD_RTOL = 1e-3
# configs/denoising/eqv2_so3.yml, model block (the port ignores its use_pallas* switches: the kernels always run);
# cell_reps and max_ads as bench.py sets them for sampling
EQV2_KW = dict(num_layers=8, sphere_channels=128, attn_hidden_channels=64, num_heads=8, attn_alpha_channels=64,
               attn_value_channels=16, ffn_hidden_channels=128, lmax=4, mmax=2, grid_resolution=18,
               edge_channels=128, cutoff=12.0, max_neighbors=20, max_num_elements=90, so3_denoising=True,
               for_denoising=True, sampling=True, cell_reps=(2, 2, 0), max_ads=8)
EQV2_PARAMS = PARAMS  # 100 ODE steps
# configs/denoising/eqv2_so3.yml (model, optim) over configs/denoising/base.yml, as a dict.  Cut: max_epochs
# 100 -> 1 (one epoch of EQV2_TRAIN_STEPS steps); no checkpoint or validation inside the timed epoch.
EQV2_TRAIN_BATCH, EQV2_TRAIN_STEPS, EQV2_EVAL_BATCH = 12, 20, 16
EQV2_TRAIN_CONFIG = dict(
    TRAIN_CONFIG,
    model=dict({k: v for k, v in EQV2_KW.items() if k not in ("sampling", "cell_reps", "max_ads")},
               name="equiformer_v2", use_pallas=True, use_pallas_conv1=True, cell_reps="auto"),
    optim=dict(TRAIN_CONFIG["optim"], batch_size=EQV2_TRAIN_BATCH, eval_batch_size=EQV2_EVAL_BATCH, lr_initial=4e-4),
    identifier="smoke_eqv2",
)
# tests/test_equiformer_v2.py TINY widths: (lmax, mmax, C per half, c_out, extra, gaussians, trunk width, cutoff)
EQV2_TINY = (2, 1, 16, 16, 32, 16, 16, 6.0)
# tests/test_torch_kernels.py CONV1_L4: the production m-block structure (5, 4, 3) at narrow widths
EQV2_L4 = (4, 2, 8, 8, 12, 40, 16, 6.0)
# trunk and embedding width of eqv2_attn_conv1's wide route (phase 10c): the eqv2_so3.yml model at edge_channels 256
CONV1_WIDE = 256
# configs/denoising/gemnet_so3.yml (model) over configs/denoising/base.yml (optim, task), as a dict: full width,
# random weights from the trainer's seed; 100 reverse-diffusion steps (denoising_pos_params.num_steps) over 8 bench
# systems, one batch of 8 (eval_batch_size, which the relax batcher takes).  is_debug: no experiment logger (and
# run_relaxations would only warn on unfitted scale factors; the loaded checkpoint's count as fitted, so the check
# passes without it).
GEMNET_SO3_MODEL = dict(name="gemnet_oc", mode="denoising", so3_denoising=True, num_spherical=7, num_radial=128,
                        num_blocks=4, emb_size_atom=256, emb_size_edge=512, cutoff=12.0, max_neighbors=30,
                        max_neighbors_qint=8, max_neighbors_aeaint=20, quad_interaction=True,
                        atom_edge_interaction=True, edge_atom_interaction=True, atom_interaction=True,
                        qint_tags=[1, 2], cell_reps="auto")
SO3_RELAX_BATCH = 8
GEMNET_SO3_CONFIG = dict(
    trainer="denoising", model=GEMNET_SO3_MODEL,
    optim=dict(TRAIN_CONFIG["optim"], eval_batch_size=SO3_RELAX_BATCH),
    task=dict(TRAIN_CONFIG["task"], relaxation_steps=300, relaxation_fmax=0.01,
              relax_opt=dict(maxstep=0.04, memory=50, damping=1.0, alpha=70.0), write_pos=True),
    logger="tensorboard", is_debug=True, seed=0, identifier="smoke_gemnet_so3", print_every=100,
)
# configs/denoising/painn_conditional.yml's model block (painn_so3.yml widths with the scalar energy encoding)
PAINN_CONDITIONAL_KW = dict(MODEL_KW, sampling=False, energy_encoding="scalar")


def bench_systems(batch_size=16):
    """bench.py's workload: 74 slab + 6 adsorbate atoms, 11.4 x 11.4 x 36 A cell."""
    rng = np.random.default_rng(0)
    n_slab, n_ads = 74, 6
    systems = []
    for i in range(batch_size):
        cell = np.diag([11.4, 11.4, 36.0]).astype(np.float32)
        slab = (rng.random((n_slab, 3)) * [1, 1, 0.35]) @ cell
        ads = rng.random((n_ads, 3)).astype(np.float32) * 1.6 + np.array([5, 5, 14.5], np.float32)
        pos = np.concatenate([slab, ads]).astype(np.float32)
        tags = np.array([0] * (n_slab // 2) + [1] * (n_slab - n_slab // 2) + [2] * n_ads, np.int32)
        z = np.concatenate([rng.integers(20, 80, n_slab), rng.integers(1, 9, n_ads)])
        systems.append(System(pos=pos, atomic_numbers=z, cell=cell, tags=tags, fixed=tags == 0, sid=i))
    return systems


def cuda_ms(fn, iters):
    """Mean milliseconds per call on the card, after two warm-up calls."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def path_launches():
    """A main-path run's launch counts, read just after it (zeroed just
    before it), and added to PATH_LAUNCHES."""
    launches = dict(kernels.launches)
    PATH_LAUNCHES.update(launches)
    return launches


def bound(flops, tensors):
    """Least time on this card: the f32 operations at the f32 peak against
    every given tensor moved once at the HBM rate.  Returns (ms, what sets
    it, bytes)."""
    sizes = {}  # one entry per storage: a tensor passed twice (u is v) moves once
    for t in tensors:
        sizes[t.data_ptr()] = max(sizes.get(t.data_ptr(), 0), t.numel() * t.element_size())
    nbytes = sum(sizes.values())
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), nbytes


def check_close(name, got, want):
    """Max |got - want| over the pairs, held to 1e-4 * max|want| + 1e-5."""
    err, limits = 0.0, []
    for g, w in zip(got, want):
        e = (g - w).abs().max().item()
        limits.append(KERNEL_RTOL * w.abs().max().item() + KERNEL_ATOL)
        if not e <= limits[-1]:
            raise AssertionError(f"{name}: max |kernel - plain| {e} > {limits[-1]}")
        err = max(err, e)
    print(f"[kernel] {name}: max_abs_err {err:.3e} (limit {KERNEL_RTOL} * max|plain| + {KERNEL_ATOL} = "
          f"{', '.join(f'{x:.3e}' for x in limits)})", flush=True)
    return err


# --------------------------------------------------------------------------
# painn_message_fused
# --------------------------------------------------------------------------
def message_inputs(gen, device, b, n, k, r, h, cutoff, nl=None, unit=None):
    """Kernel inputs: the given neighbour table, or a synthetic one with
    masked slots and distances past the cutoff."""
    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    if nl is None:
        src = torch.randint(0, n, (b, n, k), generator=gen, dtype=torch.int32)
        dist = torch.rand((b, n, k), generator=gen) * 1.2 * cutoff
        mask = torch.rand((b, n, k), generator=gen) > 0.2
        unit = normal(b, n, k, 3)
    else:
        src, dist, mask = nl.src.cpu(), nl.dist.cpu(), nl.mask.cpu()
        unit = unit.cpu()
    cpu = dict(xh=normal(b, n, 3 * h), vec=normal(b, n, 3 * h), src=src, dist=dist, mask=mask, unit=unit,
               weight=normal(r, 3 * h, std=r ** -0.5), bias=normal(3 * h, std=0.1))
    return {name: t.to(device).contiguous() for name, t in cpu.items()}


def basis_rows(inputs, cutoff):
    """(valid edges, their non-zero basis values): the basis is a unit-width
    gaussian in r that underflows to exactly 0 in f32 beyond ~14.4 rows of
    its centre, so the products need only these rows (what this run's data
    needs, not the dense R per edge).  ``inputs`` holds ``dist``, ``mask``
    and the ``[R, ...]`` filter weights as ``weight`` or ``weights``."""
    weights = inputs["weight"] if "weight" in inputs else inputs["weights"]
    basis = kernels.message_basis(inputs["dist"], weights.shape[0], cutoff, 5)
    mask = inputs["mask"]
    return int(mask.sum()), int((basis != 0).sum(-1)[mask].sum())


def message_bound_ms(inputs, outputs, cutoff):
    """The function's f32 operations on the valid edges (filter product 6H
    per non-zero basis value, gather-multiply, reductions and directional
    terms ~20H per edge, gaussian basis ~10 per non-zero value) against its
    inputs and outputs moved once."""
    h = inputs["weight"].shape[1] // 3
    edges, rows = basis_rows(inputs, cutoff)
    flops = 6 * h * rows + 20 * h * edges + 10 * rows
    return (*bound(flops, list(inputs.values()) + list(outputs)), flops)


def message_fill(inputs, fill, n, cutoff):
    """Apply ``fill`` to kernel inputs in place and return the inputs the
    plain version takes for them: "masked-system" (every slot of system 1
    masked), "bad-src" (sources -1 and N + 5 on unmasked slots; the plain
    version takes them as masked, the kernels' contract), "past-cutoff"
    (every slot of system 0 unmasked, every other one at or past the
    cutoff: it adds xh * bias)."""
    if fill == "masked-system":
        inputs["mask"][1] = False
    elif fill == "bad-src":
        inputs["src"][..., ::7] = -1
        inputs["src"][..., 3::11] = n + 5
    elif fill == "past-cutoff":
        inputs["mask"][0] = True
        far = inputs["dist"][0, :, ::2]
        far.copy_(torch.linspace(1.0, 1.5, far.numel(), device=far.device).reshape(far.shape) * cutoff)
    ok = (inputs["src"] >= 0) & (inputs["src"] < n)
    return dict(inputs, src=torch.where(ok, inputs["src"], 0), mask=inputs["mask"] & ok)


def fwd_plan_line(plan):
    return (f"plan: {plan.tpb} targets a block, {plan.blocks // plan.slices} ranges x {plan.slices} slices of 32 "
            f"columns = {plan.blocks} blocks x {plan.threads} threads, {plan.waves:.2f} waves of one block an SM, "
            f"{plan.load} targets on a block's busiest scheduler, {plan.smem_bytes} B shared, W "
            f"{'staged' if plan.stage_w else 'through L1/L2'}, xh/vec rows "
            f"{f'staged ({plan.rows} rows)' if plan.stage_rows else 'through L1/L2'}")


def check_message_kernel(device, gen, shape, cutoff, nl=None, unit=None, fill=None, what=""):
    b, n, k, r, h = shape
    inputs = message_inputs(gen, device, *shape, cutoff, nl=nl, unit=unit)
    plain = message_fill(inputs, fill, n, cutoff)
    plan = kernels.painn_fwd_plan(b, n, k, r, h, kernels._sm_count(device))
    got = kernels.painn_message_fused(**inputs, cutoff=cutoff)
    torch.cuda.synchronize()
    want = kernels.painn_message_fused_reference(**plain, cutoff=cutoff)
    err = check_close(f"painn_message_fused b,n,k,r,h={shape}{' ' + fill if fill else ''}{what} "
                      f"({fwd_plan_line(plan)})", got, want)
    return inputs, got, err


def shuffled_slots(nl, unit, seed):
    """The neighbour table with the slots of every target in random order
    (the graph sorts them by distance)."""
    perm = torch.argsort(torch.rand(nl.src.shape, generator=torch.Generator().manual_seed(seed)), dim=-1)
    perm = perm.to(nl.src.device)
    table = types.SimpleNamespace(**{name: torch.gather(getattr(nl, name), 2, perm)
                                     for name in ("src", "dist", "mask")})
    return table, torch.gather(unit, 2, perm[..., None].expand(-1, -1, -1, 3))


def window_ratio(inputs, cutoff):
    """Products the forward kernel runs over its 8-slot groups' windows on
    valid slots, over the non-zero basis values those slots need (the
    window rule's Python mirror, kernels.painn_fwd_windows)."""
    src, dist, mask = inputs["src"], inputs["dist"], inputs["mask"]
    b, n, k = src.shape
    lo, hi = kernels.painn_fwd_windows(dist, mask, src, inputs["weight"].shape[0], cutoff)
    valid = mask & (src >= 0) & (src < n)
    per_group = torch.nn.functional.pad(valid, (0, lo.shape[-1] * 8 - k)).reshape(b, n, -1, 8).sum(-1)
    _, rows = basis_rows(inputs, cutoff)
    return float((torch.clamp(hi - lo + 1, min=0) * per_group).sum()) / rows


def message_bwd_bound_ms(inputs, cts, outputs, cutoff):
    """The VJP's f32 operations on the valid edges (filter recompute and dW,
    6H each per non-zero basis value; elementwise products and scatters ~30H
    per edge; basis ~10 per non-zero value) against its inputs, cotangents
    and outputs moved once."""
    h = inputs["weight"].shape[1] // 3
    edges, rows = basis_rows(inputs, cutoff)
    flops = 12 * h * rows + 30 * h * edges + 10 * rows
    return (*bound(flops, list(inputs.values()) + list(cts) + list(outputs)), flops)


def check_message_bwd_kernel(device, gen, shape, cutoff, nl=None, unit=None, fill=None):
    """The backward kernel against the plain VJP.  ``fill``: "masked-system"
    (every slot of system 1 masked), or "bad-src" (sources -1 and N + 5 on
    unmasked slots; the plain VJP takes them as masked, the kernel's
    contract)."""
    b, n, _, _, h = shape
    inputs = message_inputs(gen, device, *shape, cutoff, nl=nl, unit=unit)
    plain = message_fill(inputs, fill, n, cutoff)
    cts = (torch.randn((b, n, h), generator=gen).to(device), torch.randn((b, n, 3, h), generator=gen).to(device))
    plan = kernels.painn_bwd_plan(b, n, shape[2], shape[3], h, kernels._sm_count(device))
    got = kernels.painn_message_fused_bwd(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=cutoff)
    torch.cuda.synchronize()
    want = kernels.painn_message_fused_bwd_reference(**plain, dx_ct=cts[0], dvec_ct=cts[1], cutoff=cutoff)
    err = check_close(f"painn_message_fused_bwd b,n,k,r,h={shape}{' ' + fill if fill else ''} "
                      f"({bwd_plan_line(plan)})", got, want)
    return inputs, cts, got, err


def bwd_plan_line(plan):
    return (f"plan: {plan.cols} columns h a block, {plan.slices} slices x {plan.blocks // plan.slices} systems = "
            f"{plan.blocks} blocks x {plan.threads} threads, {plan.waves:.2f} waves of one block an SM, "
            f"{plan.smem_bytes} B shared, {'global-atomic' if plan.global_scatter else 'shared-memory'} scatter, "
            f"xh/vec rows {'staged' if plan.stage_rows else 'through L1/L2'}")


# --------------------------------------------------------------------------
# gemnet_quad_chain
# --------------------------------------------------------------------------
def quad_inputs(gen, device, b, n, u, q, k2, s, e, f, negative_keys=3):
    """Chain inputs with keys from a small range (c == d collisions are
    frequent), -1 keys on the last ``negative_keys`` main edges (never
    match) and zero n1/n2 rows (masked edges have unit = 0)."""
    n1 = torch.randn((b, n, u, q, 3), generator=gen)
    n2 = torch.randn((b, n, q, k2, 3), generator=gen)
    n1[:, :, -2:] = 0.0
    n2[:, :, :, -3:] = 0.0
    key1 = torch.randint(0, 50, (b, n, u), generator=gen, dtype=torch.int32)
    if negative_keys:
        key1[..., -negative_keys:] = -1
    key2 = torch.randint(0, 50, (b, n, q, k2), generator=gen, dtype=torch.int32)
    cpu = dict(n1=n1, n2=n2, key1=key1, key2=key2, xm=torch.randn((b, n, q, k2, e), generator=gen),
               qp=torch.randn((b, n, u, s, q, f), generator=gen))
    return {name: t.to(device).contiguous() for name, t in cpu.items()}


def quad_bound_ms(inputs, out, s):
    """Per cell: the K2 contraction 2*U*Q*K2*S*E, the (S, Q) contraction
    2*U*S*Q*F*E, and the basis ~(4S + 10) per (u, q, k) (cosine, clip,
    Legendre recurrence, scale, mask); every input once, out once."""
    b, n, u, q, _ = inputs["n1"].shape
    k2, e = inputs["xm"].shape[3:]
    f = inputs["qp"].shape[-1]
    flops = b * n * (2 * u * q * k2 * s * e + 2 * u * s * q * f * e + u * q * k2 * (4 * s + 10))
    return (*bound(flops, list(inputs.values()) + [out]), flops)


def quad_plan_line(plan):
    return (f"plan: {plan.warps} warps a block, {plan.parts} block(s) a cell, {plan.blocks} blocks x {plan.threads} "
            f"threads, {plan.blocks_per_sm} block(s) an SM, {plan.waves:.2f} waves, {plan.smem_bytes} B shared, "
            f"{plan.qp_buffers} qp buffer(s) a warp of {plan.copy_bytes}-byte copies, passes (levels, e, f) "
            f"{plan.level_passes}, {plan.e_passes}, {plan.f_passes}")


def check_quad_kernel(device, gen, shape, negative_keys=3):
    s = shape[5]
    inputs = quad_inputs(gen, device, *shape, negative_keys=negative_keys)
    got = kernels.gemnet_quad_chain(**inputs, num_spherical=s)
    torch.cuda.synchronize()
    want = kernels.gemnet_quad_chain_reference(**inputs, num_spherical=s)
    err = check_close(f"gemnet_quad_chain b,n,u,q,k2,s,e,f={shape}", [got], [want])
    return inputs, got, err


# --------------------------------------------------------------------------
# masked_legendre_cos (gemnet_cbf_basis, gemnet_quad_basis)
# --------------------------------------------------------------------------
def capture_calls(module, name, fn):
    """Run ``fn()`` with ``module.<name>`` wrapped; returns every call's
    positional arguments, in order."""
    seen, original = [], getattr(module, name)

    def rec(*args, **kwargs):
        seen.append(args)
        return original(*args, **kwargs)

    setattr(module, name, rec)
    try:
        fn()
    finally:
        setattr(module, name, original)
    return seen


def legendre_inputs(gen, device, a_shape, b_shape, keep_shape, unit, keep_all=None):
    """3-vector rows (unit for the triplet bases, raw cross products for the
    dihedral one) with exact-zero rows as masked edges give, and a random or
    all-false ``keep``."""
    a, b = torch.randn(a_shape + (3,), generator=gen), torch.randn(b_shape + (3,), generator=gen)
    if unit:
        a, b = a / a.norm(dim=-1, keepdim=True), b / b.norm(dim=-1, keepdim=True)
    a[0, 0, 0] = 0.0
    b[-1, -1, -1] = 0.0
    keep = torch.rand(keep_shape, generator=gen) > 0.3 if keep_all is None else torch.full(keep_shape, keep_all)
    return [t.to(device).contiguous() for t in (a, b, keep)]


def legendre_bound_ms(inputs, out, s):
    """Per (m, k) column: the dot and the clip ~7, the recurrence ~4 per
    level, the coefficient and the mask 2 per level (the dihedral basis's
    normalisation, ~12 per row, is left out); every input once, out once."""
    flops = out.numel() // s * (6 * s + 7)
    return (*bound(flops, list(inputs) + [out]), flops)


def check_legendre(name, fn, plain, args, s):
    got = fn(*args, s)
    torch.cuda.synchronize()
    shapes = " ".join(str(tuple(t.shape)) for t in args)
    return got, check_close(f"{name} {shapes} S={s}", [got], [plain(*args, s)])


def legendre_checks(device, gen, model, batch):
    """Phase 3c: the three triplet bases at the inputs one forward of
    ``model`` on ``batch`` gives them, the dihedral basis at the relaxation
    shape, and ragged shapes; returns the kernels-line row (times per launch,
    the mean over the three triplet bases a forward launches)."""
    s = model.num_spherical
    with torch.no_grad():
        calls = capture_calls(gemnet_oc, "gemnet_cbf_basis", lambda: model(batch))
    if len(calls) != 3:
        raise AssertionError(f"one GemNet-OC forward called gemnet_cbf_basis {len(calls)} times, want 3")
    err, times, bys = 0.0, [], []
    for form, (u, v, keep, _) in zip(("e2e", "a2e", "e2a"), calls):
        out, e = check_legendre(f"gemnet_cbf_basis {form}", kernels.gemnet_cbf_basis,
                                kernels.gemnet_cbf_basis_reference, (u, v, keep), s)
        err = max(err, e)
        ms = cuda_ms(lambda: kernels.gemnet_cbf_basis(u, v, keep, s), 20)
        plain_ms = cuda_ms(lambda: kernels.gemnet_cbf_basis_reference(u, v, keep, s), 5)
        bound_ms, by, nbytes, flops = legendre_bound_ms((u, v, keep), out, s)
        times.append((ms, plain_ms, bound_ms))
        bys.append(by)
        print(f"[kernel] masked_legendre_cos as gemnet_cbf_basis {form} at u{tuple(u.shape)} v{tuple(v.shape)}: "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.3f} GFLOP f32, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
    del calls, out
    b, n = batch.batch_size, batch.max_atoms
    k1, kq = model.max_neighbors, model.max_neighbors_qint
    quad = legendre_inputs(gen, device, (b, n, k1, kq), (b, n, kq, k1), (b, n, k1, kq, k1), unit=False)
    out, e = check_legendre("gemnet_quad_basis", kernels.gemnet_quad_basis, kernels.gemnet_quad_basis_reference,
                            quad, s)
    err = max(err, e)
    q_ms = cuda_ms(lambda: kernels.gemnet_quad_basis(*quad, s), 20)
    q_plain_ms = cuda_ms(lambda: kernels.gemnet_quad_basis_reference(*quad, s), 5)
    q_bound, q_by, q_bytes, _ = legendre_bound_ms(quad, out, s)
    print(f"[kernel] masked_legendre_cos as gemnet_quad_basis at n1{tuple(quad[0].shape)}: {q_ms:.4f} ms, plain "
          f"{q_plain_ms:.4f} ms, bound {q_bound:.4f} ms by {q_by} ({q_bytes / 1e6:.2f} MB)", flush=True)
    del quad, out
    # ragged: M and K not multiples of 32, zero rows, an all-false keep; the plain-interface wrapper
    for lead, m, k, keep_all in (((3, 5), 29, 13, None), ((2, 3), 33, 1, False)):
        args = legendre_inputs(gen, device, lead + (m,), lead + (k,), lead + (m, k), unit=True, keep_all=keep_all)
        check_legendre("gemnet_cbf_basis ragged", kernels.gemnet_cbf_basis, kernels.gemnet_cbf_basis_reference,
                       args, 7)
        flat = (args[0].reshape(-1, m, 3), args[1].reshape(-1, k, 3).transpose(1, 2).contiguous(),
                args[2].reshape(-1, m, k))
        check_legendre("masked_legendre_cos ragged", kernels.masked_legendre_cos,
                       kernels.masked_legendre_cos_reference, flat, 5)
    for keep_all in (None, False):
        args = legendre_inputs(gen, device, (2, 3, 13, 5), (2, 3, 5, 29), (2, 3, 13, 5, 29), unit=False,
                               keep_all=keep_all)
        check_legendre("gemnet_quad_basis ragged", kernels.gemnet_quad_basis, kernels.gemnet_quad_basis_reference,
                       args, 4)
    ms, plain_ms, bound_ms = (sum(t[i] for t in times) / len(times) for i in range(3))
    by = "bytes" if set(bys) == {"bytes"} else "operations"
    print(f"[kernel] masked_legendre_cos per launch (mean of e2e, a2e, e2a): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {by}", flush=True)
    return dict(name="masked_legendre_cos", source="adsorbdiff_tpu_torch/csrc/masked_legendre_cos.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:1613", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


# --------------------------------------------------------------------------
# painn_message_consumer{,_tiled} and fused_rbf_filter (no model calls them)
# --------------------------------------------------------------------------
def consumer_inputs(gen, device, m, k, r, h, cutoff):
    """Gathered-feature inputs with masked slots, distances past the cutoff
    and an all-false last row."""
    mask = torch.rand((m, k), generator=gen) > 0.2
    mask[-1] = False
    cpu = dict(dist=torch.rand((m, k), generator=gen) * 1.2 * cutoff, mask=mask,
               unit=torch.randn((m, k, 3), generator=gen), xh_gathered=torch.randn((m, k, 3 * h), generator=gen),
               vec_gathered=torch.randn((m, k, 3 * h), generator=gen),
               weights=torch.randn((r, 3 * h), generator=gen) * r ** -0.5, bias=torch.randn(3 * h, generator=gen) * 0.1)
    return {name: t.to(device).contiguous() for name, t in cpu.items()}


def consumer_bound_ms(inputs, outputs, cutoff):
    """message_bound_ms's operations (the same function after the gather)
    against the gathered inputs and the outputs moved once."""
    h = inputs["weights"].shape[1] // 3
    edges, rows = basis_rows(inputs, cutoff)
    flops = 6 * h * rows + 20 * h * edges + 10 * rows
    return (*bound(flops, list(inputs.values()) + list(outputs)), flops)


def rbf_bound_ms(inputs, out, cutoff):
    """The product on the valid edges' non-zero basis values (2F each), the
    basis (~10 per value) and the bias and mask (2F per edge), against the
    inputs and the [..., K, F] output moved once."""
    f = inputs["weights"].shape[1]
    edges, rows = basis_rows(inputs, cutoff)
    flops = 2 * f * rows + 10 * rows + 2 * f * inputs["dist"].numel()
    return (*bound(flops, list(inputs.values()) + [out]), flops)


@torch.no_grad()
def consumer_checks(device, gen, systems):
    """Phases 3d and 3e: the consumers and the radial filter at the second
    message layer's inputs of one B=16 PaiNN forward (the first layer's vec
    is all zero), held against their plain versions and the consumers
    against painn_message_fused on the same layer; ragged shapes; times per
    launch against their bounds.  These launches stay outside every path
    run; the kernels line takes the three kernels' launches from
    PATH_LAUNCHES, which the paths' exact counts hold at 0."""
    batch = collate(systems, max_atoms=80, device=device)
    model = PaiNN(**MODEL_KW, device=device, generator=gen)
    with torch.no_grad():
        calls = capture_calls(painn, "painn_message_fused", lambda: model(batch))
    if len(calls) != model.num_layers:
        raise AssertionError(f"one PaiNN forward called painn_message_fused {len(calls)} times")
    xh, vec, src, dist, mask, unit, weight, bias = calls[1]
    del calls
    b, n, k = src.shape
    m, f3, cutoff = b * n, weight.shape[1], model.cutoff
    idx = src.reshape(b, n * k, 1).long().expand(-1, -1, f3)
    layer = dict(dist=dist.reshape(m, k).contiguous(), mask=mask.reshape(m, k).contiguous(),
                 unit=unit.reshape(m, k, 3).contiguous(),
                 xh_gathered=torch.gather(xh, 1, idx).reshape(m, k, f3),
                 vec_gathered=torch.gather(vec, 1, idx).reshape(m, k, f3), weights=weight, bias=bias)
    fused = [t.reshape(m, *t.shape[2:]) for t in kernels.painn_message_fused(xh, vec, src, dist, mask, unit, weight,
                                                                            bias, cutoff=cutoff)]
    want = kernels.painn_message_consumer_reference(**layer, cutoff=cutoff)
    plain_ms = cuda_ms(lambda: kernels.painn_message_consumer_reference(**layer, cutoff=cutoff), 5)
    edges, nz = basis_rows(layer, cutoff)
    shape = f"M={m}, K={k}, R={weight.shape[0]}, H={f3 // 3}"
    rows = []
    for name, ti, line in (("painn_message_consumer", 1, 130), ("painn_message_consumer_tiled", 8, 769)):
        fn = getattr(kernels, name)
        got = fn(**layer, cutoff=cutoff, ti=ti)
        torch.cuda.synchronize()
        err = check_close(f"{name} ti={ti} at the PaiNN layer ({shape})", got, want)
        check_close(f"{name} ti={ti} against painn_message_fused on the same layer", got, fused)
        for ragged in ((37, 45, 128, 192), (13, 10, 16, 64), (5, 120, 128, 64)):  # M % 8, K % 32, smem > 48 KB
            ins = consumer_inputs(gen, device, *ragged, 6.0)
            out = fn(**ins, cutoff=6.0, ti=ti)
            torch.cuda.synchronize()
            check_close(f"{name} ti={ti} m,k,r,h={ragged}", out,
                        kernels.painn_message_consumer_reference(**ins, cutoff=6.0))
            if out[0][-1].any() or out[1][-1].any():
                raise AssertionError(f"{name}: a row with an all-false mask is not zero")
        ms = cuda_ms(lambda: fn(**layer, cutoff=cutoff, ti=ti), 20)
        bound_ms, by, nbytes, flops = consumer_bound_ms(layer, got, cutoff)
        print(f"[kernel] {name} ti={ti} at {shape} ({edges} valid edges, {nz / edges:.2f} non-zero basis values "
              f"each): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP "
              f"f32, {nbytes / 1e6:.2f} MB)", flush=True)
        rows.append(dict(name=name, source="adsorbdiff_tpu_torch/csrc/painn_message_consumer.cu",
                         replaces=f"adsorbdiff_tpu/ops/pallas_kernels.py:{line}", launches=None, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by))
    del layer["xh_gathered"], layer["vec_gathered"], got, want, fused

    # 3e. fused_rbf_filter at the same layer's distances, mask and filter weights: the plain version is the
    # filter the plain message versions build
    filt = dict(dist=layer["dist"], mask=layer["mask"], weights=weight, bias=bias)
    out = kernels.fused_rbf_filter(**filt, cutoff=cutoff)
    torch.cuda.synchronize()
    err = check_close(f"fused_rbf_filter at the PaiNN layer's [{m}, {k}] edges (the plain message filter)", [out],
                      [kernels.fused_rbf_filter_reference(**filt, cutoff=cutoff)])
    for lead, r, f in (((3, 10, 8), 16, 100), ((127,), 16, 128), ((2, 5, 50), 128, 1536)):
        ins = dict(dist=torch.rand(lead, generator=gen) * 7.2, mask=torch.rand(lead, generator=gen) > 0.3,
                   weights=torch.randn((r, f), generator=gen) * r ** -0.5, bias=torch.randn(f, generator=gen))
        ins["dist"].view(-1)[0], ins["mask"].view(-1)[0] = 7.5, True  # unmasked, past the 6 A cutoff
        ins = {name: t.to(device) for name, t in ins.items()}
        got = kernels.fused_rbf_filter(**ins, cutoff=6.0)
        torch.cuda.synchronize()
        check_close(f"fused_rbf_filter lead {lead} R={r} F={f}", [got],
                    [kernels.fused_rbf_filter_reference(**ins, cutoff=6.0)])
        if not torch.equal(got.reshape(-1, f)[0], ins["bias"]):
            raise AssertionError("fused_rbf_filter: an unmasked edge past the cutoff does not give the bias")
    ms = cuda_ms(lambda: kernels.fused_rbf_filter(**filt, cutoff=cutoff), 20)
    plain_ms = cuda_ms(lambda: kernels.fused_rbf_filter_reference(**filt, cutoff=cutoff), 5)
    bound_ms, by, nbytes, flops = rbf_bound_ms(filt, out, cutoff)
    print(f"[kernel] fused_rbf_filter at [{m}, {k}] x R={weight.shape[0]} -> F={f3}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP f32, {nbytes / 1e6:.2f} MB)",
          flush=True)
    rows.append(dict(name="fused_rbf_filter", source="adsorbdiff_tpu_torch/csrc/fused_rbf_filter.cu",
                     replaces="adsorbdiff_tpu/ops/pallas_kernels.py:256", launches=None, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by))
    return rows


# --------------------------------------------------------------------------
# EquiformerV2: s2_grid_silu and eqv2_attn_conv1
# --------------------------------------------------------------------------
def capture_first_calls(module, names, fn):
    """Run ``fn()`` with ``module.<name>`` wrapped for each name so that the
    first call's (args, kwargs) are recorded; returns them by name."""
    seen, originals = {}, {name: getattr(module, name) for name in names}

    def recorder(name):
        def rec(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return originals[name](*args, **kwargs)
        return rec

    for name in names:
        setattr(module, name, recorder(name))
    try:
        fn()
    finally:
        for name, orig in originals.items():
            setattr(module, name, orig)
    return seen


def s2_bound_ms(h, to_m, from_m, out):
    """2 x 2 G NC per (edge, channel) column for the two products and ~6 G
    for the SiLU; h, both tables and out moved once."""
    g, nc = to_m.shape
    cols = h.numel() // nc
    flops = cols * (4 * g * nc + 6 * g)
    return (*bound(flops, [h, to_m, from_m, out]), flops)


def ptxas_lines(name, instance=""):
    """ptxas's register and spill lines for kernel source ``name`` (this
    process's build); with ``instance``, only those of the functions whose
    mangled name holds it (e.g. ``"ILi19E"``: a template instance)."""
    lines, function = [], ""
    for line in build.build_logs.get(name, "").splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            function = line
        elif ("registers" in line or "spill" in line) and instance in function:
            lines.append(line.strip())
    return lines


def check_s2_kernel(name, h, to_m, from_m):
    got = kernels.s2_grid_silu(h, to_m, from_m)
    torch.cuda.synchronize()
    return got, check_close(f"s2_grid_silu {name} h{tuple(h.shape)}", [got], [kernels.s2_grid_silu_reference(h, to_m, from_m)])


def conv1_inputs(gen, device, lmax, mmax, lead, c, c_out, extra, r, width, cutoff):
    """Random edges (masked slots, distances past the cutoff), the weight
    trees and the keyword arguments of eqv2_attn_conv1 at the given widths."""
    nb = kernels.conv1_blocks(lmax, mmax)
    n_act = nb[0] + 2 * sum(nb[1:])

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    edges = dict(dist=torch.rand(lead, generator=gen) * 1.1 * cutoff, mask=torch.rand(lead, generator=gen) > 0.2,
                 emb_s=normal(*lead, width), emb_t=normal(*lead, width),
                 msg_s=normal(*lead, n_act, c), msg_t=normal(*lead, n_act, c))
    n_rad = 2 * sum(nb) * c
    rad = {"dense_0": {"kernel": normal(r + 2 * width, width, scale=0.2), "bias": normal(width, scale=0.1)},
           "ln_0": {"scale": 1 + normal(width, scale=0.1), "bias": normal(width, scale=0.1)},
           "dense_1": {"kernel": normal(width, width, scale=0.25), "bias": normal(width, scale=0.1)},
           "ln_1": {"scale": 1 + normal(width, scale=0.1), "bias": normal(width, scale=0.1)},
           "dense_2": {"kernel": normal(width, n_rad, scale=0.25), "bias": normal(n_rad, scale=0.1)}}
    conv = {"fc_m0": {"kernel": normal(nb[0] * 2 * c, extra + nb[0] * c_out, scale=0.1),
                      "bias": normal(extra + nb[0] * c_out, scale=0.1)}}
    for mi in range(1, mmax + 1):
        for part in ("r", "i"):
            conv[f"fc_m{mi}_{part}"] = {"kernel": normal(nb[mi] * 2 * c, nb[mi] * c_out, scale=0.1)}
    to_dev = lambda t: {k: to_dev(v) if isinstance(v, dict) else v.to(device) for k, v in t.items()}  # noqa: E731
    kw = dict(lmax=lmax, mmax=mmax, c_out=c_out, extra=extra, num_gauss=r, cutoff=cutoff)
    return [t.to(device).contiguous() for t in edges.values()] + [to_dev(rad), to_dev(conv)], kw


def conv1_plan(args, kw):
    """The launch plan the wrapper takes for these inputs."""
    nb = kernels.conv1_blocks(kw["lmax"], kw["mmax"])
    rad = args[6]
    width = rad["dense_1"]["kernel"].shape[0]
    return kernels.attn_conv1_plan(args[0].numel(), kw["num_gauss"], args[2].shape[-1], width, args[4].shape[-1],
                                   kw["c_out"], kw["extra"], nb, kernels._sm_count(args[0].device))


def conv1_ragged_cases(gen, device):
    """Phase 10b's ragged conv1 inputs at TINY and CONV1_L4 widths: E one
    64-edge tile - 1 (one block); one tile a block and 1 edge more (a 1-edge
    tile left over, computed as units, one column pass of a 32-edge half
    each, on other blocks); 65 edges a block's worth (three tiles left over,
    one partial); a
    tile whose every slot is masked; a tile whose distances all lie past the
    cutoff (every gaussian slice skipped); and the older ragged leads.  Every
    plan here takes more than 48 KB of shared memory (the design's least is
    ~170 KB); no clusters are used."""
    sms = kernels._sm_count(device)
    for widths, tag in ((EQV2_TINY, "TINY"), (EQV2_L4, "L4")):
        for lead, fill in (((63,), None), ((64 * sms + 1,), None), ((65 * sms,), None), ((129,), "masked"),
                           ((129,), "far"), ((37,), None), ((2, 13, 5), None)):
            args, kw = conv1_inputs(gen, device, *widths[:2], lead, *widths[2:])
            if fill is not None:  # the kernel's second tile
                _, e0, n, _ = list(kernels.attn_conv1_work(args[0].numel(), conv1_plan(args, kw).blocks, 1))[1]
                if fill == "masked":
                    args[1].view(-1)[e0:e0 + n] = False
                else:
                    args[0].view(-1)[e0:e0 + n] = 1.5 * kw["cutoff"] + torch.arange(n, dtype=torch.float32,
                                                                                     device=device)
            yield f"{tag} {fill or 'ragged'}", args, kw


def check_conv1_kernel(name, args, kw):
    got = kernels.eqv2_attn_conv1(*args, **kw)
    torch.cuda.synchronize()
    want = kernels.eqv2_attn_conv1_reference(*args, **kw)
    return got, check_close(f"eqv2_attn_conv1 {name} E={args[0].numel()}", got, want)


def conv1_bound_ms(args, kw, outputs):
    """Per edge: the trunk 2 H (R' + 2 Ed + H + NG) with R' the gaussian rows
    that are not exactly 0 in f32 on this data (all R for the dense count),
    ~20 H for the two LayerNorm+SiLU, NG gate multiplies, and the conv
    products (m0: 2 x 2 n0 C (extra + n0 c_out); each |m| > 0 block: 2 halves
    x 4 products x 2 nb C nb c_out); every input, packed weight and output
    moved once.  Returns (ms, by, bytes, flops, dense flops, non-zero rows
    per edge)."""
    edges, (dist, mask) = args[:6], args[:2]
    packed = kernels.pack_attn_conv1(*args[6:], lmax=kw["lmax"], mmax=kw["mmax"], num_gauss=kw["num_gauss"],
                                     c_in=edges[4].shape[-1])
    e = dist.numel()
    r, width = packed.trunk[0].shape
    e_dim, ng = packed.trunk[1].shape[0], packed.trunk[10].shape[1]
    c, nb = packed.c_in, packed.n_blocks
    c_out, extra = kw["c_out"], kw["extra"]
    delta = kw["cutoff"] / (r - 1)
    off = torch.arange(r, dtype=torch.float32, device=dist.device) * delta
    gauss = torch.exp(-0.5 / (2.0 * delta) ** 2 * (dist.reshape(-1, 1) - off) ** 2) * mask.reshape(-1, 1)
    rows = int((gauss != 0).sum())
    conv = 4 * nb[0] * c * (extra + nb[0] * c_out) + sum(16 * n * c * n * c_out for n in nb[1:])
    per_edge = 2 * width * (2 * e_dim + width + ng) + 20 * width + ng + conv
    flops, dense = e * per_edge + 2 * width * rows, e * (per_edge + 2 * width * r)
    tensors = list(edges) + list(packed.trunk) + [packed.flat_conv] + list(outputs)
    return (*bound(flops, tensors), flops, dense, rows / e)


def s2_bwd_bound_ms(h, dy, to_m, from_m, out):
    """3 x 2 G NC per (edge, channel) column for the three products (g
    recomputed, dg, dh) and ~10 G for the sigmoid and silu'; h, dy, both
    tables and dh moved once."""
    g, nc = to_m.shape
    cols = h.numel() // nc
    flops = cols * (6 * g * nc + 10 * g)
    return (*bound(flops, [h, dy, to_m, from_m, out]), flops)


def rotate_bound_ms(lmax, mmax, n_sel, inputs, out):
    """Per (edge, channel) column: the full block product, 2 sum_l (2l+1)^2;
    the other one on the selected rows only, 2 sum_r (2 l_r + 1); two Dz
    stages, 4 FLOP per |m| > 0 row each; per edge, 2 x lmax sincos (~20
    FLOP each).  Every input (a node table once, however many edges read
    it) and out moved once."""
    dim = (lmax + 1) ** 2
    j_blocks, _, row = so3.edge_rot_consts(lmax, mmax, n_sel)
    l_of = np.floor(np.sqrt(np.arange(dim))).astype(int)
    selected = int((2 * l_of[row >= 0] + 1).sum())
    c = out.shape[-1]
    edges = out.numel() // (out.shape[-2] * c)
    flops = edges * c * (2 * j_blocks.size + 2 * selected + 8 * (dim - lmax - 1)) + edges * 40 * lmax
    return (*bound(flops, list(inputs) + [out]), flops)


def check_rotations(device, gen, batch, model):
    """Phase 13a: eqv2_edge_rotate in every form the model runs, at the
    batch's live graph and the model's widths, and each form's VJP against
    autograd of the plain chain; then ragged TINY shapes.  Returns the
    kernels-line row, its times per launch: the mean over the forms in the
    proportions one forward launches them."""
    nl, _, unit = generate_graph(batch, cutoff=model.cutoff, max_neighbors=model.max_neighbors,
                                 cell_reps=model.cell_reps)
    gamma, beta = so3.edge_euler_angles(unit)
    lmax, mmax, c = model.lmax, model.mmax, model.sphere_channels
    b, n, k = nl.src.shape
    dim, n_act, n0 = (lmax + 1) ** 2, so3.n_act_rows(lmax, mmax), lmax + 1
    x = torch.randn((b, n, dim, c), generator=gen).to(device)
    x_edge = equiformer_v2.gather_nodes(x, nl.src).contiguous()
    v = torch.randn((b, n, k, n_act, c), generator=gen).to(device)
    deg = torch.randn((b, n, k, n0, c), generator=gen).to(device)
    def rotate(direction, n_sel=None, node=False):
        return lambda fn, t: fn(t[:, :, None] if node else t, gamma, beta, lmax, mmax, direction=direction,
                                n_sel=n_sel)

    forms = [  # (name, input, apply(fn, input), n_sel, kernel, plain)
        ("to, gathered rows", x_edge, rotate("to"), n_act, kernels.eqv2_edge_rotate,
         kernels.eqv2_edge_rotate_reference),
        ("to, node-level target half", x, rotate("to", node=True), n_act, kernels.eqv2_edge_rotate,
         kernels.eqv2_edge_rotate_reference),
        ("from, n_sel 19", v, rotate("from", n_act), n_act, kernels.eqv2_edge_rotate,
         kernels.eqv2_edge_rotate_reference),
        ("from, n_sel 5", deg, rotate("from", n0), n0, kernels.eqv2_edge_rotate, kernels.eqv2_edge_rotate_reference),
        ("eqv2_gather_rotate_to", x, lambda fn, t: fn(t, nl.src, gamma, beta, lmax, mmax), n_act,
         kernels.eqv2_gather_rotate_to, kernels.eqv2_gather_rotate_to_reference),
    ]
    err, times = 0.0, {}
    for name, inp, apply, n_sel, kernel, plain in forms:
        got = apply(kernel, inp)
        torch.cuda.synchronize()
        err = max(err, check_close(f"eqv2_edge_rotate {name} x{tuple(inp.shape)} -> {tuple(got.shape)}", [got],
                                   [apply(plain, inp)]))
        ms, plain_ms = cuda_ms(lambda: apply(kernel, inp), 10), cuda_ms(lambda: apply(plain, inp), 3)
        extra = [nl.src] if kernel is kernels.eqv2_gather_rotate_to else []
        bound_ms, by, nbytes, flops = rotate_bound_ms(lmax, mmax, n_sel, [inp, gamma, beta] + extra, got)
        times[name] = (ms, plain_ms, bound_ms)
        print(f"[kernel] eqv2_edge_rotate {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{by} ({flops / 1e9:.2f} GFLOP f32, {nbytes / 1e6:.2f} MB)", flush=True)
        # the VJP: the dual rotation (then the K sum or the scatter to the sources) against autograd of the plain chain
        with torch.enable_grad():
            w = torch.randn(got.shape, generator=gen).to(device)
            dual = []
            for fn in (kernel, plain):
                leaf = inp.clone().requires_grad_(True)
                dual.append(torch.autograd.grad((apply(fn, leaf) * w).sum(), leaf)[0])
            torch.cuda.synchronize()
            err = max(err, check_close(f"eqv2_edge_rotate VJP of {name}", [dual[0]], [dual[1]]))
        del got, w, dual
    tiny_l, tiny_m = EQV2_TINY[:2]
    tiny_dim, tiny_act = (tiny_l + 1) ** 2, so3.n_act_rows(tiny_l, tiny_m)
    for lead in ((37,), (3, 11, 7)):
        g_t, b_t = (torch.rand(lead, generator=gen).to(device) * np.pi for _ in range(2))
        for direction, rows in (("to", tiny_dim), ("from", tiny_act)):
            t = torch.randn(lead + (rows, 16), generator=gen).to(device)
            args = (t, g_t, b_t, tiny_l, tiny_m)
            check_close(f"eqv2_edge_rotate {direction} ragged x{tuple(t.shape)}",
                        [kernels.eqv2_edge_rotate(*args, direction=direction)],
                        [kernels.eqv2_edge_rotate_reference(*args, direction=direction)])
    # per launch, weighted as one forward launches them: per attention the gathered source half, the target
    # half and the value rotation back; the edge-degree embedding once
    attn = model.num_layers + 2
    mix = {"eqv2_gather_rotate_to": attn, "to, node-level target half": attn, "from, n_sel 19": attn,
           "from, n_sel 5": 1}
    ms, plain_ms, bound_ms = (sum(n * times[name][i] for name, n in mix.items()) / sum(mix.values())
                              for i in range(3))
    print(f"[kernel] eqv2_edge_rotate per launch at E={gamma.numel()}, weighted {mix}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by bytes", flush=True)
    return dict(name="eqv2_edge_rotate", source="adsorbdiff_tpu_torch/csrc/eqv2_edge_rotate.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:1079", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes")


@torch.no_grad()  # the sampling path: no autograd
def eqv2_path(device, gen, systems):
    """Phases 10, 11, 12 and 13a."""
    batch = collate(systems, max_atoms=80, device=device)
    model = EquiformerV2(**EQV2_KW, device=device, generator=gen)
    score_fn = make_score_fn(model)
    static = model.prepare_static(batch)
    calls = capture_first_calls(equiformer_v2, ("eqv2_attn_conv1", "s2_grid_silu"), lambda: score_fn(batch, static))

    # 10a. s2_grid_silu at the first attention block's input, then ragged TINY shapes
    h, to_m, from_m = calls["s2_grid_silu"][0]
    s2_out, s2_err = check_s2_kernel("sampling", h, to_m, from_m)
    # ragged: column counts (M x C) that are not a multiple of a thread's 4 or a block's 512, at NC 5, 9 and 19,
    # and the older TINY leads
    for lmax, mmax in ((4, 0), (2, 2), (4, 2)):
        r_to, r_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(lmax, mmax, 18))
        for lead, c in (((1,), 3), ((37,), 16), ((129,), 5)):
            h_r = torch.randn(lead + (r_to.shape[1], c), generator=gen).to(device)
            check_s2_kernel(f"ragged NC={r_to.shape[1]}", h_r, r_to, r_from)
    tiny_to, tiny_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(*EQV2_TINY[:2], 16))
    for lead in ((37,), (3, 11, 7)):
        check_s2_kernel("ragged", torch.randn(lead + (tiny_to.shape[1], 16), generator=gen).to(device), tiny_to,
                        tiny_from)
    s2_ms = cuda_ms(lambda: kernels.s2_grid_silu(h, to_m, from_m), 20)
    s2_plain_ms = cuda_ms(lambda: kernels.s2_grid_silu_reference(h, to_m, from_m), 5)
    s2_bound, s2_by, s2_bytes, s2_flops = s2_bound_ms(h, to_m, from_m, s2_out)
    s2_plan = kernels.s2_grid_silu_plan(h.numel() // (to_m.shape[1] * h.shape[-1]), to_m.shape[1], h.shape[-1],
                                        to_m.shape[0])
    print(f"[kernel] s2_grid_silu at h{tuple(h.shape)}: {s2_ms:.4f} ms, plain {s2_plain_ms:.4f} ms, bound "
          f"{s2_bound:.4f} ms by {s2_by} ({s2_flops / 1e9:.2f} GFLOP f32, {s2_bytes / 1e6:.2f} MB), "
          f"{100 * s2_bound / s2_ms:.1f}% of the bound; plan: {s2_plan.tile} columns a block ({s2_plan.threads} "
          f"threads x 4), cluster {s2_plan.cluster}, {s2_plan.blocks} blocks, {s2_plan.smem_bytes} B shared; "
          f"ptxas: {' | '.join(ptxas_lines('s2_grid_silu')) or 'not built in this process'}", flush=True)

    # 10b. eqv2_attn_conv1 at the first attention block's inputs, then the ragged cases
    args, kw = calls["eqv2_attn_conv1"]
    c1_out, c1_err = check_conv1_kernel("sampling", args, kw)
    for name, r_args, r_kw in conv1_ragged_cases(gen, device):
        check_conv1_kernel(name, r_args, r_kw)
    c1_ms = cuda_ms(lambda: kernels.eqv2_attn_conv1(*args, **kw), 10)
    c1_plain_ms = cuda_ms(lambda: kernels.eqv2_attn_conv1_reference(*args, **kw), 3)
    c1_bound, c1_by, c1_bytes, c1_flops, c1_dense, nz_rows = conv1_bound_ms(args, kw, c1_out)
    c1_plan = conv1_plan(args, kw)
    print(f"[kernel] eqv2_attn_conv1 at E={args[0].numel()} ({int(args[1].sum())} valid edges, {nz_rows:.2f} "
          f"non-zero gaussian rows of {kw['num_gauss']} per edge): {c1_ms:.4f} ms, plain {c1_plain_ms:.4f} ms, bound "
          f"{c1_bound:.4f} ms by {c1_by} ({c1_flops / 1e9:.2f} GFLOP f32; dense {c1_dense / 1e9:.2f} GFLOP = "
          f"{c1_dense / F32_FLOPS * 1e3:.4f} ms; {c1_bytes / 1e6:.2f} MB), {100 * c1_bound / c1_ms:.1f}% of the "
          f"bound; plan: tile {c1_plan.tile} edges, cluster {c1_plan.cluster}, {c1_plan.blocks} blocks x "
          f"{c1_plan.threads} threads, {c1_plan.smem_bytes} B shared; made again (m0 gates, units' trunks) "
          f"{c1_plan.extra_flops_per_edge * args[0].numel() / 1e9:.2f} GFLOP = "
          f"{100 * c1_plan.extra_flops_per_edge * args[0].numel() / c1_flops:.1f}% of the bound's count; ptxas: "
          f"{' | '.join(ptxas_lines('eqv2_attn_conv1')) or 'not built in this process'}", flush=True)
    # 10c. eqv2_attn_conv1's wide route: trunk and embedding widths of 256 at the sampling edge count, where the
    # 64-edge plan does not fit one block's shared memory
    lmax, mmax, c, c_out, extra, r, cutoff = 4, 2, 128, 64, 576, 600, 12.0  # eqv2_so3.yml's first conv
    w_args, w_kw = conv1_inputs(gen, device, lmax, mmax, (args[0].numel(),), c, c_out, extra, r, CONV1_WIDE, cutoff)
    w_route = kernels.attn_conv1_route(CONV1_WIDE, CONV1_WIDE, c, c_out, extra, kernels.conv1_blocks(lmax, mmax))
    if w_route != "wide":
        raise AssertionError(f"eqv2_attn_conv1 at widths {CONV1_WIDE}: route {w_route}, want wide")
    before = kernels.launches["eqv2_attn_conv1"]
    w_out, w_err = check_conv1_kernel(f"wide route e_dim=hidden={CONV1_WIDE}", w_args, w_kw)
    if kernels.launches["eqv2_attn_conv1"] != before + 1:
        raise AssertionError("eqv2_attn_conv1's wide route did not count one launch")
    w_ms = cuda_ms(lambda: kernels.eqv2_attn_conv1(*w_args, **w_kw), 5)
    w_plain_ms = cuda_ms(lambda: kernels.eqv2_attn_conv1_reference(*w_args, **w_kw), 2)
    w_bound, w_by, w_bytes, w_flops, _, _ = conv1_bound_ms(w_args, w_kw, w_out)
    print(f"[kernel] eqv2_attn_conv1 wide route at E={w_args[0].numel()}, e_dim = hidden = {CONV1_WIDE}, C={c}: "
          f"{w_ms:.4f} ms, plain {w_plain_ms:.4f} ms, bound {w_bound:.4f} ms by {w_by} ({w_flops / 1e9:.2f} GFLOP "
          f"f32, {w_bytes / 1e6:.2f} MB), {100 * w_bound / w_ms:.1f}% of the bound; 16-edge tiles, "
          f"{kernels.attn_conv1_wide_smem(CONV1_WIDE, CONV1_WIDE, c, kernels.conv1_blocks(lmax, mmax))} B shared; "
          f"ptxas: {' | '.join(ptxas_lines('eqv2_attn_conv1_wide')) or 'not built in this process'}", flush=True)
    del calls, h, s2_out, c1_out, args, w_args, w_out

    # 13a. eqv2_edge_rotate in every form at the sampling graph, and its VJPs
    rot_row = check_rotations(device, gen, batch, model)

    # 11. 100-step ODE sampling at full width
    engine = DiffusionEngine(score_fn, EQV2_PARAMS, static_fn=model.prepare_static, device=device)
    DiffusionEngine(score_fn, dict(EQV2_PARAMS, num_steps=2), static_fn=model.prepare_static,
                    device=device).run(batch, generator=torch.Generator(device=device).manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    res = engine.run(batch, generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    steps = EQV2_PARAMS["num_steps"]
    per_step = model.num_layers + 2  # every block and both force heads
    want = {"s2_grid_silu": per_step * steps, "eqv2_attn_conv1": per_step * steps,
            "eqv2_edge_rotate": (1 + 3 * per_step) * steps}
    if launches != want:
        raise AssertionError(f"EquiformerV2 sampling launched {launches}, want {want} ({per_step} per step)")
    if res.traj_pos.shape != (steps + 1, 16, 80, 3) or not torch.isfinite(res.traj_pos).all():
        raise AssertionError("EquiformerV2 sampled positions are not finite or have the wrong shape")
    slab = ~batch.ads_mask
    if not torch.equal(res.batch.pos[slab], batch.pos[slab]):
        raise AssertionError("EquiformerV2 sampling moved slab atoms")
    print(f"[eqv2] {steps}-step ODE sampling, B=16 x 80 atoms, eqv2_so3.yml widths: {wall:.3f} s wall, "
          f"{steps * batch.batch_size / wall:.2f} system-steps/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated, launches {launches}, "
          f"converged_at {int(res.converged_at)}", flush=True)
    forward_ms = cuda_ms(lambda: score_fn(batch, static), 5)
    kernel_ms = per_step * (c1_ms + s2_ms) + (1 + 3 * per_step) * rot_row["ms"]
    print(f"[eqv2] one score forward (graph + {model.num_layers} blocks + 2 heads): {forward_ms:.3f} ms; {per_step} "
          f"launches each of eqv2_attn_conv1 and s2_grid_silu at {c1_ms:.4f} + {s2_ms:.4f} ms and {1 + 3 * per_step} "
          f"of eqv2_edge_rotate at {rot_row['ms']:.4f} ms = {100 * kernel_ms / forward_ms:.1f}% of it", flush=True)

    # 12. card vs CPU, whole model at B=2
    small = collate(systems[:2], max_atoms=80, device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        card = model(small)
        host = cpu_model(small.to("cpu"))
    check_model("EquiformerV2", zip(("force_block", "force_block2"), card, host))
    del cpu_model, card, host
    rot_row["launches"] = launches["eqv2_edge_rotate"]
    return [
        dict(name="s2_grid_silu", source="adsorbdiff_tpu_torch/csrc/s2_grid_silu.cu",
             replaces="adsorbdiff_tpu/ops/pallas_kernels.py:903", launches=launches["s2_grid_silu"],
             max_abs_err=s2_err, ms=s2_ms, plain_ms=s2_plain_ms, bound_ms=s2_bound, bound_by=s2_by),
        dict(name="eqv2_attn_conv1", source="adsorbdiff_tpu_torch/csrc/eqv2_attn_conv1.cu",
             replaces="adsorbdiff_tpu/ops/pallas_kernels.py:1252", launches=launches["eqv2_attn_conv1"],
             max_abs_err=c1_err, ms=c1_ms, plain_ms=c1_plain_ms, bound_ms=c1_bound, bound_by=c1_by),
        rot_row,
    ]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def sampling_path(device, gen, systems):
    """Phases 3 (painn_message_fused), 4 and 5."""
    batch = collate(systems, max_atoms=80, device=device)
    model = PaiNN(**MODEL_KW, device=device, generator=gen)
    nl, _, unit = generate_graph(batch, cutoff=model.cutoff, max_neighbors=model.max_neighbors,
                                 cell_reps=model.cell_reps)
    main_shape = (16, 80, model.max_neighbors, 128, model.hidden_channels)
    inputs, outputs, err = check_message_kernel(device, gen, main_shape, model.cutoff, nl=nl, unit=unit)
    # ragged: two older shapes; the training shape; N = 300 and N = 1200 (rows read through L1/L2); an all-masked
    # system; sources outside [0, N); unmasked slots past the cutoff; H = 200; R = 16; the bench graph's slots in
    # random order within every target
    for ragged, fill in (((2, 13, 10, 16, 64), None), ((1, 37, 45, 128, 192), None), ((48, 80, 50, 128, 512), None),
                         ((9, 300, 20, 128, 512), None), ((1, 1200, 20, 128, 64), None),
                         ((3, 80, 50, 128, 96), "masked-system"), ((2, 80, 50, 128, 64), "bad-src"),
                         ((2, 80, 50, 128, 64), "past-cutoff"), ((2, 80, 50, 128, 200), None),
                         ((2, 80, 50, 16, 512), None)):
        check_message_kernel(device, gen, ragged, 6.0, fill=fill)
    table, shuffled_unit = shuffled_slots(nl, unit, 11)
    check_message_kernel(device, gen, main_shape, model.cutoff, nl=table, unit=shuffled_unit,
                         what=" (bench graph, slots shuffled)")
    ms = cuda_ms(lambda: kernels.painn_message_fused(**inputs, cutoff=model.cutoff), 20)
    plain_ms = cuda_ms(lambda: kernels.painn_message_fused_reference(**inputs, cutoff=model.cutoff), 5)
    bound_ms, bound_by, nbytes, flops = message_bound_ms(inputs, outputs, model.cutoff)
    edges, rows = basis_rows(inputs, model.cutoff)
    print(f"[kernel] painn_message_fused at {main_shape} ({edges} valid edges, {rows / edges:.2f} non-zero basis "
          f"values each; the 8-slot windows run {window_ratio(inputs, model.cutoff):.3f}x them): {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP f32, "
          f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; "
          f"{fwd_plan_line(kernels.painn_fwd_plan(*main_shape, kernels._sm_count(device)))}; ptxas: "
          f"{' | '.join(ptxas_lines('painn_message_fused')) or 'not built in this process'}", flush=True)
    del inputs, outputs

    # 4. 100-step ODE sampling at full width
    engine = DiffusionEngine(make_score_fn(model), PARAMS, static_fn=model.prepare_static, device=device)
    DiffusionEngine(make_score_fn(model), dict(PARAMS, num_steps=2), static_fn=model.prepare_static,
                    device=device).run(batch, generator=torch.Generator(device=device).manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    res = engine.run(batch, generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    want_launches = model.num_layers * PARAMS["num_steps"]
    if launches != {"painn_message_fused": want_launches}:
        raise AssertionError(f"sampling path launched {launches}, want painn_message_fused x{want_launches}")
    if res.traj_pos.shape != (PARAMS["num_steps"] + 1, 16, 80, 3) or not torch.isfinite(res.traj_pos).all():
        raise AssertionError("sampled positions are not finite or have the wrong shape")
    slab = ~batch.ads_mask
    if not torch.equal(res.batch.pos[slab], batch.pos[slab]):
        raise AssertionError("sampling moved slab atoms")
    steps_per_s = PARAMS["num_steps"] * batch.batch_size / wall
    print(f"[sample] 100-step ODE sampling, B=16 x 80 atoms: {wall:.3f} s wall, {steps_per_s:.1f} system-steps/s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated, launches {launches}, "
          f"converged_at {int(res.converged_at)}", flush=True)
    score_fn = make_score_fn(model)
    static = model.prepare_static(batch)
    forward_ms = cuda_ms(lambda: score_fn(batch, static), 10)
    print(f"[sample] one score forward (graph + 6 layers + heads): {forward_ms:.3f} ms; "
          f"6 kernel launches at {ms:.4f} ms = {100 * 6 * ms / forward_ms:.1f}% of it", flush=True)

    # 5. card vs CPU, whole model at B=2, with what tells a host fault from a machine-dependent CPU path. The
    # reference is the output that two CPU forwards on equal inputs give bit for bit (ROADMAP C.1).
    small = collate(systems[:2], max_atoms=80, device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    inputs = [small.to("cpu") for _ in range(CPU_FORWARDS)]
    with torch.no_grad():
        card = model(small)
        runs = [traced_forward(cpu_model, b) for b in inputs]
    host = repeated_cpu_reference("PaiNN B=2", inputs, runs)
    painn_diagnostics(model, small, card, host)
    check_model("PaiNN", zip(("out_forces", "out_forces2"), card, host))
    return dict(name="painn_message_fused", source="adsorbdiff_tpu_torch/csrc/painn_message_fused.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:336",
                launches=launches["painn_message_fused"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def traced_forward(module, batch):
    """``module(batch)`` with every submodule's output, the squared distances
    the neighbour search sorts (each ``pbc._smallest_k`` input, and the
    values and indices it keeps), and the neighbour table the first message
    layer receives (src, cell offsets, vec, dist, mask), recorded in call
    order: where two runs part, the first record that differs names the
    step."""
    trace, handles = [], []
    smallest_k = pbc._smallest_k

    def sort_input(d2, k):
        trace.append(("neighbours.d2", d2.clone()))
        vals, idx = smallest_k(d2, k)
        trace.extend((("neighbours.d2_top", vals.clone()), ("neighbours.idx", idx.clone())))
        return vals, idx

    def graph(_, args):
        trace.extend((f"graph.{f}", getattr(args[2], f).clone()) for f in ("src", "cell_offsets", "vec", "dist", "mask"))

    def hook(name):
        def record(_, args, out):
            trace.append((name, (out[0] if isinstance(out, tuple) else out).clone()))
        return record

    for name, mod in module.named_modules():
        if name:
            handles.append(mod.register_forward_hook(hook(name)))
        if name == "message_layers.0":
            handles.append(mod.register_forward_pre_hook(graph))
    pbc._smallest_k = sort_input
    try:
        return module(batch), trace
    finally:
        pbc._smallest_k = smallest_k
        for h in handles:
            h.remove()


def host_cpu():
    """The host's CPU (model name, else vendor, family and model numbers, as
    /proc/cpuinfo gives them), torch's CPU capability and its intra-op thread
    count: what tells the hosts of two phase-5 runs apart."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError as e:
        fields["error"] = f"/proc/cpuinfo unreadable ({e.strerror})"
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping", "error") if k in fields)
    return (f"host CPU {model or platform.processor() or 'unknown'!r}, torch CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads")


def repeated_cpu_reference(what, inputs, runs):
    """The CPU reference of a card-vs-CPU check: the outputs that two of the
    CPU forwards ``runs`` (``(outputs, trace)`` of :func:`traced_forward`) on
    the equal ``inputs`` give bit for bit.  Prints each forward against the
    first, with the first of its records that differ (the step where it
    parts) and the host's CPU; raises when no two forwards agree."""
    cpu = host_cpu()
    same_inputs = all(torch.equal(getattr(inputs[0], f.name), getattr(b, f.name))
                      for b in inputs[1:] for f in dataclasses.fields(b) if getattr(b, f.name) is not None)

    def differ(i, j):
        (out_i, trace_i), (out_j, trace_j) = runs[i], runs[j]
        pairs = list(zip(trace_i, trace_j)) + [((f"output {k}", a), (f"output {k}", b))
                                               for k, (a, b) in enumerate(zip(out_i, out_j))]
        return [(name, (a.float() - b.float()).abs().max().item()) for (name, a), (_, b) in pairs
                if not torch.equal(a, b)]

    for i in range(1, len(runs)):
        d = differ(0, i)
        print(f"[check] {what} CPU forward {i + 1} vs 1: inputs equal {same_inputs}; {len(d)} of "
              f"{len(runs[0][1]) + len(runs[0][0])} recorded outputs differ"
              + (f", the first {d[:3]}" if d else "") + f"; {cpu}", flush=True)
    agree = next(((i, j) for i in range(len(runs)) for j in range(i + 1, len(runs)) if not differ(i, j)), None)
    if agree is None:
        raise AssertionError(f"{what}: no two of {len(runs)} CPU forwards on equal inputs agree; {cpu}")
    apart = [k + 1 for k in range(len(runs)) if differ(agree[0], k)]
    if apart:
        print(f"[host] {what}: CPU forward(s) {apart} part from forwards {agree[0] + 1} and {agree[1] + 1}, which "
              f"agree bit for bit and are the reference: the host fault of ROADMAP C.1; {cpu}", flush=True)
    return runs[agree[0]][0]


def painn_diagnostics(model, small, card, host):
    """Phase 5's evidence, printed before its check: both sides' max |output|
    and whether the card's and the CPU's B=2 neighbour tables agree exactly
    (and where not, how many slots differ and the largest distance among
    them)."""
    for name, c, h in zip(("out_forces", "out_forces2"), card, host):
        print(f"[check] PaiNN B=2 {name}: max |card| {c.abs().max().item():.6f}, max |cpu| "
              f"{h.abs().max().item():.6f}", flush=True)
    kw = dict(cutoff=model.cutoff, max_neighbors=model.max_neighbors, cell_reps=model.cell_reps)
    nl_card = generate_graph(small, **kw)[0]
    nl_cpu = generate_graph(small.to("cpu"), **kw)[0]
    src, mask = nl_card.src.cpu(), nl_card.mask.cpu()
    same_src, same_mask = torch.equal(src, nl_cpu.src), torch.equal(mask, nl_cpu.mask)
    line = f"[check] PaiNN B=2 neighbour tables card vs CPU: src equal {same_src}, mask equal {same_mask}"
    if not (same_src and same_mask):
        differ = (src != nl_cpu.src) | (mask != nl_cpu.mask)
        far = torch.maximum(nl_card.dist.cpu()[differ], nl_cpu.dist[differ]).max().item()
        line += f"; {int(differ.sum())} slots differ, the largest distance among them {far:.6f} A"
    print(line, flush=True)


def check_model(model_name, pairs):
    """Card against CPU outputs: finite and within 1e-4 * max|cpu|."""
    for name, c, h in pairs:
        h = h.to(c.device)
        e = (c - h).abs().max().item()
        limit = MODEL_RTOL * h.abs().max().item()
        if not (torch.isfinite(c).all() and e <= limit):
            raise AssertionError(f"card vs CPU {model_name} {name}: max |diff| {e} > {limit}")
        print(f"[check] card vs CPU {model_name} {name}: max |diff| {e:.3e} "
              f"(limit {MODEL_RTOL} * max|reference| = {limit:.3e})", flush=True)


def gemnet_launches(model, forwards):
    """What ``forwards`` GemNet-OC forwards launch: one quad chain per block
    and the three triplet bases (e2e, a2e, e2a)."""
    return {"gemnet_quad_chain": model.num_blocks * forwards, "masked_legendre_cos": 3 * forwards}


def relax_path(device, gen, systems):
    """Phases 3 (gemnet_quad_chain, masked_legendre_cos), 6 and 7."""
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], GEMNET_KW["cutoff"])
    batch = collate(systems, max_atoms=80, device=device)
    model = GemNetOC(**GEMNET_KW, cell_reps=cell_reps, device=device, generator=gen)
    b, n = batch.batch_size, batch.max_atoms
    s = model.num_spherical
    shape = (b, n, model.max_neighbors, model.max_neighbors_qint, model.max_neighbors, s, model.emb_size_quad_in,
             model.emb_size_sbf)
    inputs, out, err = check_quad_kernel(device, gen, shape)
    # ragged: an older shape; two passes of 32 columns e and f; two level passes; 4-byte copies into padded rows;
    # every main key -1 (exact zeros); one main edge a cell; a cell's main edges over two blocks
    for ragged, negative_keys in (((2, 7, 12, 4, 13, 4, 8, 8), 3), ((2, 3, 7, 4, 13, 7, 40, 48), 3),
                                  ((1, 3, 9, 5, 11, 9, 40, 48), 3), ((2, 4, 10, 3, 7, 5, 12, 9), 3),
                                  ((2, 5, 30, 8, 30, 7, 32, 32), 30), ((2, 5, 1, 8, 30, 7, 32, 32), 0),
                                  ((1, 1, 16, 8, 30, 7, 32, 32), 3)):
        check_quad_kernel(device, gen, ragged, negative_keys)
    ms = cuda_ms(lambda: kernels.gemnet_quad_chain(**inputs, num_spherical=s), 20)
    plain_ms = cuda_ms(lambda: kernels.gemnet_quad_chain_reference(**inputs, num_spherical=s), 5)
    bound_ms, bound_by, nbytes, flops = quad_bound_ms(inputs, out, s)
    print(f"[kernel] gemnet_quad_chain at {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({flops / 1e9:.2f} GFLOP f32 = {flops / F32_FLOPS * 1e3:.4f} ms, {nbytes / 1e6:.2f} MB = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), {100 * bound_ms / ms:.1f}% of the bound; "
          f"{quad_plan_line(kernels.quad_chain_plan(b * n, *shape[2:], kernels._sm_count(device)))}; ptxas: "
          f"{' | '.join(ptxas_lines('gemnet_quad_chain')) or 'not built in this process'}", flush=True)
    del inputs, out
    legendre_row = legendre_checks(device, gen, model, batch)

    # 6. 100 L-BFGS steps at full width
    print(f"[relax] GemNet-OC gemnet_relax.yml widths, cell_reps {cell_reps} (auto_cell_reps), "
          f"B={b} x {n} atoms, relax_opt {RELAX_OPT}", flush=True)
    RelaxationEngine.from_model(model, dict(RELAX_OPT, steps=2), device=device).run(batch)  # warm-up
    engine = RelaxationEngine.from_model(model, RELAX_OPT, device=device)
    forwards = 0
    energy_forces = engine.energy_forces_fn

    def counted(*args):
        nonlocal forwards
        forwards += 1
        return energy_forces(*args)

    engine.energy_forces_fn = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    res = engine.run(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    want_launches = gemnet_launches(model, forwards)
    if launches != want_launches:
        raise AssertionError(f"relaxation path launched {launches}, want {want_launches} ({forwards} forwards)")
    for name in ("traj_pos", "traj_energy", "traj_forces", "energy", "forces"):
        if not torch.isfinite(getattr(res, name)).all():
            raise AssertionError(f"relaxation {name} is not finite")
    if res.traj_pos.shape != (RELAX_OPT["steps"] + 1, b, n, 3):
        raise AssertionError(f"relaxation trajectory has shape {tuple(res.traj_pos.shape)}")
    fixed = batch.fixed & batch.atom_mask
    if not (bool(fixed.any()) and torch.equal(res.traj_pos[:, fixed], batch.pos[fixed].expand(len(res.traj_pos), -1, -1))):
        raise AssertionError("relaxation moved fixed atoms")
    if not torch.equal(res.traj_pos[-1], res.batch.pos):
        raise AssertionError("the last trajectory frame is not the final state")
    moved = (res.batch.pos - batch.pos).norm(dim=-1).amax().item()
    print(f"[relax] {res.nsteps} L-BFGS steps, B={b}: {wall:.3f} s wall, {res.nsteps * b / wall:.2f} relax "
          f"system-steps/s, peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated, "
          f"{forwards} model forwards, launches {launches}, {res.rebuilds} Verlet rebuilds, "
          f"{int(res.converged.sum())}/{b} converged, largest move {moved:.3f} A", flush=True)
    fn = make_mlff_energy_forces(model)
    cand = model.prepare_candidates(batch, RELAX_OPT["k_cand"])
    forward_ms = cuda_ms(lambda: fn(batch, cand), 5)
    kernel_ms = model.num_blocks * ms + 3 * legendre_row["ms"]
    print(f"[relax] one model forward (Verlet refresh + 4 blocks + heads): {forward_ms:.3f} ms; "
          f"{model.num_blocks} gemnet_quad_chain launches at {ms:.4f} ms and 3 masked_legendre_cos at "
          f"{legendre_row['ms']:.4f} ms = {100 * kernel_ms / forward_ms:.1f}% of it", flush=True)

    # 7. card vs CPU, whole model at B=2
    small = collate(systems[:2], max_atoms=80, device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        card = model(small)
        host = cpu_model(small.to("cpu"))
    check_model("GemNet-OC", ((name, card[name], host[name]) for name in ("energy", "forces")))
    legendre_row["launches"] = launches["masked_legendre_cos"]
    return [dict(name="gemnet_quad_chain", source="adsorbdiff_tpu_torch/csrc/gemnet_quad_chain.cu",
                 replaces="adsorbdiff_tpu/ops/pallas_kernels.py:1728",
                 launches=launches["gemnet_quad_chain"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by),
            legendre_row]


def write_training_shards(root, systems_per_split):
    """bench systems (pos_relaxed = pos) in one shard per split."""
    systems = bench_systems(sum(systems_per_split.values()))
    paths, start = {}, 0
    for split, count in systems_per_split.items():
        write_shard(os.path.join(root, split), systems[start:start + count])
        paths[split] = os.path.join(root, split + ".adshard.npz")
        start += count
    return paths


def check_grads(what, pairs):
    """Every (name, got, want) within 1e-3 * max|want| and finite; returns
    the worst max|diff| / max|want|."""
    worst = 0.0
    for name, c, h in pairs:
        e, limit = (c - h).abs().max().item(), GRAD_RTOL * h.abs().max().item()
        if not (torch.isfinite(c).all() and e <= limit):
            raise AssertionError(f"{what}, {name}: max |diff| {e} > {limit}")
        worst = max(worst, e / max(h.abs().max().item(), 1e-30))
    return worst


def check_training_step(config, device, model_name):
    """One training step at B=2 on the card against the same step on the
    CPU: loss, grad_norm and every parameter's gradient."""
    small = dict(copy.deepcopy(config), optim=dict(config["optim"], batch_size=2, eval_batch_size=2))
    card, host = DenoisingTrainer(small, device=device), DenoisingTrainer(dict(small, cpu=True))
    two = collate(bench_systems(2), max_atoms=80, device="cpu")
    draws = draw_schedule(2, torch.device("cpu"), torch.Generator().manual_seed(6))
    results = []
    for tr, b in ((card, two.to(device)), (host, two)):
        tr.init_state()
        loss, aux = tr._loss_and_aux(b, draws._replace(**{k: getattr(draws, k).to(b.device) for k in draws._fields}),
                                     None)
        grads = torch.autograd.grad(loss, tr.params)
        results.append((tr._finalize_train_step(loss, aux, list(grads)), [g.cpu() for g in grads]))
    (card_aux, card_grads), (host_aux, host_grads) = results
    names = [n for n, _ in host.model.named_parameters()]
    worst = check_grads(f"card vs CPU {model_name} training step", [
        ("loss", card_aux["loss"].cpu()[None], host_aux["loss"][None]),
        ("grad_norm", card_aux["grad_norm"].cpu()[None], host_aux["grad_norm"][None]),
    ] + list(zip(names, card_grads, host_grads)))
    print(f"[check] card vs CPU {model_name} training step at B=2: loss {card_aux['loss'].item():.6f} / "
          f"{host_aux['loss'].item():.6f}, grad_norm {card_aux['grad_norm'].item():.6f} / "
          f"{host_aux['grad_norm'].item():.6f}; {len(names)} gradients, worst max|diff| / max|cpu| {worst:.3e} "
          f"(limit {GRAD_RTOL})", flush=True)


def train_one_epoch(trainer, steps, want):
    """trainer.train() with the launch counts zeroed just before and read at
    every step (each step must launch exactly ``want``, and the epoch nothing
    besides); every loss finite, params and EMA moved, EMA != params.
    Returns the epoch's launches."""
    p0 = [p.detach().clone() for p in trainer.params]
    step_fn, per_step, losses, times = trainer.train_step, [], [], []

    def counted(*args, **kwargs):
        before = dict(kernels.launches)
        aux = step_fn(*args, **kwargs)
        per_step.append({k: kernels.launches[k] - before.get(k, 0) for k in kernels.launches
                         if kernels.launches[k] != before.get(k, 0)})
        losses.append(aux["loss"])
        if len(per_step) == 1:  # the timed window opens after the first step
            torch.cuda.synchronize()
            times.append(time.perf_counter())
        return aux

    trainer.train_step = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - times[0]
    del trainer.train_step
    launches = path_launches()
    if len(per_step) != steps or any(s != want for s in per_step) or launches != {k: steps * v for k, v in
                                                                               want.items()}:
        raise AssertionError(f"training launched {per_step} ({launches} in all), want {want} in each of {steps} "
                             f"steps and nothing else")
    loss = torch.stack(losses).cpu()
    if not torch.isfinite(loss).all():
        raise AssertionError(f"non-finite training losses: {loss.tolist()}")
    moved = max((p - q).abs().max().item() for p, q in zip(trainer.params, p0))
    ema_moved = max((e - q).abs().max().item() for e, q in zip(trainer.ema, p0))
    ema_gap = max((e - p).abs().max().item() for e, p in zip(trainer.ema, trainer.params))
    if not (moved > 0 and ema_moved > 0 and ema_gap > 0):
        raise AssertionError(f"params moved {moved}, EMA moved {ema_moved}, |EMA - params| {ema_gap}")
    batch = trainer.optim_cfg["batch_size"]
    rate = (steps - 1) * batch / wall
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[train] {steps} steps, B={batch} x 80 atoms: {rate:.2f} systems/s over the {steps - 1} steps after "
          f"the first ({wall:.3f} s, {1e3 * wall / (steps - 1):.2f} ms per step), peak {peak:.1f} MiB allocated, "
          f"launches {launches}; loss {loss[0].item():.4f} -> {loss[-1].item():.4f}; max |param move| {moved:.3e}, "
          f"|EMA move| {ema_moved:.3e}, |EMA - params| {ema_gap:.3e}", flush=True)
    val = trainer.validate("val")["loss"]["metric"]
    if not np.isfinite(val):
        raise AssertionError(f"validation loss {val}")
    print(f"[train] validation loss (EMA weights) {val:.4f}", flush=True)
    return launches


def training_path(device, gen, root):
    """Phases 8 and 9."""
    paths = write_training_shards(root, {"train": TRAIN_BATCH * TRAIN_STEPS, "val": TRAIN_BATCH})
    config = dict(copy.deepcopy(TRAIN_CONFIG), run_dir=root,
                  dataset=[{"src": paths["train"]}, {"src": paths["val"]}])
    trainer = DenoisingTrainer(config, device=device)
    model = trainer.model
    print(f"[train] painn_so3.yml + base.yml, cell_reps {tuple(model.cell_reps)} (auto), B={TRAIN_BATCH}, "
          f"{len(trainer.train_batcher)} steps", flush=True)

    # 8a. the backward kernel at the training shape, on a noised batch's live neighbour table
    batch = next(iter(trainer.train_batcher)).to(device)
    batch = batch.replace(pos=batch.pos_relaxed)
    noised, _ = trainer.schedule_fn(batch, trainer.denoising_pos_params, torch.Generator(device=device).manual_seed(4))
    nl, _, unit = generate_graph(noised, cutoff=model.cutoff, max_neighbors=model.max_neighbors,
                                 cell_reps=model.cell_reps)
    shape = (TRAIN_BATCH, 80, model.max_neighbors, 128, model.hidden_channels)
    inputs, cts, outputs, err = check_message_bwd_kernel(device, gen, shape, model.cutoff, nl=nl, unit=unit)
    # ragged: the older shapes; N = 300 (narrower slices) and N = 1200 (global atomics for the scatter); B = 5
    # (16-column slices to fill a wave); an all-masked system; sources outside [0, N); H = 200, not a multiple of 32
    for ragged, fill in (((2, 13, 10, 16, 64), None), ((1, 37, 45, 128, 192), None), ((9, 300, 20, 128, 512), None),
                         ((1, 1200, 20, 128, 64), None), ((5, 80, 50, 128, 512), None),
                         ((3, 80, 50, 128, 96), "masked-system"), ((2, 80, 50, 128, 64), "bad-src"),
                         ((2, 80, 50, 128, 200), None)):
        check_message_bwd_kernel(device, gen, ragged, 6.0, fill=fill)
    bwd = lambda: kernels.painn_message_fused_bwd(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=model.cutoff)  # noqa: E731
    ms = cuda_ms(bwd, 10)
    plain_ms = cuda_ms(lambda: kernels.painn_message_fused_bwd_reference(
        **inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=model.cutoff), 2)
    fwd = kernels.painn_message_fused(**inputs, cutoff=model.cutoff)
    torch.cuda.synchronize()
    check_close(f"painn_message_fused at the training shape {shape} (live table)", fwd,
                kernels.painn_message_fused_reference(**inputs, cutoff=model.cutoff))
    fwd_ms = cuda_ms(lambda: kernels.painn_message_fused(**inputs, cutoff=model.cutoff), 10)
    fwd_bound_ms, fwd_bound_by, _, fwd_flops = message_bound_ms(inputs, fwd, model.cutoff)
    del fwd
    bound_ms, bound_by, nbytes, flops = message_bwd_bound_ms(inputs, cts, outputs, model.cutoff)
    edges, rows = basis_rows(inputs, model.cutoff)
    plan = kernels.painn_bwd_plan(*shape, kernels._sm_count(device))
    print(f"[kernel] painn_message_fused_bwd at {shape} ({edges} valid edges, {rows / edges:.2f} non-zero basis "
          f"values each): {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP f32, "
          f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; the forward kernel at the same shape "
          f"{fwd_ms:.4f} ms, bound {fwd_bound_ms:.4f} ms by {fwd_bound_by} ({fwd_flops / 1e9:.2f} GFLOP f32), "
          f"{100 * fwd_bound_ms / fwd_ms:.1f}% of it; {bwd_plan_line(plan)}; ptxas: "
          f"{' | '.join(ptxas_lines('painn_message_fused_bwd')) or 'not built in this process'}", flush=True)
    del inputs, cts, outputs

    # 8b. one epoch of DenoisingTrainer.train(); counts zeroed just before, read at every step
    launches = train_one_epoch(trainer, TRAIN_STEPS, {"painn_message_fused": model.num_layers,
                                                      "painn_message_fused_bwd": model.num_layers})

    # 9. card vs CPU, one training step at B=2
    check_training_step(config, device, "PaiNN")
    return dict(name="painn_message_fused_bwd", source="adsorbdiff_tpu_torch/csrc/painn_message_fused_bwd.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:566",
                launches=launches["painn_message_fused_bwd"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def eqv2_training_path(device, gen, root):
    """Phases 13b, 14 and 15."""
    paths = write_training_shards(root, {"train": EQV2_TRAIN_BATCH * EQV2_TRAIN_STEPS, "val": EQV2_EVAL_BATCH})
    config = dict(copy.deepcopy(EQV2_TRAIN_CONFIG), run_dir=root, dataset=[{"src": paths["train"]}, {"src": paths["val"]}])
    trainer = DenoisingTrainer(config, device=device)
    model = trainer.model
    per_step = model.num_layers + 2
    print(f"[eqv2-train] eqv2_so3.yml + base.yml, cell_reps {tuple(model.cell_reps)} (auto), B={EQV2_TRAIN_BATCH}, "
          f"{len(trainer.train_batcher)} steps", flush=True)

    # 13b. s2_grid_silu_bwd at the first attention block's input of a training forward, then ragged TINY shapes
    batch = next(iter(trainer.train_batcher)).to(device)
    batch = batch.replace(pos=batch.pos_relaxed)
    noised, _ = trainer.schedule_fn(batch, trainer.denoising_pos_params, torch.Generator(device=device).manual_seed(4))
    with torch.no_grad():
        calls = capture_first_calls(equiformer_v2, ("s2_grid_silu", "eqv2_attn_conv1"), lambda: model(noised))
    h, to_m, from_m = calls["s2_grid_silu"][0]
    dy = torch.randn(h.shape, generator=gen).to(device)

    def check_s2_bwd(name, h, dy, to_m, from_m):
        got = kernels.s2_grid_silu_bwd(h, dy, to_m, from_m)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"s2_grid_silu_bwd {name}: non-finite output")
        return got, check_close(f"s2_grid_silu_bwd {name} h{tuple(h.shape)}", [got],
                                [kernels.s2_grid_silu_bwd_reference(h, dy, to_m, from_m)])

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    out, s2b_err = check_s2_bwd("training", h, dy, to_m, from_m)
    if not torch.equal(kernels.s2_grid_silu_bwd(h, dy, to_m, from_m), out):
        raise AssertionError("s2_grid_silu_bwd does not repeat bit for bit")
    tiny_to, tiny_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(*EQV2_TINY[:2], 16))
    for lead in ((37,), (3, 11, 7)):
        shape = lead + (tiny_to.shape[1], 16)
        check_s2_bwd("ragged", randn(*shape), randn(*shape), tiny_to, tiny_from)
    # column counts (M x C) that are not a multiple of a thread's 2 or a block's 256, at NC 5, 9 and 19
    for lmax, mmax in ((4, 0), (2, 2), (4, 2)):
        r_to, r_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(lmax, mmax, 18))
        for lead, c in (((1,), 3), ((37,), 16), ((129,), 5)):
            shape = lead + (r_to.shape[1], c)
            check_s2_bwd(f"ragged NC={r_to.shape[1]}", randn(*shape), randn(*shape), r_to, r_from)
    check_s2_bwd("random NC=32 tables", randn(3, 37, 32, 16), randn(3, 37, 32, 16), randn(324, 32) / 32 ** 0.5,
                 randn(32, 324) / 32 ** 0.5)
    h_large = randn(2, 40, *h.shape[-2:])
    h_large *= 100.0 / (to_m @ h_large).abs().max()  # max |g| = 100: e^-g overflows where g < -88.7
    check_s2_bwd("max |g| 100", h_large, randn(*h_large.shape), to_m, from_m)
    s2b_ms = cuda_ms(lambda: kernels.s2_grid_silu_bwd(h, dy, to_m, from_m), 20)
    s2b_plain_ms = cuda_ms(lambda: kernels.s2_grid_silu_bwd_reference(h, dy, to_m, from_m), 5)
    s2b_bound, s2b_by, s2b_bytes, s2b_flops = s2_bwd_bound_ms(h, dy, to_m, from_m, out)
    nc, c = h.shape[-2:]
    m = h.numel() // (nc * c)
    s2b_plan = kernels.s2_grid_silu_bwd_plan(m, nc, c, to_m.shape[0], kernels._sm_count(device))
    print(f"[kernel] s2_grid_silu_bwd at h{tuple(h.shape)}: {s2b_ms:.4f} ms, plain {s2b_plain_ms:.4f} ms, bound "
          f"{s2b_bound:.4f} ms by {s2b_by} ({s2b_flops / 1e9:.2f} GFLOP f32, {s2b_bytes / 1e6:.2f} MB), "
          f"{100 * s2b_bound / s2b_ms:.1f}% of the bound; plan: {s2b_plan.blocks} persistent blocks of "
          f"{s2b_plan.threads} threads x 2 columns over {-(-m * c // s2b_plan.tile)} groups of {s2b_plan.tile} "
          f"columns, {s2b_plan.smem_bytes} B shared; ptxas (NC = {nc}): "
          f"{' | '.join(ptxas_lines('s2_grid_silu_bwd', f'ILi{nc}E')) or 'not built in this process'}", flush=True)

    # the conv1 VJP: a plain recompute (the TPU kernel has no backward body either), timed at this shape
    args, kw = calls["eqv2_attn_conv1"]
    dist, mask, *edge_inputs = (t.detach().clone() for t in args[:6])
    edge_inputs = [t.requires_grad_(True) for t in edge_inputs]
    trees = [{m: {k: v.detach().clone().requires_grad_(True) for k, v in mod.items()} for m, mod in tree.items()}
             for tree in args[6:]]
    leaves = edge_inputs + [v for tree in trees for mod in tree.values() for v in mod.values()]
    outs = kernels.eqv2_attn_conv1(dist, mask, *edge_inputs, *trees, **kw)
    cts = [torch.randn(o.shape, generator=gen).to(device) for o in outs]
    vjp_ms = cuda_ms(lambda: torch.autograd.grad(outs, leaves, cts, retain_graph=True), 3)
    print(f"[kernel] eqv2_attn_conv1 VJP (plain recompute under autograd) at E={dist.numel()}: {vjp_ms:.4f} ms",
          flush=True)
    del calls, h, dy, out, args, outs, cts, leaves, edge_inputs, trees, noised

    # 14. one epoch of DenoisingTrainer.train(); counts zeroed just before, read at every step
    want = {"s2_grid_silu": per_step, "eqv2_attn_conv1": per_step, "s2_grid_silu_bwd": per_step,
            "eqv2_edge_rotate": 2 * (1 + 3 * per_step)}
    launches = train_one_epoch(trainer, EQV2_TRAIN_STEPS, want)

    # 15. card vs CPU, one training step at B=2
    check_training_step(config, device, "EquiformerV2")
    return dict(name="s2_grid_silu_bwd", source="adsorbdiff_tpu_torch/csrc/s2_grid_silu_bwd.cu",
               replaces="adsorbdiff_tpu/ops/pallas_kernels.py:919", launches=launches["s2_grid_silu_bwd"],
               max_abs_err=s2b_err, ms=s2b_ms, plain_ms=s2b_plain_ms, bound_ms=s2b_bound, bound_by=s2b_by)


class GemNetRelaxer:
    """The relax trainer as run_pipeline uses it (S2EF training is not ported
    yet): a GemNet-OC's energies, denormalised by gemnet_relax.yml's
    target_mean/target_std, its forces, and its Verlet candidate tables."""

    def __init__(self, model):
        self.model = model
        self.forwards = 0
        fn = make_mlff_energy_forces(model)

        def energy_forces_fn(batch, static_graph=None):
            self.forwards += 1
            energy, forces = fn(batch, static_graph)
            return energy * GEMNET_TARGET_STD + GEMNET_TARGET_MEAN, forces

        self.energy_forces_fn = energy_forces_fn

    def relax_candidate_fn(self, relax_opt=None):
        return candidate_fn_for(self.model, relax_opt)


def timed_calls(owner, name, record):
    """Wrap ``owner.<name>`` so that each call appends (name, start, end,
    result, launch counts at its start, its first argument) to ``record``,
    the card synchronised on both sides; returns the original."""
    original = getattr(owner, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        t = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((name, t, time.perf_counter(), out, counts, args[0]))
        return out

    setattr(owner, name, timed)
    return original


def pipeline_path(device, gen, systems, root):
    """Phase 16: run_pipeline once, sample -> convert -> relax -> score."""
    write_shard(os.path.join(root, "relax_input"), systems)
    sampler_cfg = dict(copy.deepcopy(TRAIN_CONFIG), run_dir=root, identifier="smoke_pipeline", logger=None,
                       model=dict(TRAIN_CONFIG["model"], cell_reps=MODEL_KW["cell_reps"],
                                  max_ads=MODEL_KW["max_ads"]))
    sampler = DenoisingTrainer(sampler_cfg, device=device)
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], GEMNET_KW["cutoff"])
    relaxer = GemNetRelaxer(GemNetOC(**GEMNET_KW, cell_reps=cell_reps, device=device, generator=gen))
    rng = np.random.default_rng(11)
    dft = {str(s.sid): float(rng.normal(-1.0, 1.0)) for s in systems}  # synthetic DFT minima, one per sid
    out_dir = os.path.join(root, "out")
    print(f"[pipeline] sampler painn_so3.yml widths, {PARAMS['num_steps']} ODE steps, B={len(systems)}; relaxer "
          f"GemNet-OC gemnet_relax.yml widths, cell_reps {cell_reps}; relax_opt {PIPELINE_RELAX_OPT}, "
          f"{PIPELINE_STEPS} steps, fmax 0.01; {len(systems)} bench systems, nsites 1", flush=True)

    record = []
    wrapped = ((pipeline, "sampled_trajs_to_dataset"), (ContinuousRelaxationEngine, "run_dataset"),
               (pipeline, "success_rate"))
    originals = [(owner, name, timed_calls(owner, name, record)) for owner, name in wrapped]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    try:
        rate = pipeline.run_pipeline(sampler, relaxer, {"src": os.path.join(root, "relax_input.adshard.npz")},
                                     out_dir, nsites=1, denoising_pos_params=PARAMS,
                                     relax_opt=dict(PIPELINE_RELAX_OPT), relaxation_steps=PIPELINE_STEPS,
                                     relaxation_fmax=0.01, dft_targets=dft, batch_size=len(systems))
    finally:
        for owner, name, original in originals:
            setattr(owner, name, original)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = path_launches()
    calls = {name: rest for name, *rest in record}
    if sorted(calls) != ["run_dataset", "sampled_trajs_to_dataset", "success_rate"] or len(record) != 3:
        raise AssertionError(f"the pipeline made the calls {[r[0] for r in record]}: want one conversion, one "
                             f"continuous relaxation (relax_opt continuous unset: auto) and one success rate")
    t_convert, t_relax, t_score = (calls[k][:2] for k in ("sampled_trajs_to_dataset", "run_dataset",
                                                         "success_rate"))
    stages = dict(sample=t_convert[0] - t0, convert=t_convert[1] - t_convert[0], relax=t_relax[1] - t_relax[0],
                  score=t_score[1] - t_score[0], total=t_end - t0)

    # launch counts: the whole run, the sampling stage, the relaxation stage
    steps = PARAMS["num_steps"]
    sample_launches = calls["sampled_trajs_to_dataset"][3]
    relax_launches = {k: v - calls["run_dataset"][3].get(k, 0) for k, v in calls["success_rate"][3].items()
                      if v != calls["run_dataset"][3].get(k, 0)}
    want_sample = {"painn_message_fused": sampler.model.num_layers * steps}
    want_relax = gemnet_launches(relaxer.model, relaxer.forwards)
    if sample_launches != want_sample or relax_launches != want_relax or launches != {**want_sample, **want_relax}:
        raise AssertionError(f"pipeline launched {launches} (sampling {sample_launches}, want {want_sample}; "
                             f"relaxation {relax_launches}, want {want_relax} for {relaxer.forwards} forwards)")

    # trajectories: one sampled and one relaxed per sid; relaxed frames finite with fixed atoms unmoved, the last
    # frame the RelaxedSystem
    results = calls["run_dataset"][2]
    sids = sorted(s.sid for s in systems)
    step_dir = os.path.join(out_dir, "0")
    converted = ShardDataset({"src": os.path.join(step_dir, "final_struct.adshard.npz")})
    inputs = {converted[i].sid: converted[i] for i in range(len(converted))}
    flags = {}
    for stage in ("sampled", "relaxations"):
        names = sorted(os.listdir(os.path.join(step_dir, stage)))
        if names != sorted(f"{sid}{SUFFIX}" for sid in sids):
            raise AssertionError(f"{stage}: files {names}, want one per sid {sids}")
    for sid in sids:
        sampled = Trajectory.load(os.path.join(step_dir, "sampled", f"{sid}{SUFFIX}"))
        if len(sampled) != steps + 1 or not np.isfinite(sampled.positions).all():
            raise AssertionError(f"sampled trajectory {sid}: {len(sampled)} frames or non-finite positions")
        traj = Trajectory.load(os.path.join(step_dir, "relaxations", f"{sid}{SUFFIX}"))
        res = results[sid]
        if not all(np.isfinite(x).all() for x in (traj.positions, traj.energy, traj.forces)):
            raise AssertionError(f"relaxed trajectory {sid} holds non-finite values")
        fixed = traj.fixed
        if not (fixed.any() and (traj.positions[:, fixed] == inputs[sid].pos[fixed]).all()):
            raise AssertionError(f"relaxed trajectory {sid} moved fixed atoms")
        if len(traj) != res.nsteps + 1 or float(traj.energy[-1]) != res.energy or not np.array_equal(
                traj.positions[-1], res.pos):
            raise AssertionError(f"relaxed trajectory {sid}: {len(traj)} frames, last energy {traj.energy[-1]}; "
                                 f"RelaxedSystem nsteps {res.nsteps}, energy {res.energy}")
        flags[sid] = [int(x) for x in eval_tools.anomalous_structure(traj)]
    rate_again, per_system = calls["success_rate"][2]
    if rate is None or rate != rate_again or not 0.0 <= rate <= 1.0:
        raise AssertionError(f"success rate {rate} (the scorer's {rate_again})")
    system_steps = sum(r.nsteps for r in results.values())
    engine = calls["run_dataset"][4]
    print(f"[pipeline] wall per stage (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    print(f"[pipeline] relaxation: {len(results)} systems, {system_steps} L-BFGS system-steps in {stages['relax']:.3f} "
          f"s = {system_steps / stages['relax']:.2f} relax system-steps/s; {relaxer.forwards} GemNet-OC forwards of "
          f"{PIPELINE_RELAX_OPT['slots']} slots ({relaxer.forwards * PIPELINE_RELAX_OPT['slots'] / stages['relax']:.2f} "
          f"slot-steps/s); {engine.host_reads} host reads; {sum(r.converged for r in results.values())} converged; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated; launches {launches}", flush=True)
    print(f"[pipeline] success rate {rate:.4f}; per system {per_system}; anomaly flags (dissociated, desorbed, "
          f"surface changed, intercalated) {flags}", flush=True)


def denoising_tasks_path(device, gen, systems, root):
    """Phases 17 and 18: the run-relaxations and predict tasks with the
    GemNet-OC so3 score model, then card vs CPU for it and for the
    energy-conditional PaiNN."""
    write_shard(os.path.join(root, "relax"), systems)
    traj_dir = os.path.join(root, "trajs")
    cfg = dict(copy.deepcopy(GEMNET_SO3_CONFIG), run_dir=root)
    cfg["task"].update(relax_dataset={"src": os.path.join(root, "relax.adshard.npz")},
                       relax_opt=dict(cfg["task"]["relax_opt"], traj_dir=traj_dir))
    saver = DenoisingTrainer(cfg, device=device)
    saver.init_state()
    ckpt_path = saver.save("checkpoint")
    del saver
    steps = cfg["optim"]["denoising_pos_params"]["num_steps"]
    with new_trainer_context(dict(cfg, mode="run-relaxations", checkpoint=ckpt_path)) as ctx:
        trainer = ctx.trainer
        print(f"[so3-relax] GemNet-OC gemnet_so3.yml widths, cell_reps {trainer.model.cell_reps} (auto), "
              f"{steps} reverse-diffusion steps, B={SO3_RELAX_BATCH}, {len(systems)} bench systems, run-relaxations "
              f"from a checkpoint", flush=True)
        forwards, score_fn = 0, trainer.score_fn

        def counted(*args, **kwargs):
            nonlocal forwards
            forwards += 1
            return score_fn(*args, **kwargs)

        trainer.score_fn = counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.launches.clear()
        t0 = time.perf_counter()
        ctx.task.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = path_launches()
    batches = -(-len(systems) // SO3_RELAX_BATCH)
    want = gemnet_launches(trainer.model, forwards)
    if forwards != steps * batches or launches != want:
        raise AssertionError(f"run-relaxations launched {launches} in {forwards} score forwards; want {want} and "
                             f"{steps * batches} forwards")
    relaxed = np.load(os.path.join(trainer.results_dir, "relaxed_positions.npz"))
    sids = sorted(str(s.sid) for s in systems)
    if sorted(relaxed["ids"].tolist()) != sids or not np.isfinite(relaxed["pos"]).all():
        raise AssertionError(f"relaxed_positions.npz holds ids {relaxed['ids'].tolist()} (want {sids}) or non-finite "
                             f"positions")
    if relaxed["pos"].shape != (sum(s.natoms for s in systems), 3):
        raise AssertionError(f"relaxed_positions.npz positions have shape {relaxed['pos'].shape}")
    for s in systems:
        traj = Trajectory.load(os.path.join(traj_dir, f"{s.sid}{SUFFIX}"))
        slab = traj.tags != 2
        if len(traj) != steps + 1 or not np.isfinite(traj.positions).all() or not (
                traj.positions[:, slab] == s.pos[slab]).all():
            raise AssertionError(f"trajectory {s.sid}: {len(traj)} frames, non-finite or moved slab positions")
    print(f"[so3-relax] {wall:.3f} s wall, {steps * len(systems) / wall:.2f} system-steps/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated, {forwards} score forwards, launches "
          f"{launches}; relaxed_positions.npz holds {len(sids)} ids, {len(systems)} trajectories of {steps + 1} "
          f"frames", flush=True)
    batch = collate(systems, max_atoms=80, device=device)
    with torch.no_grad():
        static = trainer.sampling_static_fn()(batch)
        forward_ms = cuda_ms(lambda: score_fn(batch, static), 5)
    print(f"[so3-relax] one score forward (incremental graphs + 4 blocks + two force heads): {forward_ms:.3f} ms",
          flush=True)

    with new_trainer_context(dict(cfg, mode="predict", checkpoint=ckpt_path)) as ctx:
        ctx.task.run()
        pred = np.load(os.path.join(ctx.trainer.results_dir, "predictions.npz"))
    want_ids = sorted(f"{s.sid}_{s.fid}" for s in systems)
    if sorted(pred["ids"].tolist()) != want_ids or pred["outputs"].dtype != np.float16 or pred["outputs"].shape != (
            len(systems), 80, 3) or not np.isfinite(pred["outputs"]).all():
        raise AssertionError(f"predictions.npz: ids {pred['ids'].tolist()}, outputs {pred['outputs'].dtype} "
                             f"{pred['outputs'].shape}")
    print(f"[so3-relax] predict: predictions.npz holds {len(want_ids)} ids and outputs {pred['outputs'].shape} f16, "
          f"finite", flush=True)

    # 18. card vs CPU at B=2: GemNet-OC so3 (both heads), PaiNN conditional with non-zero energies
    small = collate(systems[:2], max_atoms=80, device=device)
    kw = {k: v for k, v in GEMNET_SO3_MODEL.items() if k not in ("name", "cell_reps")}
    gem = GemNetOC(**kw, cell_reps=trainer.model.cell_reps, device=device, generator=gen)
    with torch.no_grad():
        card, host = gem(small), copy.deepcopy(gem).to("cpu")(small.to("cpu"))
    check_model("GemNet-OC so3", zip(("forces", "forces_so3"), card, host))
    del gem
    conditioned = small.replace(energy=torch.tensor([1.3, -0.7], device=device))
    model = PaiNN(**PAINN_CONDITIONAL_KW, device=device, generator=gen)
    with torch.no_grad():
        card, host = model(conditioned), copy.deepcopy(model).to("cpu")(conditioned.to("cpu"))
        unconditioned = model(small.replace(energy=torch.zeros(2, device=device)))
    check_model("PaiNN conditional", zip(("out_forces", "out_forces2"), card, host))
    moved = (card[0] - unconditioned[0]).abs().max().item()
    if not moved > 0:
        raise AssertionError("PaiNN conditional: the energy does not change the output")
    print(f"[check] PaiNN conditional: the energy moves out_forces by up to {moved:.3e}", flush=True)


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = resolve_device(None)  # also switches TF32 off
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build()
    print(f"[build] {sorted(build.build_logs) or 'up to date'} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # 3-18. each path: its kernels against the plain versions, the path, card vs CPU; then the pipeline and the
    # run-relaxations and predict tasks
    systems = bench_systems()
    rows = [sampling_path(device, torch.Generator().manual_seed(0), systems)]
    rows += consumer_checks(device, torch.Generator().manual_seed(15), systems)
    rows += relax_path(device, torch.Generator().manual_seed(3), systems[:RELAX_BATCH])
    with tempfile.TemporaryDirectory() as root:
        rows.append(training_path(device, torch.Generator().manual_seed(5), root))
    rows += eqv2_path(device, torch.Generator().manual_seed(7), systems)
    with tempfile.TemporaryDirectory() as root:
        rows.append(eqv2_training_path(device, torch.Generator().manual_seed(9), root))
    with tempfile.TemporaryDirectory() as root:
        pipeline_path(device, torch.Generator().manual_seed(13), systems, root)
    with tempfile.TemporaryDirectory() as root:
        denoising_tasks_path(device, torch.Generator().manual_seed(17), systems[:SO3_RELAX_BATCH], root)

    # 19. results
    for r in rows:
        if r["launches"] is None:  # a standalone kernel: what the path runs launched of it
            r["launches"] = PATH_LAUNCHES[r["name"]]
    print(json.dumps({"kernels": [
        dict(name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"], launches=r["launches"],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=None)  # no single PyTorch call computes any of these functions
        for r in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
