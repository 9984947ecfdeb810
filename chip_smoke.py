#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (adsorbdiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises and the exit code is then non-zero:
1. device: the card's name and power limit (nvidia-smi); CUDA required;
   TF32 off (phases 3-24 and 31-33 are f32; phases 25-30 run bf16 where asked).
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
   the grouped call (gemnet_cbf_bases) of one B=8 GemNet-OC forward, its
   e2e, a2e and e2a bases in one launch, each against its plain version,
   with its launch plan (legendre_group_plan) and ptxas's lines; its wall
   (back to back) and device time (20 calls behind a torch.cuda._sleep) per
   forward against the bytes bound summed over the three bases, and the
   three bases launched one by one for the record; gemnet_quad_basis at
   [8, 80, 30, 8, 30] with S=7; ragged shapes (M, K not multiples of 32,
   zero rows, an all-false keep) and ragged groups (two problems of other M
   and K, M K not a multiple of 4, an all-false keep in one problem of
   three), each against its plain version.
   painn_message_consumer and painn_message_consumer_tiled (phase 3d, ti 1
   and 8): at the second message layer's inputs of one B=16 PaiNN forward
   (M = 1280 targets, K=50, H=512; features gathered in torch), each against
   its plain version and against painn_message_fused on the same layer,
   printed with its launch plan (consumer_plan), its sorted groups' window
   product ratio (consumer_windows), its share of the bound and ptxas's
   lines; and at ragged shapes (M not a multiple of 8, K = 1, 45 and 120,
   H = 48, 100, 33 and 50 (H % 64 != 0; H = 33 odd: scalar loads), R = 600
   (W through L1/L2), each with an all-false row that must give 0).
   fused_rbf_filter (phase 3e): at that layer's
   distances, mask and filter weights (the [1280, 50, 1536] filter of the
   plain message versions), printed with its launch plan (rbf_filter_plan),
   its sorted chunks' window product ratio (rbf_filter_windows), its share
   of the bound and ptxas's lines; ragged lead shapes, F = 101 and 1537
   (guarded stores), 9 edges (a tail group), R = 500 (W through L1/L2),
   each with an unmasked edge past the cutoff (output = bias bit for bit),
   and an all-masked input (all zero); the same layer with its slots
   shuffled, timed for information.  No model calls these three: every path
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
   1 masked_legendre_cos (the e2e, a2e and e2a triplet bases in one grouped
   launch), forwards counted by a wrapper around the engine's energy/forces
   function.
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
   at that shape beside its bound (conv1_bwd_bound_ms).
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
   systems written to a shard in a temporary directory, with both trainers
   built by run_pipeline.build_trainer (as python -m
   adsorbdiff_tpu_torch.run_pipeline builds them) from YAML configs and
   checkpoints the phase saves first (random weights from each trainer's
   seed).  Sampler: a DenoisingTrainer at the painn_so3.yml widths
   (cell_reps (2, 2, 0) and max_ads 8 as bench.py sets them), 100 ODE steps
   at B=16.  Relaxer: an S2EFTrainer from configs/relaxation/gemnet_oc/
   gemnet_relax.yml as published (trainer: forces; GemNet-OC at its widths,
   cell_reps auto; energies denormalised by its target_mean/target_std),
   its dataset entries pointed at the phase's shard; relax_opt as
   published with 8 slots and continuous unset, so "auto" picks the
   slot-refill engine; fmax 0.01; relaxation_steps cut from 300 to 100
   (random weights never converge, so every system runs its budget).
   Synthetic DFT targets, one per sid.  Launch counts are zeroed
   just before run_pipeline and read just after: 600 painn_message_fused
   while sampling, and per GemNet-OC forward 4 + 1 while relaxing.  Checks:
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
   gemnet_quad_chain and 1 masked_legendre_cos, forwards counted by a
   wrapper around the trainer's score_fn.  Then the predict task on the same
   data writes predictions.npz.
18. card vs CPU at B=2, within 1e-4 * max|cpu|: one GemNet-OC so3
   denoising forward at full width (both heads), and one PaiNN forward at
   the painn_conditional.yml widths with non-zero energies (both heads; the
   energy must move the output).
19. S2EF tasks: phase 16's relaxer checkpoint (gemnet_relax.yml widths)
   and the 16 bench systems written to a shard with synthetic energies,
   forces, relaxed energies and relaxed positions.  Cuts: eval_batch_size
   48 -> 8, relaxation_steps 300 -> 20.  Through new_trainer_context, as the
   command line runs them: validate (finite energy_mae and forces_mae),
   predict (predictions.npz: every sid_fid, forces [16, 80, 3] in f16),
   run-relaxations with continuous false (the batch engine) and with
   continuous auto and 8 slots (the slot-refill engine), each writing
   relaxed_positions.npz (every sid, fixed atoms as in the input), one
   trajectory per sid (2 to 21 finite frames, fixed atoms unmoved) and
   finite IS2RS/IS2RE metrics.  Launch counts zeroed just before each task
   and read just after: 4 gemnet_quad_chain and 1 masked_legendre_cos per
   GemNet-OC forward, forwards counted by a global forward pre-hook.  Then
   card against CPU for S2EFTrainer.energy_forces_fn at B=2 (denormalised
   energy and forces within 1e-4 * max|cpu|), and run_pipeline.main once
   on phase 16's configs and checkpoints (--nsites 1, --batch-size 16,
   --relaxation-steps 20, DFT targets from a pickle): the success rate it
   returns and prints equals the scorer's, one sampled and one relaxed
   trajectory per sid, exact launch counts (6 painn_message_fused a PaiNN
   forward, 4 + 1 a GemNet-OC forward).  Prints each task's wall.
20. the quad chain's VJP: gemnet_quad_chain with xm and qp needing
   gradients at the S2EF training shape (16 x 80 cells, U=K2=30, Q=8, S=7,
   E=F=32) and at phase 3's ragged shapes (E=40 and F=48, S=9, S*Q*F odd,
   every main key -1, U=1): exactly one kernel launch for forward and
   backward (the backward, kernels.GemnetQuadChain, recomputes the plain
   version), the output, dxm and dqp within 1e-4 * max|plain| + 1e-5 of
   autograd through the plain version; an n1 or n2 that needs a gradient
   raises on the card, and so does masked_legendre_cos's input.  Prints the
   forward kernel's and the VJP's times (CUDA events), the VJP's peak memory
   above what was allocated before it, and its bound.
21. S2EF training: S2EFTrainer.train() for one epoch of
   configs/relaxation/gemnet_oc/gemnet_relax.yml as published (trainer:
   forces; GemNet-OC at its widths, cell_reps auto; B=16, AdamW at 5e-4,
   weight decay 0, multistep LambdaLR with warm-up, clip 10, EMA 0.999,
   energy MAE + 100 x force L2MAE on free atoms, energies normalised by its
   target_mean/target_std; random weights from its seed) on bench systems
   with synthetic energies and forces written to train and val shards.
   Cuts: max_epochs 80 -> 1 (20 steps), eval_every 5000 -> 20 (one
   validation and one checkpoint at the epoch's end), eval_batch_size
   48 -> 16.  Launch counts are zeroed just before train() and read at every
   step: exactly 4 gemnet_quad_chain and 1 masked_legendre_cos a step (the
   backward launches none), and 4 + 1 a forward of the validation inside
   train().  Every loss finite; params and EMA moved; EMA != params;
   validation energy_mae and forces_mae finite; the checkpoint loads into a
   fresh S2EFTrainer whose predict equals the EMA model's bit for bit.
   Prints systems/s over the steps after the first and the epoch's peak
   memory.  Then 3 DenoisingTrainer.train_step calls at the gemnet_so3.yml
   + base.yml settings, B cut from 48 to 16 (48 does not fit in 80 GB),
   exactly 4 + 1 launches a step, finite losses.
22. card vs CPU, one S2EF training step of phase 21's trainer at B=2 (two
   of its systems): loss, grad_norm and every parameter's gradient within
   1e-3 * max|cpu| of that tensor.
23. Langevin sampling: DiffusionEngine(sampler="langevin") over phase 4's
   PaiNN (the same seed, so the same weights) at B=16, 100 steps
   (n_step_each 1, step_lr 1e-4): exactly 600 painn_message_fused
   launches, 101 finite frames, the slab unmoved, every adsorbate moved
   rigidly in xy (the atoms' displacements within 1e-3 A of each other,
   |dz| <= 1e-5 A); its wall and rate beside phase 4's.  Then 10 steps card
   against CPU at B=2 from the same frac and noise tensors, positions within
   1e-4 A.
24. accumulated and plateau training: the gemnet_so3.yml + base.yml steps
   of phase 21 at B=16 with grad_accumulation_steps 3 (the published
   effective batch of 48), 6 train_step calls: params unchanged after
   micro-steps 1, 2, 4 and 5 and moved after 3 and 6; the EMA equal to its
   decay toward the params after every micro-step (so moving at every one
   from the first update on); exactly 4 + 1 launches a micro-step; finite
   losses; the peak printed beside phase 21's B=16 so3 peak.  Then 6 S2EF
   steps of gemnet_relax.yml with scheduler ReduceLROnPlateau (factor 0.5,
   patience 2) at B=16: finite losses, 4 + 1 launches a step, the plateau's
   scale, best loss and count device tensors, and no operation of the
   trainer's modules making the host wait on the card during the steps
   (torch.cuda.set_sync_debug_mode("warn"); every such operation of the
   steps printed with its file and line).
25. the bf16 variants (ROADMAP A.8 step 1) against their bf16 plain
   versions on the card: painn_message_fused with bf16 xh and bf16 or f32
   vec (csrc/painn_message_fused_bf16.cu, the filter product on the bf16
   tensor cores) at the sampling shape on the bench graph (B=16) and at
   six ragged shapes (two of phase 3; K = 1; K = 17 with R = 21 and H = 40,
   its slots past the cutoff carrying the bias; N = 1; sources out of
   range), each in both vec dtypes, |kernel - plain| <= 1e-3 * max|plain| +
   1e-5 (f32 outputs), printed with its plan, its ptxas lines, its device
   time behind a sleep and the f32 kernel's time on the same values
   widened; painn_message_fused_bwd at the training shape (B=48, the bench
   graph) and the same two ragged shapes, the same gate;
   masked_legendre_cos's grouped call of one bf16 GemNet-OC forward at B=8
   (bf16 outputs) and two ragged groups, 4e-3 * max|plain| + 1e-5 (one bf16
   ulp of the largest element); gemnet_quad_chain with a bf16 out from f32
   xm and qp (GemNet-OC's bf16 path) at the relaxation shape and two ragged
   shapes, 1e-2 * max|plain| + 1e-5,
   and its VJP at the S2EF training shape with a bf16 cotangent.  Each
   timed by CUDA events beside its bound (bf16 bytes; products of two bf16
   values at the bf16 tensor-core rate), with its share of the bound and
   ptxas's lines for its bf16 instances.  Printed first:
   torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction.
   Then EquiformerV2's four (ROADMAP A.8 step 2), through phases 10, 13a
   and 13b's own checks with bf16 inputs: s2_grid_silu, eqv2_attn_conv1
   and eqv2_edge_rotate (every form, the edge-degree one f32 in the model,
   each with its VJP against the plain dual rotation) at the inputs of one
   bf16 forward at the eqv2_so3.yml widths (B=16 sampling),
   s2_grid_silu_bwd at a B=12 forward's (the training shape), each with
   ragged shapes: a bf16 output within one bf16 ulp of the
   largest element, bf16_ulp(max|plain|) + 1e-5 (kernel and plain sum in
   f32 in another order, so an intermediate bf16 rounding can flip and move
   an output by one ulp: 4e-3 to 7.8e-3 of max by where max lies in its
   binade); each timed beside its f32 kernel on the same values, its plain
   version and its bound in bf16 bytes; conv1's wide route raises
   TypeError on bf16 messages.  All four bf16 forms are tensor-core
   kernels of their own (csrc/s2_grid_silu_bf16.cu with the S^2
   backward's entry, csrc/eqv2_attn_conv1_bf16.cu,
   csrc/eqv2_edge_rotate_bf16.cu), printed with their plans, ptxas's
   lines and, for the S^2 pair, the sigmoid's SFU floor; their ragged
   cases add the tiling edges: column counts that no m16 tile or 32-column
   warp tile divides and NC 25 and 32; E that leaves a partial m16 tile in
   a unit, or one m16 tile; ODD widths (C 12, c_out 6, extra 11, 21
   gaussians, trunk 24) that no 8 or 16 divides; the rotation at every
   slot count (lmax 1, 3, 5, 6: P = 16, 16, 48, 64) with channel counts no
   8 divides (1, 3, 5) and 33 in both directions and the gather form.
26. PaiNN in bf16 (compute_dtype bfloat16, phase 4's weights): one B=2
   forward on the card against the same bf16 model on the CPU, both heads
   within 3e-2 * max|cpu bf16| and within the CPU's bf16-to-f32 distance,
   and at least half that distance from the CPU's f32 forward (the card
   rounds as bf16 does), printed beside the spread of three CPU bf16
   forwards whose parameters are perturbed by 2e-7 relative; then 100 ODE
   steps at
   B=16 with the hoisted static graph: exactly 600 launches of the bf16
   variant and no f32 one, finite f32 positions, the slab unmoved and every
   adsorbate's interatomic distances kept (rigid moves); its rate beside
   phase 4's.
27. GemNet-OC in bf16 (phase 6's weights): the same B=2 check for energy
   and forces, then 100 L-BFGS steps at B=8 with the Verlet graph: exactly 4
   + 1 bf16 launches a forward and no f32 one, finite f32 energies and
   forces in the L-BFGS state, fixed atoms unmoved; its rate and one
   forward's time beside phase 6's.
28. training with amp: true: DenoisingTrainer.train() at phase 8's settings
   and cut (exactly 6 + 6 bf16 launches a step, the EMA model in bf16) and
   S2EFTrainer.train() at phase 21's (4 + 1 a step and a validation
   forward), every loss finite, params and EMA moved, systems/s and peak
   beside phases 8 and 21; one step of each at B=2 card against CPU, loss
   within 3e-2 relative, every gradient within 5e-2 * max|cpu| but one
   fixed exception (BF16_GRAD_LIMITS), no CPU gradient's roundoff spread
   past 0.1, and the gradients as one vector no further from the CPU's bf16
   than the CPU's f32 is and at least half that far from the f32.
29. EquiformerV2 in bf16 (compute_dtype bfloat16, phase 11's weights): one
   B=2 forward card against CPU under phase 26's gates but a fixed limit,
   BF16_EQV2_MODEL_LIMIT * max|cpu| in place of the CPU's bf16-to-f32
   distance d (its own roundoff spread reaches d, and must stay below the
   fixed limit), then 100 ODE steps
   at B=16 with the hoisted static graph: per forward exactly 10 launches
   each of eqv2_attn_conv1.bf16 and s2_grid_silu.bf16, 30 of
   eqv2_edge_rotate.bf16 and 1 of the f32 eqv2_edge_rotate (the edge-degree
   embedding, f32 in JAX too); finite f32 positions, the slab unmoved; its
   rate, peak and one forward's time beside phase 11's.
30. EquiformerV2 training with amp: true: the conv1 VJP in bf16 at the
   training shape beside its bound, DenoisingTrainer.train() at phase 14's
   settings and cut (per step 10 + 10 + 10 bf16 launches of conv1, the S^2
   activation and its backward, 60 bf16 rotations and 2 f32 ones), its
   systems/s and peak beside phase 14's; one amp step at B=2 card against
   CPU under phase 28's gates for eqv2_so3.yml and eqv2_conditional.yml,
   cut to EQV2_STEP_LAYERS layers.
31. reference checkpoints (ROADMAP A.10 step 1): reference-shaped .pt
   files (DDP prefixes, the embedded config) at published widths with
   random weights from a seeded generator (EquiformerV2 at
   eqv2_conditional.yml, from the port's table of the reference's names and
   shapes; PaiNN at painn_so3.yml; GemNet-OC at gemnet_relax.yml with fitted-
   looking scale factors), converted by `python -m
   adsorbdiff_tpu_torch.scripts.convert_checkpoint` in processes of their own
   beside `python -m adsorbdiff_tpu_torch.scripts.eval nsite` on phase 16's
   tree (its printed rate and per-system results must be phase 16's); each
   converted file loaded by its trainer from the sidecar's model section;
   PaiNN and GemNet-OC B=2 forwards card against CPU (GemNet-OC's scale
   factors the reference's); the EquiformerV2 (e3nn grid, energy-
   conditional, f32): its S^2 tables checked to be the e3nn ones,
   s2_grid_silu and s2_grid_silu_bwd on them at the first attention block's
   input (phases 10a/13b's checks, times beside the gauss ones), the
   run-relaxations task from the checkpoint (100 ODE steps at B=16, exact
   launch counts 1000 + 1000 + 3100, rate beside phase 11's), a B=2 forward
   with non-zero energies card against CPU, and one training step at B=2
   card against CPU (all 8 layers) with its exact launches.
32. the reference's LMDB data (ROADMAP A.10 step 2): both host libraries
   built with g++ from the checkout (no fallback); 8192 bench systems with
   energies and forces exported by export_systems_to_lmdb (every record an
   overflow chain, a branch level), read back by the C++ and the Python
   reader (equal byte for byte, records/s of each), converted by
   convert_lmdb_to_shards (two shards of at most 5000) and write_shard_bin,
   every converted system equal bit for bit to the same system written to a
   shard directly; the fixture tests/fixtures/oc20_2sys.lmdb through both
   readers; the first 20 batches of an epoch at B=48 from NativeShardDataset
   (the C++ collator) and ShardDataset equal bit for bit (batches/s of
   each); neighbor_counts of 256 systems at 12 A and 50 neighbours card
   against CPU, exactly equal, and a mode="neighbors" plan; 4
   DenoisingTrainer steps (painn_so3.yml + base.yml, B=48) on the converted
   shards, step 1's batch equal to the direct shards' and its loss within
   1e-6 relative, 6 + 6 launches a step; run_relaxations over 16 converted
   systems (100 ODE steps at B=16, 600 launches); 2 S2EFTrainer steps
   (gemnet_relax.yml, B=16) on the converted labelled records, 4 + 1
   launches a step.  Every rate beside the card's name and power limit and
   the host's CPU.
33. ROADMAP A items 1-4 through the port's public API: Bulk.get_slabs
   (max_miller=2) on val_sample's Cu bulk and AdsorbateSlabConfig in its
   three modes with CO and *N*NH from the packaged table (each timed, no
   covalent overlap); painn_so3.yml's and gemnet_relax.yml's model sections
   (cell_reps: auto resolved over the phase's adslabs) written by
   make_demo_checkpoint; AdsorbDiffCalculator on one Cu(100) + CO adslab:
   run_diffusion (100 steps, exactly 600 painn_message_fused launches, equal
   to DiffusionEngine.run with the same generator bit for bit, slab
   unmoved, adsorbate rigid), calculate card against CPU (1 + 4 launches):
   on the placed adslab, a perfect fcc slab whose neighbour tables part at
   tied edges only (checked, edge by edge), and under phase 7's gate on a
   copy moved by N(0, 0.05 A), whose tables agree; relax (100 of 300
   steps, 1 + 4 launches a forward, fixed atoms unmoved) and the anomaly
   flags; then val_sample and nrr_screening --bulks 2 in-process through
   their main(argv) with those checkpoints (600 launches a diffusion run,
   1 + 4 a GemNet-OC forward).
34. the kernels line, then the device line as the last line.  A row's ms,
   plain_ms and bound_ms are per launch; eqv2_edge_rotate's are the mean
   over the four forms in the proportions one forward launches them, and
   its launches are the EquiformerV2 sampling run's; masked_legendre_cos's
   are per forward (the grouped launch of the three triplet bases: ms its
   wall back to back, bound_ms the three bases' bounds summed);
   masked_legendre_cos's and gemnet_quad_chain's launches are the
   relaxation path's plus phase 19's four tasks' plus phases 21's and
   24's runs' plus phases 31's, 32's and 33's; painn_message_fused's are
   phase 4's plus phases 23's and 31-33's; painn_message_fused_bwd's add phase
   32's; the EquiformerV2 kernels' f32 rows add phase 31's; the
   consumers' and fused_rbf_filter's launches are
   their counts summed over every path run (0: no path calls them).  The
   eight bf16 variants are rows of their own (``<kernel>.bf16``; the four
   EquiformerV2 ones from their tensor-core sources, the others from their
   f32 kernel's), their launches those of phases 26-30;
   eqv2_edge_rotate.bf16's times are the mean over the three bf16 forms a
   forward launches.

It imports nothing of JAX and nothing of the JAX package.
"""
import collections
import copy
import dataclasses
import json
import logging
import math
import os
import pickle
import platform
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch
import yaml

from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch import AdsorbDiffCalculator, eval_tools, pipeline, run_pipeline
from adsorbdiff_tpu_torch.common.config import load_config
from adsorbdiff_tpu_torch.data import lmdb_compat, lmdb_native, lmdbio, metadata, native
from adsorbdiff_tpu_torch.data.buckets import BucketedBatcher
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from adsorbdiff_tpu_torch.device import resolve_device
from adsorbdiff_tpu_torch.diffusion.sampler import langevin_dynamics
from adsorbdiff_tpu_torch.diffusion.schedules import draw_schedule
from adsorbdiff_tpu_torch.examples import nrr_screening, val_sample
from adsorbdiff_tpu_torch.models import equiformer_v2, gemnet_oc
from adsorbdiff_tpu_torch.models.base import generate_graph
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC
from adsorbdiff_tpu_torch.models import painn, so3
from adsorbdiff_tpu_torch.models.painn import PaiNN
from adsorbdiff_tpu_torch.ops import build, host_build, kernels, pbc
from adsorbdiff_tpu_torch.ops.segment import masked_mean
from adsorbdiff_tpu_torch.placement import Adsorbate, AdsorbateSlabConfig, DetectTrajAnomaly, Slab
from adsorbdiff_tpu_torch.placement.adsorbate_slab_config import there_is_overlap
from adsorbdiff_tpu_torch.relaxation.calculator import load_model
from adsorbdiff_tpu_torch.relaxation.continuous import ContinuousRelaxationEngine
from adsorbdiff_tpu_torch.relaxation.lbfgs import make_mlff_energy_forces
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, make_score_fn
from adsorbdiff_tpu_torch.runtime.atoms import atoms_to_system
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory
from adsorbdiff_tpu_torch.tasks import new_trainer_context
from adsorbdiff_tpu_torch.train import torch_import
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer, S2EFTrainer

# NVIDIA H100 SXM data sheet: dense f32 outside the tensor cores, dense bf16 on the tensor cores, HBM3 rate
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# every main-path run's launch counts, summed: the kernels line reads the standalone kernels' launches here
PATH_LAUNCHES = collections.Counter()
# rates and peaks of earlier phases that a later phase prints beside its own
RATES = {}
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
# run_pipeline's relax_opt: gemnet_relax.yml's as published (continuous unset: auto picks the slot-refill engine at
# fmax 0.01; run_pipeline writes the trajectories under its out_dir) with 8 slots; relaxation_steps cut from 300 as
# above.
PIPELINE_RELAX_OPT = dict(maxstep=0.04, memory=50, damping=1.0, alpha=70.0, slots=8)
PIPELINE_STEPS = 100
# the relaxer's config, read as the command line reads it (trainer: forces; the model block; normalize_labels with
# its target_mean/target_std, by which energies are denormalised).  Phases 16 and 19 point its dataset entries and
# relax_dataset at shards they write and its traj_dir at their temporary directory.  Cut: eval_batch_size 48 -> 8
# (phase 19's validate, predict and relax batches); phase 19 cuts relaxation_steps 300 -> S2EF_STEPS, and the
# command line's --relaxation-steps to the same.
RELAX_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "relaxation", "gemnet_oc",
                            "gemnet_relax.yml")
S2EF_BATCH, S2EF_STEPS = 8, 20
# phase 21: gemnet_relax.yml's batch_size, one epoch of S2EF_TRAIN_STEPS steps (max_epochs cut from 80)
S2EF_TRAIN_BATCH, S2EF_TRAIN_STEPS = 16, 20
# the quad chain at that batch: 16 x 80 cells, U = K2 = 30, Q = 8, S = 7, E = F = 32 (b, n, u, q, k2, s, e, f)
QUAD_TRAIN_SHAPE = (S2EF_TRAIN_BATCH, 80, 30, 8, 30, 7, 32, 32)
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
# widths no 8 or 16 divides (C 12, c_out 6, extra 11, 21 gaussians, trunk 24): the bf16 kernel's padding, its
# 2-byte message loads and its 2-byte output stores, an output pair that straddles extra | h
EQV2_ODD = (2, 1, 12, 6, 11, 21, 24, 6.0)
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
# phase 21's GemNet-OC so3 training, 3 steps.  Cut: base.yml's batch_size 48 -> 16 (gemnet_relax.yml's; at 48 the
# step ran out of the card's 80 GB, where B=16 S2EF training peaks at ~29 GB)
SO3_TRAIN_BATCH, SO3_TRAIN_STEPS = 16, 3
# phase 24: the same steps with grad_accumulation_steps 3, the published effective batch of 48 (JAX's way to train
# it on a smaller device); then PLATEAU_STEPS S2EF steps of gemnet_relax.yml with the ReduceLROnPlateau schedule
ACCUM_STEPS, PLATEAU_STEPS = 3, 6
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


def bound(flops, tensors, bf16_flops=0):
    """Least time on this card: the ``flops`` operations at the f32 peak,
    but the ``bf16_flops`` of them that are products of two bf16 values
    summed in f32 (a bf16 MMA's type) at the dense bf16 tensor-core peak,
    against every given tensor moved once at the HBM rate.  Returns (ms,
    what sets it, bytes)."""
    sizes = {}  # one entry per storage: a tensor passed twice (u is v) moves once
    for t in tensors:
        sizes[t.data_ptr()] = max(sizes.get(t.data_ptr(), 0), t.numel() * t.element_size())
    nbytes = sum(sizes.values())
    t_ops = ((flops - bf16_flops) / F32_FLOPS + bf16_flops / BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), nbytes


def check_close(name, got, want, rtol=KERNEL_RTOL):
    """Max |got - want| over the pairs, held to rtol * max|want| + 1e-5
    (rtol 1e-4 unless given)."""
    err, limits = 0.0, []
    for g, w in zip(got, want):
        e = (g - w).abs().max().item()
        limits.append(rtol * w.abs().max().item() + KERNEL_ATOL)
        if not e <= limits[-1]:
            raise AssertionError(f"{name}: max |kernel - plain| {e} > {limits[-1]}")
        err = max(err, e)
    print(f"[kernel] {name}: max_abs_err {err:.3e} (limit {rtol} * max|plain| + {KERNEL_ATOL} = "
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
    """The function's operations on the valid edges (filter product 6H per
    non-zero basis value, of two bf16 values where ``xh`` is bf16; f32
    gather-multiply, reductions and directional terms ~20H per edge,
    gaussian basis ~10 per non-zero value) against its inputs and outputs
    moved once."""
    h = inputs["weight"].shape[1] // 3
    edges, rows = basis_rows(inputs, cutoff)
    filt = 6 * h * rows
    flops = filt + 20 * h * edges + 10 * rows
    bf16_flops = filt if inputs["xh"].dtype == torch.bfloat16 else 0
    return (*bound(flops, list(inputs.values()) + list(outputs), bf16_flops), flops)


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


def device_ms(fn, calls, sleep_cycles=20_000_000):
    """Mean device milliseconds per call of ``fn``: ``calls`` calls enqueued
    behind a ``torch.cuda._sleep`` long enough (~10 ms at 2 GHz) that the
    host has enqueued them all before the card reaches them, so the events
    around them time the card alone; after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    if end.query():
        raise AssertionError("device_ms: the card finished before the host had enqueued every call")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def legendre_group_line(problems):
    shapes = tuple((u.shape[0] * u.shape[1], u.shape[2], v.shape[2]) for u, v, _ in problems)
    plan = kernels.legendre_group_plan(shapes)
    return (f"plan: {plan.blocks} blocks x {plan.threads} threads, blocks a problem {plan.blocks_of}, cells a block "
            f"{plan.cpb}, four columns a thread {plan.vec}, {plan.smem_bytes} B shared")


def check_legendre_group(name, problems, s):
    """One grouped launch against each basis's plain version."""
    before = kernels.launches["masked_legendre_cos"]
    got = kernels.gemnet_cbf_bases(problems, s)
    torch.cuda.synchronize()
    if kernels.launches["masked_legendre_cos"] != before + 1:
        raise AssertionError(f"{name}: the grouped call launched {kernels.launches['masked_legendre_cos'] - before}")
    err = check_close(f"{name}: {len(problems)} problems (M, K) "
                      f"{[(u.shape[2], v.shape[2]) for u, v, _ in problems]} S={s} ({legendre_group_line(problems)})",
                      [g for g in got if g.numel()],
                      [kernels.gemnet_cbf_basis_reference(*p, s) for p, g in zip(problems, got) if g.numel()])
    return got, err


def legendre_checks(device, gen, model, batch):
    """Phase 3c: the grouped call of one forward of ``model`` on ``batch``
    (the e2e, a2e and e2a bases in one launch) against each basis's plain
    version, its wall (back to back) and device time per forward beside the
    bound summed over the three bases, the same bases launched one by one
    for the record; the dihedral basis at the relaxation shape; ragged
    shapes and groups.  Returns the kernels-line row (times per forward)."""
    s = model.num_spherical
    with torch.no_grad():
        calls = capture_calls(gemnet_oc, "gemnet_cbf_bases", lambda: model(batch))
    if len(calls) != 1 or len(calls[0][0]) != 3:
        raise AssertionError(f"one GemNet-OC forward called gemnet_cbf_bases {len(calls)} times "
                             f"({[len(c[0]) for c in calls]} problems), want once with 3")
    problems = [tuple(p) for p in calls[0][0]]
    del calls
    outs, err = check_legendre_group("gemnet_cbf_bases e2e, a2e, e2a of one forward", problems, s)
    ms = cuda_ms(lambda: kernels.gemnet_cbf_bases(problems, s), 200)  # host-bound: many calls even out the host
    dev_ms = device_ms(lambda: kernels.gemnet_cbf_bases(problems, s), 20)
    plain_ms = cuda_ms(lambda: [kernels.gemnet_cbf_basis_reference(*p, s) for p in problems], 5)
    bounds = [legendre_bound_ms(p, out, s) for p, out in zip(problems, outs)]
    bound_ms, nbytes, flops = (sum(b[i] for b in bounds) for i in (0, 2, 3))
    by = "bytes" if {b[1] for b in bounds} == {"bytes"} else "operations"
    print(f"[kernel] masked_legendre_cos, one grouped launch a forward (e2e u{tuple(problems[0][0].shape)}, a2e, "
          f"e2a): wall {ms:.4f} ms (back to back), device {dev_ms:.4f} ms (behind a sleep), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.3f} GFLOP f32, {nbytes / 1e6:.2f} MB), "
          f"{100 * bound_ms / dev_ms:.1f}% of the bound on the device; {legendre_group_line(problems)}; ptxas: "
          f"{' | '.join(ptxas_lines('masked_legendre_cos')) or 'not built in this process'}", flush=True)

    def one_by_one():
        return [kernels.gemnet_cbf_basis(*p, s) for p in problems]

    print(f"[kernel] masked_legendre_cos as three one-problem launches a forward (the form before the grouped "
          f"call): wall {cuda_ms(one_by_one, 200):.4f} ms, device {device_ms(one_by_one, 20):.4f} ms", flush=True)
    del outs
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
    # ragged groups: two problems of different M and K; M K not a multiple of 4 (one column a thread); an all-false
    # keep in one problem of three
    for name, shapes, false_keep in (("two shapes", [((3, 5), 29, 12), ((3, 5), 12, 20)], ()),
                                     ("scalar path", [((2, 3), 7, 5), ((2, 3), 5, 3)], ()),
                                     ("all-false keep", [((2, 3), 6, 6), ((2, 3), 6, 4), ((2, 3), 4, 6)], (1,))):
        group = [legendre_inputs(gen, device, lead + (m,), lead + (k,), lead + (m, k), unit=True,
                                 keep_all=False if i in false_keep else None)
                 for i, (lead, m, k) in enumerate(shapes)]
        got, _ = check_legendre_group(f"gemnet_cbf_bases {name}", group, s)
        if any(got[i].any() for i in false_keep):
            raise AssertionError("gemnet_cbf_bases: a problem with an all-false keep is not zero")
    return dict(name="masked_legendre_cos", source="adsorbdiff_tpu_torch/csrc/masked_legendre_cos.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:1613", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, device_ms=dev_ms)


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


def consumer_plan_line(plan):
    return (f"plan: {plan.chunks} chunks x {plan.slices} slices of 64 columns = {plan.blocks} blocks x "
            f"{plan.threads} threads ({plan.waves:.2f} waves of one block an SM), at most {plan.load} targets an "
            f"owner, {plan.smem_bytes} B shared, W {'staged' if plan.stage_w else 'through L1/L2'}, "
            f"{'float2' if plan.vec else 'scalar'} row loads")


def consumer_window_ratio(inputs, cutoff, plan):
    """Products the consumer kernel runs over its groups' windows on their
    slots (8 slots sorted by basis bin across an owner's targets), over the
    non-zero basis values the unmasked slots need (the window rule's Python
    mirror, kernels.consumer_windows)."""
    lo, hi, slots = kernels.consumer_windows(inputs["dist"].cpu(), inputs["mask"].cpu(), inputs["weights"].shape[0],
                                             cutoff, plan)
    _, rows = basis_rows(inputs, cutoff)
    return float((torch.clamp(hi - lo + 1, min=0) * (slots >= 0).sum(-1)).sum()) / rows


def rbf_bound_ms(inputs, out, cutoff):
    """The product on the valid edges' non-zero basis values (2F each), the
    basis (~10 per value) and the bias and mask (2F per edge), against the
    inputs and the [..., K, F] output moved once."""
    f = inputs["weights"].shape[1]
    edges, rows = basis_rows(inputs, cutoff)
    flops = 2 * f * rows + 10 * rows + 2 * f * inputs["dist"].numel()
    return (*bound(flops, list(inputs.values()) + [out]), flops)


def rbf_plan_line(plan):
    return (f"plan: {plan.blocks} blocks x {plan.threads} threads ({plan.blocks // plan.slices} a slice of 128 "
            f"columns, {plan.blocks_per_sm} an SM), {plan.chunks} chunks of 384 edges (the most a block takes over "
            f"the mean {plan.spread:.3f}), {plan.smem_bytes} B shared, "
            f"W {'staged' if plan.stage_w else 'through L1/L2'}, {'float4' if plan.vec else 'guarded scalar'} stores")


def rbf_window_products(inputs, cutoff):
    """(products the kernel runs over its sorted chunks' 8-edge windows, the
    non-zero basis values of the unmasked edges), from the window rule's
    Python mirror, kernels.rbf_filter_windows."""
    weights = inputs["weights"]
    lo, hi, _ = kernels.rbf_filter_windows(inputs["dist"].cpu(), inputs["mask"].cpu(), weights.shape[0], cutoff)
    _, rows = basis_rows(inputs, cutoff)
    return 8 * int(torch.clamp(hi - lo + 1, min=0).sum()), rows


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
    sms = kernels._sm_count(device)
    plan = kernels.consumer_plan(m, k, weight.shape[0], f3 // 3, sms)
    ratio = consumer_window_ratio(layer, cutoff, plan)
    rows = []
    for name, ti, line in (("painn_message_consumer", 1, 130), ("painn_message_consumer_tiled", 8, 769)):
        fn = getattr(kernels, name)
        got = fn(**layer, cutoff=cutoff, ti=ti)
        torch.cuda.synchronize()
        err = check_close(f"{name} ti={ti} at the PaiNN layer ({shape}; {consumer_plan_line(plan)})", got, want)
        check_close(f"{name} ti={ti} against painn_message_fused on the same layer", got, fused)
        # M not a multiple of 8 or of the chunks, K % 8 != 0, K = 1 and 120, H % 64 != 0 (48, 100, 33, 50), H odd
        # (33: scalar loads), R = 600 (W through L1/L2); each with an all-false last row
        for ragged in ((37, 45, 128, 192), (13, 10, 16, 64), (5, 120, 128, 64), (29, 45, 128, 48), (11, 1, 16, 100),
                       (9, 8, 16, 33), (6, 7, 16, 50), (7, 12, 600, 64)):
            ins = consumer_inputs(gen, device, *ragged, 6.0)
            out = fn(**ins, cutoff=6.0, ti=ti)
            torch.cuda.synchronize()
            check_close(f"{name} ti={ti} m,k,r,h={ragged} ({consumer_plan_line(kernels.consumer_plan(*ragged, sms))})",
                        out, kernels.painn_message_consumer_reference(**ins, cutoff=6.0))
            if out[0][-1].any() or out[1][-1].any():
                raise AssertionError(f"{name}: a row with an all-false mask is not zero")
        ms = cuda_ms(lambda: fn(**layer, cutoff=cutoff, ti=ti), 20)
        bound_ms, by, nbytes, flops = consumer_bound_ms(layer, got, cutoff)
        print(f"[kernel] {name} ti={ti} at {shape} ({edges} valid edges, {nz / edges:.2f} non-zero basis values "
              f"each): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP "
              f"f32, {nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; windows {ratio:.4f}x the "
              f"needed products; {consumer_plan_line(plan)}; ptxas (the W-staged float2 instance): "
              f"{' | '.join(ptxas_lines('painn_message_consumer', 'ILb1ELb1E')) or 'not built in this process'}",
              flush=True)
        rows.append(dict(name=name, source="adsorbdiff_tpu_torch/csrc/painn_message_consumer.cu",
                         replaces=f"adsorbdiff_tpu/ops/pallas_kernels.py:{line}", launches=None, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by))
    del layer["xh_gathered"], layer["vec_gathered"], got, want, fused

    # 3e. fused_rbf_filter at the same layer's distances, mask and filter weights: the plain version is the
    # filter the plain message versions build
    filt = dict(dist=layer["dist"], mask=layer["mask"], weights=weight, bias=bias)
    out = kernels.fused_rbf_filter(**filt, cutoff=cutoff)
    torch.cuda.synchronize()
    plan = kernels.rbf_filter_plan(m * k, weight.shape[0], f3, kernels._sm_count(device))
    err = check_close(f"fused_rbf_filter at the PaiNN layer's [{m}, {k}] edges (the plain message filter; "
                      f"{rbf_plan_line(plan)})", [out], [kernels.fused_rbf_filter_reference(**filt, cutoff=cutoff)])
    # ragged lead shapes; F % 4 != 0 (guarded) at F = 100 + 1 and 1537; a tail group of 9 edges; every edge masked;
    # R = 500 (W through L1/L2); each with an unmasked edge past the 6 A cutoff (output = bias) but the masked one
    for lead, r, f, masked in (((3, 10, 8), 16, 100, False), ((127,), 16, 128, False), ((2, 5, 50), 128, 1536, False),
                               ((3, 10, 8), 16, 101, False), ((2, 5, 50), 128, 1537, False), ((9,), 128, 1536, False),
                               ((4, 50), 128, 1536, True), ((2, 5, 50), 500, 1536, False)):
        ins = dict(dist=torch.rand(lead, generator=gen) * 7.2, mask=torch.rand(lead, generator=gen) > 0.3,
                   weights=torch.randn((r, f), generator=gen) * r ** -0.5, bias=torch.randn(f, generator=gen))
        ins["dist"].view(-1)[0], ins["mask"].view(-1)[0] = 7.5, True  # unmasked, past the 6 A cutoff
        if masked:
            ins["mask"].zero_()
        ins = {name: t.to(device) for name, t in ins.items()}
        got = kernels.fused_rbf_filter(**ins, cutoff=6.0)
        torch.cuda.synchronize()
        check_close(f"fused_rbf_filter lead {lead} R={r} F={f}{' all masked' if masked else ''} "
                    f"({rbf_plan_line(kernels.rbf_filter_plan(got.numel() // f, r, f, kernels._sm_count(device)))})",
                    [got], [kernels.fused_rbf_filter_reference(**ins, cutoff=6.0)])
        if masked and got.any():
            raise AssertionError("fused_rbf_filter: an all-masked input does not give 0")
        if not masked and not torch.equal(got.reshape(-1, f)[0], ins["bias"]):
            raise AssertionError("fused_rbf_filter: an unmasked edge past the cutoff does not give the bias")
    ms = cuda_ms(lambda: kernels.fused_rbf_filter(**filt, cutoff=cutoff), 20)
    plain_ms = cuda_ms(lambda: kernels.fused_rbf_filter_reference(**filt, cutoff=cutoff), 5)
    bound_ms, by, nbytes, flops = rbf_bound_ms(filt, out, cutoff)
    ran, needed = rbf_window_products(filt, cutoff)
    print(f"[kernel] fused_rbf_filter at [{m}, {k}] x R={weight.shape[0]} -> F={f3}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP f32, {nbytes / 1e6:.2f} MB), "
          f"{100 * bound_ms / ms:.1f}% of the bound; sorted chunks' windows {ran / needed:.4f}x the needed products; "
          f"{rbf_plan_line(plan)}; ptxas (the float4, W-staged instance): "
          f"{' | '.join(ptxas_lines('fused_rbf_filter', 'ILb1ELb1E')) or 'not built in this process'}", flush=True)
    # the same layer with the slots of every target shuffled (the graph sorts them by distance): for information
    perm = torch.argsort(torch.rand((m, k), generator=torch.Generator().manual_seed(5)), dim=-1).to(device)
    shuffled = dict(filt, dist=torch.gather(filt["dist"], 1, perm), mask=torch.gather(filt["mask"], 1, perm))
    got = kernels.fused_rbf_filter(**shuffled, cutoff=cutoff)
    torch.cuda.synchronize()
    check_close("fused_rbf_filter on the shuffled slots", [got],
                [kernels.fused_rbf_filter_reference(**shuffled, cutoff=cutoff)])
    del got
    s_ms = cuda_ms(lambda: kernels.fused_rbf_filter(**shuffled, cutoff=cutoff), 20)
    s_ran, _ = rbf_window_products(shuffled, cutoff)
    print(f"[kernel] fused_rbf_filter on the shuffled slots: {s_ms:.4f} ms, windows {s_ran / needed:.4f}x the needed "
          f"products", flush=True)
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
    """2 x 2 G NC per (edge, channel) column for the two products (of bf16
    values for bf16 h) and ~6 G f32 for the SiLU; h, both tables and out
    moved once."""
    g, nc = to_m.shape
    cols = h.numel() // nc
    products = cols * 4 * g * nc
    flops = products + cols * 6 * g
    return (*bound(flops, [h, to_m, from_m, out], products if h.dtype == torch.bfloat16 else 0), flops)


def sfu_floor_ms(sigmoids, device):
    """(ms, MHz): the SFU's least time for ``sigmoids`` sigmoids of two SFU
    operations each (ex2, rcp) at 16 a clock per SM, at the SM clock
    nvidia-smi reads now (the card's current clock, under this run's load)."""
    mhz = int(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout.split()[0])
    return 2 * sigmoids / (16 * kernels._sm_count(device) * mhz * 1e6) * 1e3, mhz


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


EQV2_REPLACES = {"s2_grid_silu": "adsorbdiff_tpu/ops/pallas_kernels.py:903",
                 "s2_grid_silu_bwd": "adsorbdiff_tpu/ops/pallas_kernels.py:919",
                 "eqv2_edge_rotate": "adsorbdiff_tpu/ops/pallas_kernels.py:1079",
                 "eqv2_attn_conv1": "adsorbdiff_tpu/ops/pallas_kernels.py:1252"}


def bf16_ulp(x):
    """One bf16 ulp at |x| > 0: 2^(floor(log2 |x|) - 7)."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8)


def check_eqv2(name, got, want, bf16):
    """An EquiformerV2 kernel against its plain version: the f32 kernel at
    check_close's gate; a bf16 variant's bf16 output within one bf16 ulp of
    its largest element, bf16_ulp(max|plain|), + KERNEL_ATOL (phase 25's
    gate: 4e-3 to 7.8e-3 of max, by where max lies in its binade), its f32
    output within 1e-3 * max|plain| + KERNEL_ATOL."""
    if not bf16:
        return check_close(name, got, want)
    err, limits = 0.0, []
    for g, w in zip(got, want):
        if g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel {g.dtype}, plain {w.dtype}")
        g, w = g.float(), w.float()
        e, top = (g - w).abs().max().item(), w.abs().max().item()
        limits.append((bf16_ulp(top) if got[0].dtype == torch.bfloat16 else 1e-3 * top) + KERNEL_ATOL)
        if not e <= limits[-1]:
            raise AssertionError(f"{name}: max |kernel - plain| {e} > {limits[-1]} (max|plain| {top})")
        err = max(err, e)
    print(f"[kernel] {name}: max_abs_err {err:.3e} (limit one bf16 ulp of max|plain| + {KERNEL_ATOL} = "
          f"{', '.join(f'{x:.3e}' for x in limits)})", flush=True)
    return err


def launched_one(key, fn):
    """``fn()`` synchronised; raise unless it launched the kernel counted as
    ``key`` (``eqv2_attn_conv1``, ``eqv2_attn_conv1.bf16``, ...) once and
    nothing else."""
    before = dict(kernels.launches)
    out = fn()
    torch.cuda.synchronize()
    if launches_since(before) != {key: 1}:
        raise AssertionError(f"{key}: one call launched {launches_since(before)}")
    return out


def eqv2_key(kernel, bf16):
    """The launch count's name of an EquiformerV2 kernel or its bf16 variant."""
    return kernel + (".bf16" if bf16 else "")


def eqv2_timing(bf16, kernel_fn, f32_fn, plain_fn, iters, plain_iters):
    """(ms, plain ms, text, extra): the kernel's and the plain version's ms
    on the card; for a bf16 variant also its f32 kernel's on the same
    values, in the text and in ``extra`` as the row's ``f32_ms``."""
    ms, plain_ms = cuda_ms(kernel_fn, iters), cuda_ms(plain_fn, plain_iters)
    extra = {}
    if bf16:
        extra["f32_ms"] = cuda_ms(f32_fn, iters)
    text = f"{ms:.4f} ms" + (f", its f32 kernel on the same values {extra['f32_ms']:.4f} ms" if bf16 else "")
    return ms, plain_ms, text + f", plain {plain_ms:.4f} ms", extra


# the bf16 forms with a source of their own (the tensor-core kernels); the other bf16 variants are entries of their
# f32 kernel's source
BF16_SOURCES = {"s2_grid_silu": "s2_grid_silu_bf16", "s2_grid_silu_bwd": "s2_grid_silu_bf16",
                "eqv2_attn_conv1": "eqv2_attn_conv1_bf16", "eqv2_edge_rotate": "eqv2_edge_rotate_bf16"}


def eqv2_source(kernel, bf16):
    """The kernel source (its name in csrc/) of an EquiformerV2 kernel or its bf16 variant."""
    return BF16_SOURCES.get(kernel, kernel) if bf16 else kernel


def eqv2_row(kernel, bf16, err, ms, plain_ms, bound_ms, bound_by, extra):
    """An EquiformerV2 kernel's kernels-line row, its launches filled in by
    its path."""
    return dict(name=eqv2_key(kernel, bf16), source=f"adsorbdiff_tpu_torch/csrc/{eqv2_source(kernel, bf16)}.cu",
                replaces=EQV2_REPLACES[kernel], launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, **extra)


def flops_text(flops, bf16):
    return f"{flops / 1e9:.2f} GFLOP" + (", the bf16 products at the bf16 tensor rate" if bf16 else " f32")


def s2_kernel_checks(device, gen, h, to_m, from_m):
    """Phase 10a (f32 h) or 25 (bf16 h: csrc/s2_grid_silu_bf16.cu):
    s2_grid_silu at a first attention block's input against its plain
    version, then ragged shapes (column counts M x C that are not a multiple
    of a thread's 4 or a block's 512, nor of the bf16 kernel's m16 tiles or
    a warp's 32 columns, at NC 5, 9, 19 and 25, and TINY leads; random NC=32
    tables) in h's dtype; timed beside its bound (bf16: and its f32 kernel
    on the same values, and the SiLU's SFU floor).  Returns the kernels-line
    row, launches 0."""
    bf16 = h.dtype == torch.bfloat16
    key = eqv2_key("s2_grid_silu", bf16)

    def check(name, h_, to_, from_):
        got = launched_one(key, lambda: kernels.s2_grid_silu(h_, to_, from_))
        return got, check_eqv2(f"{key} {name} h{tuple(h_.shape)}", [got],
                               [kernels.s2_grid_silu_reference(h_, to_, from_)], bf16)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device).to(h.dtype)

    out, err = check("at the path's input", h, to_m, from_m)
    for lmax, mmax in ((4, 0), (2, 2), (4, 2), (4, 4)):
        r_to, r_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(lmax, mmax, 18))
        for lead, c in (((1,), 3), ((37,), 16), ((129,), 5), ((41,), 9), ((23,), 8)):
            err = max(err, check(f"ragged NC={r_to.shape[1]}", randn(*lead, r_to.shape[1], c), r_to, r_from)[1])
    tiny_to, tiny_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(*EQV2_TINY[:2], 16))
    for lead in ((37,), (3, 11, 7)):
        err = max(err, check("ragged", randn(*lead, tiny_to.shape[1], 16), tiny_to, tiny_from)[1])
    err = max(err, check("random NC=32 tables", randn(3, 37, 32, 16), randn(324, 32).float() / 32 ** 0.5,
                         randn(32, 324).float() / 32 ** 0.5)[1])
    h32 = h.float()
    ms, plain_ms, text, extra = eqv2_timing(bf16, lambda: kernels.s2_grid_silu(h, to_m, from_m),
                                            lambda: kernels.s2_grid_silu(h32, to_m, from_m),
                                            lambda: kernels.s2_grid_silu_reference(h, to_m, from_m), 20, 5)
    bound_ms, by, nbytes, flops = s2_bound_ms(h, to_m, from_m, out)
    nc, c = h.shape[-2:]
    m = h.numel() // (nc * c)
    if bf16:
        ks, nt, gp, _, _ = kernels.s2_bf16_layout(nc, to_m.shape[0])
        plan = kernels.s2_grid_silu_bf16_plan(m, nc, c, to_m.shape[0], kernels._sm_count(device))
        floor_ms, mhz = sfu_floor_ms(m * c * to_m.shape[0], device)
        design = (f"plan: {plan.blocks} persistent blocks of {plan.threads // 32} warps x 32 columns, NC padded to "
                  f"{16 * ks} (k) and {8 * nt} (n), G to {gp}, {plan.smem_bytes} B shared; the SiLU's SFU floor "
                  f"{floor_ms:.4f} ms at {mhz} MHz ({m * c * to_m.shape[0] / 1e6:.1f} M sigmoids, two SFU operations "
                  f"each, 16 a clock per SM); ptxas (NC = {nc}): "
                  f"{' | '.join(ptxas_lines('s2_grid_silu_bf16', f'ILi{ks}ELi{nt}E')) or 'not built in this process'}")
    else:
        plan = kernels.s2_grid_silu_plan(m, nc, c, to_m.shape[0])
        design = (f"plan: {plan.tile} columns a block ({plan.threads} threads x 4), cluster {plan.cluster}, "
                  f"{plan.blocks} blocks, {plan.smem_bytes} B shared; ptxas (NC = {nc}): "
                  f"{' | '.join(ptxas_lines('s2_grid_silu', f'ILi{nc}E')) or 'not built in this process'}")
    print(f"[kernel] {key} at h{tuple(h.shape)}: {text}, bound {bound_ms:.4f} ms by {by} ({flops_text(flops, bf16)}, "
          f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; {design}", flush=True)
    return eqv2_row("s2_grid_silu", bf16, err, ms, plain_ms, bound_ms, by, extra)


def s2_bwd_kernel_checks(device, gen, h, dy, to_m, from_m):
    """Phase 13b (f32) or 25 (bf16 h and cotangent dy: the variant):
    s2_grid_silu_bwd at a first attention block's input against its plain
    version, bit for bit again on a second call, then ragged shapes (TINY
    leads; column counts M x C that are not a multiple of a thread's 2 or a
    block's 256 at NC 5, 9 and 19; random NC=32 tables; max |g| 100, where
    e^-g overflows) in h's dtype; timed beside its bound (bf16: and its f32
    kernel on the same values).  Returns the kernels-line row, launches 0."""
    bf16 = h.dtype == torch.bfloat16
    key = eqv2_key("s2_grid_silu_bwd", bf16)

    def check(name, h_, dy_, to_, from_):
        got = launched_one(key, lambda: kernels.s2_grid_silu_bwd(h_, dy_, to_, from_))
        if not torch.isfinite(got).all():
            raise AssertionError(f"{key} {name}: non-finite output")
        return got, check_eqv2(f"{key} {name} h{tuple(h_.shape)}", [got],
                               [kernels.s2_grid_silu_bwd_reference(h_, dy_, to_, from_)], bf16)

    def randn(*shape, dtype=h.dtype):
        return torch.randn(shape, generator=gen).to(device).to(dtype)

    out, err = check("at the path's input", h, dy, to_m, from_m)
    if not torch.equal(kernels.s2_grid_silu_bwd(h, dy, to_m, from_m), out):
        raise AssertionError(f"{key} does not repeat bit for bit")
    tiny_to, tiny_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(*EQV2_TINY[:2], 16))
    for lead in ((37,), (3, 11, 7)):
        shape = lead + (tiny_to.shape[1], 16)
        err = max(err, check("ragged", randn(*shape), randn(*shape), tiny_to, tiny_from)[1])
    for lmax, mmax in ((4, 0), (2, 2), (4, 2)):
        r_to, r_from = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(lmax, mmax, 18))
        for lead, c in (((1,), 3), ((37,), 16), ((129,), 5)):
            shape = lead + (r_to.shape[1], c)
            err = max(err, check(f"ragged NC={r_to.shape[1]}", randn(*shape), randn(*shape), r_to, r_from)[1])
    err = max(err, check("random NC=32 tables", randn(3, 37, 32, 16), randn(3, 37, 32, 16),
                         randn(324, 32, dtype=torch.float32) / 32 ** 0.5,
                         randn(32, 324, dtype=torch.float32) / 32 ** 0.5)[1])
    h_large = randn(2, 40, *h.shape[-2:], dtype=torch.float32)
    h_large = (h_large * (100.0 / (to_m @ h_large).abs().max())).to(h.dtype)  # max |g| ~100: e^-g overflows
    err = max(err, check("max |g| 100", h_large, randn(*h_large.shape), to_m, from_m)[1])
    h32, dy32 = h.float(), dy.float()
    ms, plain_ms, text, extra = eqv2_timing(bf16, lambda: kernels.s2_grid_silu_bwd(h, dy, to_m, from_m),
                                            lambda: kernels.s2_grid_silu_bwd(h32, dy32, to_m, from_m),
                                            lambda: kernels.s2_grid_silu_bwd_reference(h, dy, to_m, from_m), 20, 5)
    bound_ms, by, nbytes, flops = s2_bwd_bound_ms(h, dy, to_m, from_m, out)
    nc, c = h.shape[-2:]
    m = h.numel() // (nc * c)
    if bf16:
        ks, nt, gp, _, _ = kernels.s2_bf16_layout(nc, to_m.shape[0])
        plan = kernels.s2_grid_silu_bf16_plan(m, nc, c, to_m.shape[0], kernels._sm_count(device), tiles=2)
        floor_ms, mhz = sfu_floor_ms(m * c * to_m.shape[0], device)
        ptxas = ptxas_lines("s2_grid_silu_bf16", f"bwd_kernelILi{ks}ELi{nt}E")
        design = (f"plan: {plan.blocks} persistent blocks of {plan.threads // 32} warps x 32 columns, NC padded to "
                  f"{16 * ks} (k) and {8 * nt} (n), G to {gp}, {plan.smem_bytes} B shared; the sigmoid's SFU floor "
                  f"{floor_ms / 2:.4f} ms with one tanh.approx each, {floor_ms:.4f} with ex2 and rcp, at {mhz} MHz "
                  f"({m * c * to_m.shape[0] / 1e6:.1f} M sigmoids, 16 SFU operations a clock per SM)")
    else:
        plan = kernels.s2_grid_silu_bwd_plan(m, nc, c, to_m.shape[0], kernels._sm_count(device))
        ptxas = ptxas_lines("s2_grid_silu_bwd", f"ILi{nc}EE")
        design = (f"plan: {plan.blocks} persistent blocks of {plan.threads} threads x 2 columns over "
                  f"{-(-m * c // plan.tile)} groups of {plan.tile} columns, {plan.smem_bytes} B shared")
    print(f"[kernel] {key} at h{tuple(h.shape)}: {text}, bound {bound_ms:.4f} ms by {by} ({flops_text(flops, bf16)}, "
          f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; {design}; ptxas (NC = {nc}): "
          f"{' | '.join(ptxas) or 'not built in this process'}", flush=True)
    return eqv2_row("s2_grid_silu_bwd", bf16, err, ms, plain_ms, bound_ms, by, extra)


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


def conv1_plan(args, kw, bf16=False):
    """The launch plan the wrapper takes for these inputs (with bf16, the
    bf16 kernel's)."""
    nb = kernels.conv1_blocks(kw["lmax"], kw["mmax"])
    rad = args[6]
    width = rad["dense_1"]["kernel"].shape[0]
    plan = kernels.attn_conv1_bf16_plan if bf16 else kernels.attn_conv1_plan
    return plan(args[0].numel(), kw["num_gauss"], args[2].shape[-1], width, args[4].shape[-1], kw["c_out"],
                kw["extra"], nb, kernels._sm_count(args[0].device))


def conv1_ragged_cases(gen, device):
    """Phase 10b's ragged conv1 inputs at TINY and CONV1_L4 widths: E one
    64-edge tile - 1 (one block); one tile a block and 1 edge more (a 1-edge
    tile left over, computed as units, one column pass of a 32-edge half
    each, on other blocks); one tile a block and 17 or 48 edges more (units
    whose last m16 tile is partial, or a half of one m16 tile); 16 edges
    (one m16 tile); 65 edges a block's worth (three tiles left over, one
    partial); a tile whose every slot is masked; a tile whose distances all
    lie past the cutoff (every gaussian slice skipped); and the older ragged
    leads; then ODD widths (C, c_out, extra, gaussians and trunk width that
    no 8 or 16 divides) at the first five leads.  Every plan here takes more
    than 48 KB of shared memory (the designs' least is ~150 KB); no clusters
    are used."""
    sms = kernels._sm_count(device)
    leads = (((63,), None), ((64 * sms + 1,), None), ((64 * sms + 17,), None), ((64 * sms + 48,), None),
             ((16,), None), ((65 * sms,), None), ((129,), "masked"), ((129,), "far"), ((37,), None),
             ((2, 13, 5), None))
    for widths, tag in ((EQV2_TINY, "TINY"), (EQV2_L4, "L4"), (EQV2_ODD, "ODD")):
        for lead, fill in (leads if tag != "ODD" else leads[:5]):
            args, kw = conv1_inputs(gen, device, *widths[:2], lead, *widths[2:])
            if fill is not None:  # the kernel's second tile
                _, e0, n, _ = list(kernels.attn_conv1_work(args[0].numel(), conv1_plan(args, kw).blocks, 1))[1]
                if fill == "masked":
                    args[1].view(-1)[e0:e0 + n] = False
                else:
                    args[0].view(-1)[e0:e0 + n] = 1.5 * kw["cutoff"] + torch.arange(n, dtype=torch.float32,
                                                                                     device=device)
            yield f"{tag} {fill or 'ragged'}", args, kw


def conv1_kernel_checks(device, gen, args, kw):
    """Phase 10b (f32 messages) or 25 (bf16 messages: the variant; f32
    embeddings and weights, as the bf16 model passes them):
    eqv2_attn_conv1 at a first attention block's inputs against its plain
    version, then conv1_ragged_cases with their messages in that dtype;
    timed beside its bound (bf16: and its f32 kernel on the same values).
    Returns the kernels-line row, launches 0."""
    bf16 = args[4].dtype == torch.bfloat16
    key = eqv2_key("eqv2_attn_conv1", bf16)
    source = eqv2_source("eqv2_attn_conv1", bf16)

    def check(name, a, k):
        got = launched_one(key, lambda: kernels.eqv2_attn_conv1(*a, **k))
        return got, check_eqv2(f"{key} {name} E={a[0].numel()} (extra, h)", got,
                               kernels.eqv2_attn_conv1_reference(*a, **k), bf16)

    out, err = check("at the path's inputs", args, kw)
    for name, r_args, r_kw in conv1_ragged_cases(gen, device):
        r_args[4], r_args[5] = r_args[4].to(args[4].dtype), r_args[5].to(args[4].dtype)
        err = max(err, check(name, r_args, r_kw)[1])
    a32 = [t if t.dtype == torch.bool else t.float() for t in args[:6]] + list(args[6:])
    ms, plain_ms, text, extra = eqv2_timing(bf16, lambda: kernels.eqv2_attn_conv1(*args, **kw),
                                            lambda: kernels.eqv2_attn_conv1(*a32, **kw),
                                            lambda: kernels.eqv2_attn_conv1_reference(*args, **kw), 10, 3)
    bound_ms, by, nbytes, flops, dense, nz_rows = conv1_bound_ms(args, kw, out)
    plan = conv1_plan(args, kw, bf16)
    e = args[0].numel()
    print(f"[kernel] {key} at E={e} ({int(args[1].sum())} valid edges, {nz_rows:.2f} non-zero gaussian rows of "
          f"{kw['num_gauss']} per edge): {text}, bound {bound_ms:.4f} ms by {by} ({flops_text(flops, bf16)}; dense "
          f"{dense / 1e9:.2f} GFLOP; {nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; the wrapper's "
          f"weight packing{' and rounding' if bf16 else ''} included; plan: tile {plan.tile} edges, cluster "
          f"{plan.cluster}, {plan.blocks} blocks x {plan.threads} threads, {plan.smem_bytes} B shared; made again (m0 "
          f"gates, units' trunks) {plan.extra_flops_per_edge * e / 1e9:.2f} GFLOP = "
          f"{100 * plan.extra_flops_per_edge * e / flops:.1f}% of the bound's count; ptxas ({source}): "
          f"{' | '.join(ptxas_lines(source)) or 'not built in this process'}", flush=True)
    return eqv2_row("eqv2_attn_conv1", bf16, err, ms, plain_ms, bound_ms, by, extra)


def conv1_counts(args, kw):
    """(packed weights, edges, per-edge FLOP of conv1's products but the
    gaussian rows' (the trunk 2 H (2 Ed + H + NG) and the conv products: m0
    2 x 2 n0 C (extra + n0 c_out), each |m| > 0 block 2 halves x 4 products x
    2 nb C nb c_out), per-edge elementwise FLOP (~20 H for the two
    LayerNorm+SiLU, NG gate multiplies), the gaussian rows that are not
    exactly 0 in f32 on this data, and all R of them)."""
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
    return packed, e, 2 * width * (2 * e_dim + width + ng) + conv, 20 * width + ng, rows, r


def conv1_bound_ms(args, kw, outputs):
    """Per edge conv1_counts's products and elementwise work, and 2 H R'
    for the gaussian rows R' that are not exactly 0 in f32 on this data (all
    R for the dense count); with bf16 messages every product is of two bf16
    values (the variant rounds weights, embeddings, gaussians, y0, y1 and
    the gated messages), the elementwise work f32; every input, packed
    weight and output moved once.  Returns (ms, by, bytes, flops, dense flops, non-zero rows per
    edge)."""
    packed, e, gemm, elem, rows, r = conv1_counts(args, kw)
    width = packed.trunk[0].shape[1]
    products = e * gemm + 2 * width * rows
    flops, dense = products + e * elem, e * (gemm + elem + 2 * width * r)
    tensors = list(args[:6]) + list(packed.trunk) + [packed.flat_conv] + list(outputs)
    bf16_flops = products if args[4].dtype == torch.bfloat16 else 0
    return (*bound(flops, tensors, bf16_flops), flops, dense, rows / e)


def conv1_bwd_bound_ms(args, kw, cts, grads):
    """The conv1 VJP's least work at these inputs: the forward recomputed
    (conv1_bound_ms's count) and, for each of its products, the two of its
    size that give the input's and the weight's gradient, but for the
    gaussian rows only the weight's (the distances take no gradient); twice
    the forward's elementwise work for its backward.  Every input, packed
    weight, cotangent and gradient moved once.  Returns (ms, by, bytes,
    flops)."""
    packed, e, gemm, elem, rows, _ = conv1_counts(args, kw)
    width = packed.trunk[0].shape[1]
    flops = e * (3 * gemm + 3 * elem) + 2 * 2 * width * rows
    tensors = list(args[:6]) + list(packed.trunk) + [packed.flat_conv] + list(cts) + list(grads)
    return (*bound(flops, tensors), flops)


def s2_bwd_bound_ms(h, dy, to_m, from_m, out):
    """3 x 2 G NC per (edge, channel) column for the three products (g
    recomputed, dg, dh; of bf16 values for bf16 h) and ~10 G f32 for the
    sigmoid and silu'; h, dy, both tables and dh moved once."""
    g, nc = to_m.shape
    cols = h.numel() // nc
    products = cols * 6 * g * nc
    flops = products + cols * 10 * g
    return (*bound(flops, [h, dy, to_m, from_m, out], products if h.dtype == torch.bfloat16 else 0), flops)


def rotate_bound_ms(lmax, mmax, n_sel, inputs, out):
    """Per (edge, channel) column: the full block product, 2 sum_l (2l+1)^2;
    the other one on the selected rows only, 2 sum_r (2 l_r + 1); two Dz
    stages, 4 FLOP per |m| > 0 row each (the products of bf16 values for
    bf16 x); per edge, 2 x lmax f32 sincos (~20 FLOP each).  Every input (a
    node table once, however many edges read it) and out moved once."""
    dim = (lmax + 1) ** 2
    j_blocks, _, row = so3.edge_rot_consts(lmax, mmax, n_sel)
    l_of = np.floor(np.sqrt(np.arange(dim))).astype(int)
    selected = int((2 * l_of[row >= 0] + 1).sum())
    c = out.shape[-1]
    edges = out.numel() // (out.shape[-2] * c)
    products = edges * c * (2 * j_blocks.size + 2 * selected + 8 * (dim - lmax - 1))
    flops = products + edges * 40 * lmax
    return (*bound(flops, list(inputs) + [out], products if inputs[0].dtype == torch.bfloat16 else 0), flops)


def check_rotations(device, gen, batch, model, dtype=torch.float32):
    """Phase 13a (f32) or 25 (bf16 x: the variant): eqv2_edge_rotate in
    every form the model runs, at the batch's live graph and the model's
    widths, and each form's VJP (f32: against autograd of the plain chain;
    bf16: against the plain dual rotation, which rounds as the TPU backward
    does), then ragged TINY shapes.  Returns the kernels-line row, launches
    0, its times per launch the mean over the forms in the proportions one
    forward launches them (a bf16 forward runs the edge-degree form in
    f32)."""
    bf16 = dtype == torch.bfloat16
    key = eqv2_key("eqv2_edge_rotate", bf16)
    nl, _, unit = generate_graph(batch, cutoff=model.cutoff, max_neighbors=model.max_neighbors,
                                 cell_reps=model.cell_reps)
    gamma, beta = so3.edge_euler_angles(unit)
    lmax, mmax, c = model.lmax, model.mmax, model.sphere_channels
    b, n, k = nl.src.shape
    dim, n_act, n0 = (lmax + 1) ** 2, so3.n_act_rows(lmax, mmax), lmax + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device).to(dtype)

    x = randn(b, n, dim, c)

    def rotate(direction, n_sel=None, node=False):
        return lambda fn, t: fn(t[:, :, None] if node else t, gamma, beta, lmax, mmax, direction=direction,
                                n_sel=n_sel)

    edge, edge_ref = kernels.eqv2_edge_rotate, kernels.eqv2_edge_rotate_reference
    forms = [  # (name, input, apply(fn, input), n_sel, kernel, plain, the VJP's (direction, src))
        ("to, gathered rows", equiformer_v2.gather_nodes(x, nl.src).contiguous(), rotate("to"), n_act, edge,
         edge_ref, ("to", None)),
        ("to, node-level target half", x, rotate("to", node=True), n_act, edge, edge_ref, ("to", None)),
        ("from, n_sel 19", randn(b, n, k, n_act, c), rotate("from", n_act), n_act, edge, edge_ref, ("from", None)),
        ("from, n_sel 5", randn(b, n, k, n0, c), rotate("from", n0), n0, edge, edge_ref, ("from", None)),
        ("eqv2_gather_rotate_to", x, lambda fn, t: fn(t, nl.src, gamma, beta, lmax, mmax), n_act,
         kernels.eqv2_gather_rotate_to, kernels.eqv2_gather_rotate_to_reference, ("to", nl.src)),
    ]
    err, times = 0.0, {}
    for name, inp, apply, n_sel, kernel, plain, (direction, src) in forms:
        got = launched_one(key, lambda: apply(kernel, inp))
        err = max(err, check_eqv2(f"{key} {name} x{tuple(inp.shape)} -> {tuple(got.shape)}", [got],
                                  [apply(plain, inp)], bf16))
        i32 = inp.float()
        ms, plain_ms, text, extra = eqv2_timing(bf16, lambda: apply(kernel, inp), lambda: apply(kernel, i32),
                                                lambda: apply(plain, inp), 10, 3)
        tables = [inp, gamma, beta] + ([] if src is None else [src])
        bound_ms, by, nbytes, flops = rotate_bound_ms(lmax, mmax, n_sel, tables, got)
        times[name] = (ms, plain_ms, bound_ms, extra.get("f32_ms", ms))
        print(f"[kernel] {key} {name}: {text}, bound {bound_ms:.4f} ms by {by} ({flops_text(flops, bf16)}, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
        # the VJP: the dual rotation (then the K sum or the scatter to the sources)
        ct = randn(*got.shape)
        with torch.enable_grad():
            leaf = inp.clone().requires_grad_(True)
            out = apply(kernel, leaf)
            (dx,) = launched_one(key, lambda: torch.autograd.grad(out, leaf, ct))
            if bf16:
                x_shape = (b, n, 1, dim, c) if name.startswith("to, node") else tuple(inp.shape)
                want = kernels.eqv2_edge_rotate_vjp_reference(ct, src, gamma, beta, lmax, mmax, direction=direction,
                                                              n_sel=n_sel, x_shape=x_shape).reshape(inp.shape)
            else:
                leaf_ref = inp.clone().requires_grad_(True)
                (want,) = torch.autograd.grad(apply(plain, leaf_ref), leaf_ref, ct)
        err = max(err, check_eqv2(f"{key} VJP of {name}", [dx], [want], bf16))
        del got, ct, dx, want, out, leaf, i32
    ragged = [(EQV2_TINY[:2], lead, 16) for lead in ((37,), (3, 11, 7))]
    if bf16:  # every slot count of the bf16 kernel, channel counts no 8 divides (2-byte rows) and 33
        ragged += [((1, 1), (3, 7, 5), 5), ((3, 3), (3, 7, 5), 1), ((5, 2), (2, 9, 4), 33), ((6, 2), (3, 7, 5), 3)]
    for (r_l, r_m), lead, r_c in ragged:
        r_dim, r_act = (r_l + 1) ** 2, so3.n_act_rows(r_l, r_m)
        g_t, b_t = (torch.rand(lead, generator=gen).to(device) * np.pi for _ in range(2))
        for direction, rows in (("to", r_dim), ("from", r_act)):
            a = (randn(*lead, rows, r_c), g_t, b_t, r_l, r_m)
            got = launched_one(key, lambda: edge(*a, direction=direction))
            err = max(err, check_eqv2(f"{key} {direction} ragged lmax {r_l} x{tuple(a[0].shape)}", [got],
                                      [edge_ref(*a, direction=direction)], bf16))
        if len(lead) == 3:  # the gather form: source rows of [B, N, dim, C] node tables
            xn, src_t = randn(lead[0], lead[1], r_dim, r_c), torch.randint(0, lead[1], lead, generator=gen)
            a = (xn, src_t.to(torch.int32).to(device), g_t, b_t, r_l, r_m)
            got = launched_one(key, lambda: kernels.eqv2_gather_rotate_to(*a))
            err = max(err, check_eqv2(f"{key} gather ragged lmax {r_l} x{tuple(xn.shape)}", [got],
                                      [kernels.eqv2_gather_rotate_to_reference(*a)], bf16))
    # per launch, weighted as one forward launches them: per attention the gathered source half, the target
    # half and the value rotation back; the edge-degree embedding once (in f32 in a bf16 forward)
    attn = model.num_layers + 2
    mix = {"eqv2_gather_rotate_to": attn, "to, node-level target half": attn, "from, n_sel 19": attn}
    if not bf16:
        mix["from, n_sel 5"] = 1
    ms, plain_ms, bound_ms, f32_ms = (sum(n_ * times[name][i] for name, n_ in mix.items()) / sum(mix.values())
                                      for i in range(4))
    extra = {"f32_ms": f32_ms} if bf16 else {}
    if bf16:
        layout = kernels.rotate_bf16_layout(lmax, mmax, n_act, "to")
        plan = kernels.rotate_bf16_plan(gamma.numel(), c, layout.p, kernels._sm_count(device), c % 32 == 0)
        ptxas = ptxas_lines("eqv2_edge_rotate_bf16", f"ILi{layout.p}E")
        design = (f"plan: {plan.blocks} persistent blocks of {plan.threads // 32} warps x 32 columns, {layout.p} "
                  f"coefficient slots, {plan.smem_bytes} B shared; ")
    else:
        ptxas, design = ptxas_lines("eqv2_edge_rotate"), ""
    print(f"[kernel] {key} per launch at E={gamma.numel()}, weighted {mix}: {ms:.4f} ms"
          f"{f', its f32 kernel on the same values {f32_ms:.4f} ms' if bf16 else ''}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by bytes, {100 * bound_ms / ms:.1f}% of the bound; {design}ptxas: "
          f"{' | '.join(ptxas) or 'not built in this process'}", flush=True)
    return eqv2_row("eqv2_edge_rotate", bf16, err, ms, plain_ms, bound_ms, "bytes", extra)


@torch.no_grad()  # the sampling path: no autograd
def eqv2_path(device, gen, systems):
    """Phases 10, 11, 12 and 13a."""
    batch = collate(systems, max_atoms=80, device=device)
    model = EquiformerV2(**EQV2_KW, device=device, generator=gen)
    score_fn = make_score_fn(model)
    static = model.prepare_static(batch)
    calls = capture_first_calls(equiformer_v2, ("eqv2_attn_conv1", "s2_grid_silu"), lambda: score_fn(batch, static))

    # 10a-b. s2_grid_silu and eqv2_attn_conv1 at the first attention block's inputs, then ragged shapes
    s2_row = s2_kernel_checks(device, gen, *calls["s2_grid_silu"][0])
    c1_row = conv1_kernel_checks(device, gen, *calls["eqv2_attn_conv1"])
    # 10c. eqv2_attn_conv1's wide route: trunk and embedding widths of 256 at the sampling edge count, where the
    # 64-edge plan does not fit one block's shared memory
    lmax, mmax, c, c_out, extra, r, cutoff = 4, 2, 128, 64, 576, 600, 12.0  # eqv2_so3.yml's first conv
    n_edges = calls["eqv2_attn_conv1"][0][0].numel()
    w_args, w_kw = conv1_inputs(gen, device, lmax, mmax, (n_edges,), c, c_out, extra, r, CONV1_WIDE, cutoff)
    w_route = kernels.attn_conv1_route(CONV1_WIDE, CONV1_WIDE, c, c_out, extra, kernels.conv1_blocks(lmax, mmax))
    if w_route != "wide":
        raise AssertionError(f"eqv2_attn_conv1 at widths {CONV1_WIDE}: route {w_route}, want wide")
    w_out = launched_one("eqv2_attn_conv1", lambda: kernels.eqv2_attn_conv1(*w_args, **w_kw))
    check_close(f"eqv2_attn_conv1 wide route e_dim=hidden={CONV1_WIDE} E={n_edges}", w_out,
                kernels.eqv2_attn_conv1_reference(*w_args, **w_kw))
    w_ms = cuda_ms(lambda: kernels.eqv2_attn_conv1(*w_args, **w_kw), 5)
    w_plain_ms = cuda_ms(lambda: kernels.eqv2_attn_conv1_reference(*w_args, **w_kw), 2)
    w_bound, w_by, w_bytes, w_flops, _, _ = conv1_bound_ms(w_args, w_kw, w_out)
    print(f"[kernel] eqv2_attn_conv1 wide route at E={w_args[0].numel()}, e_dim = hidden = {CONV1_WIDE}, C={c}: "
          f"{w_ms:.4f} ms, plain {w_plain_ms:.4f} ms, bound {w_bound:.4f} ms by {w_by} ({w_flops / 1e9:.2f} GFLOP "
          f"f32, {w_bytes / 1e6:.2f} MB), {100 * w_bound / w_ms:.1f}% of the bound; 16-edge tiles, "
          f"{kernels.attn_conv1_wide_smem(CONV1_WIDE, CONV1_WIDE, c, kernels.conv1_blocks(lmax, mmax))} B shared; "
          f"ptxas: {' | '.join(ptxas_lines('eqv2_attn_conv1_wide')) or 'not built in this process'}", flush=True)
    del calls, w_args, w_out

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
    RATES["eqv2_sample"] = steps * batch.batch_size / wall
    RATES["eqv2_sample_peak"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[eqv2] {steps}-step ODE sampling, B=16 x 80 atoms, eqv2_so3.yml widths: {wall:.3f} s wall, "
          f"{RATES['eqv2_sample']:.2f} system-steps/s, peak {RATES['eqv2_sample_peak']:.1f} MiB allocated, launches "
          f"{launches}, converged_at {int(res.converged_at)}", flush=True)
    forward_ms = RATES["eqv2_forward"] = cuda_ms(lambda: score_fn(batch, static), 5)
    c1_ms, s2_ms = c1_row["ms"], s2_row["ms"]
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
    for row in (s2_row, c1_row, rot_row):
        row["launches"] = launches[row["name"]]
    return [s2_row, c1_row, rot_row]


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
    steps_per_s = RATES["sample"] = PARAMS["num_steps"] * batch.batch_size / wall
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
    and one grouped launch of the triplet bases (e2e, a2e, e2a)."""
    return {"gemnet_quad_chain": model.num_blocks * forwards, "masked_legendre_cos": forwards}


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
    RATES["relax"] = res.nsteps * b / wall
    print(f"[relax] {res.nsteps} L-BFGS steps, B={b}: {wall:.3f} s wall, {res.nsteps * b / wall:.2f} relax "
          f"system-steps/s, peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated, "
          f"{forwards} model forwards, launches {launches}, {res.rebuilds} Verlet rebuilds, "
          f"{int(res.converged.sum())}/{b} converged, largest move {moved:.3f} A", flush=True)
    fn = make_mlff_energy_forces(model)
    cand = model.prepare_candidates(batch, RELAX_OPT["k_cand"])
    forward_ms = RATES["relax_forward"] = cuda_ms(lambda: fn(batch, cand), 5)
    kernel_ms = model.num_blocks * ms + legendre_row["device_ms"]
    print(f"[relax] one model forward (Verlet refresh + 4 blocks + heads): {forward_ms:.3f} ms; "
          f"{model.num_blocks} gemnet_quad_chain launches at {ms:.4f} ms and one masked_legendre_cos launch at "
          f"{legendre_row['device_ms']:.4f} ms of device time = {100 * kernel_ms / forward_ms:.1f}% of it", flush=True)

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


def training_step_inputs(config, systems):
    """check_training_step's config at B=2, its two systems (on the CPU)
    and its schedule draws."""
    small = dict(copy.deepcopy(config), optim=dict(config["optim"], batch_size=2, eval_batch_size=2))
    two = collate(systems or bench_systems(2), max_atoms=80, with_forces=systems is not None, device="cpu")
    return small, two, draw_schedule(2, torch.device("cpu"), torch.Generator().manual_seed(6))


def step_loss_and_grads(tr, b, draws, trainer_cls):
    """A trainer's loss, aux and parameter gradients on batch ``b`` (a
    denoising trainer's step takes ``draws``)."""
    on_device = draws._replace(**{k: getattr(draws, k).to(b.device) for k in draws._fields})
    loss, aux = tr._loss_and_aux(b, on_device if trainer_cls is DenoisingTrainer else None, None)
    return loss, aux, torch.autograd.grad(loss, tr.params)


def check_training_step(config, device, model_name, trainer_cls=DenoisingTrainer, systems=None, checkpoint=None):
    """One training step at B=2 on the card against the same step on the
    CPU: loss, grad_norm and every parameter's gradient.  A denoising
    trainer's step takes the same schedule draws on both sides; an S2EF
    trainer's takes ``systems``, whose energies and forces are the targets.
    Both trainers start from ``checkpoint`` where given."""
    small, two, draws = training_step_inputs(config, systems)
    card, host = trainer_cls(small, device=device), trainer_cls(dict(small, cpu=True))
    results = []
    for tr, b in ((card, two.to(device)), (host, two)):
        tr.init_state()
        if checkpoint is not None:
            tr.load_checkpoint(checkpoint)
        loss, aux, grads = step_loss_and_grads(tr, b, draws, trainer_cls)
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


def launches_since(before):
    """The launch counts added since the snapshot ``before``."""
    return {k: kernels.launches[k] - before.get(k, 0) for k in kernels.launches
            if kernels.launches[k] != before.get(k, 0)}


def train_one_epoch(trainer, steps, want, val_forward=None, val_metrics=("loss",)):
    """trainer.train() with the launch counts zeroed just before and read at
    every step (each step must launch exactly ``want``, and the epoch nothing
    besides but the validations inside train(), each launching
    ``val_forward`` per forward of the EMA model when given); every loss
    finite, params and EMA moved, EMA != params; then ``val_metrics`` of a
    validation finite.  Systems/s over the steps after the first, from the
    end of the first step to the end of the last.  Returns the epoch's
    launches."""
    p0 = [p.detach().clone() for p in trainer.params]
    step_fn, per_step, losses, times, val_runs = trainer.train_step, [], [], [], []

    def counted(*args, **kwargs):
        before = dict(kernels.launches)
        aux = step_fn(*args, **kwargs)
        per_step.append(launches_since(before))
        losses.append(aux["loss"])
        if len(per_step) in (1, steps):  # the timed window runs from the end of the first step to the last's
            torch.cuda.synchronize()
            times.append(time.perf_counter())
        return aux

    trainer.train_step = counted
    if val_forward is not None:
        validate = trainer.validate

        def counted_validate(split="val"):
            forwards = [0]
            hook = trainer.ema_module.register_forward_pre_hook(lambda module, args: forwards.__setitem__(
                0, forwards[0] + 1))
            before = dict(kernels.launches)
            try:
                return validate(split)
            finally:
                hook.remove()
                val_runs.append((forwards[0], launches_since(before)))

        trainer.validate = counted_validate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    try:
        trainer.train()
        torch.cuda.synchronize()
    finally:
        del trainer.train_step
        if val_forward is not None:
            del trainer.validate
    wall = times[-1] - times[0]
    launches = path_launches()
    val_total = collections.Counter()
    for forwards, counts in val_runs:
        if not forwards or counts != {k: forwards * v for k, v in val_forward.items()}:
            raise AssertionError(f"a validation inside train() launched {counts} in {forwards} forwards, want "
                                 f"{val_forward} a forward")
        val_total.update(counts)
    if len(per_step) != steps or any(s != want for s in per_step) or launches != {
            k: steps * v + val_total[k] for k, v in want.items()}:
        raise AssertionError(f"training launched {per_step} ({launches} in all; validations {val_runs}), want "
                             f"{want} in each of {steps} steps and nothing else")
    loss = torch.stack(losses).cpu()
    if not torch.isfinite(loss).all():
        raise AssertionError(f"non-finite training losses: {loss.tolist()}")
    moved = max((p - q).abs().max().item() for p, q in zip(trainer.params, p0))
    ema_moved = max((e - q).abs().max().item() for e, q in zip(trainer.ema, p0))
    ema_gap = max((e - p).abs().max().item() for e, p in zip(trainer.ema, trainer.params))
    if not (moved > 0 and ema_moved > 0 and ema_gap > 0):
        raise AssertionError(f"params moved {moved}, EMA moved {ema_moved}, |EMA - params| {ema_gap}")
    batch = trainer.optim_cfg["batch_size"]
    rate = RATES["epoch"] = (steps - 1) * batch / wall
    peak = RATES["epoch_peak"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[train] {steps} steps, B={batch} x 80 atoms: {rate:.2f} systems/s over the {steps - 1} steps after "
          f"the first ({wall:.3f} s, {1e3 * wall / (steps - 1):.2f} ms per step), peak {peak:.1f} MiB allocated, "
          f"launches {launches} ({len(val_runs)} validation(s) inside train(): {val_runs}); loss "
          f"{loss[0].item():.4f} -> {loss[-1].item():.4f}; max |param move| {moved:.3e}, |EMA move| {ema_moved:.3e}, "
          f"|EMA - params| {ema_gap:.3e}", flush=True)
    metrics = trainer.validate("val")
    val = {k: metrics[k]["metric"] for k in val_metrics}
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"validation metrics {val}")
    print(f"[train] validation (EMA weights): {', '.join(f'{k} {v:.4f}' for k, v in val.items())}", flush=True)
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
    RATES["painn_train"], RATES["painn_train_peak"] = RATES["epoch"], RATES["epoch_peak"]

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
    s2b_row = s2_bwd_kernel_checks(device, gen, h, torch.randn(h.shape, generator=gen).to(device), to_m, from_m)

    # the conv1 VJP: a plain recompute (the TPU kernel has no backward body either), timed at this shape
    conv1_vjp_timing("", device, gen, model, noised, lambda: model(noised))
    del calls, h, noised

    # 14. one epoch of DenoisingTrainer.train(); counts zeroed just before, read at every step
    want = {"s2_grid_silu": per_step, "eqv2_attn_conv1": per_step, "s2_grid_silu_bwd": per_step,
            "eqv2_edge_rotate": 2 * (1 + 3 * per_step)}
    launches = train_one_epoch(trainer, EQV2_TRAIN_STEPS, want)
    RATES["eqv2_train"], RATES["eqv2_train_peak"] = RATES["epoch"], RATES["epoch_peak"]

    # 15. card vs CPU, one training step at B=2
    check_training_step(config, device, "EquiformerV2")
    s2b_row["launches"] = launches["s2_grid_silu_bwd"]
    return s2b_row


def write_config(path, config):
    """``config`` as the YAML file the command line reads; returns the path."""
    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return [plain(v) for v in x] if isinstance(x, (list, tuple)) else x

    with open(path, "w") as f:
        yaml.safe_dump(plain(config), f)
    return path


def relax_config(root, src):
    """gemnet_relax.yml with its dataset entries and relax_dataset at the
    shard ``src``, its traj_dir under ``root`` and eval_batch_size cut to
    S2EF_BATCH."""
    config, _, _ = load_config(RELAX_CONFIG)
    for entry in config["dataset"]:
        entry["src"] = src
    config["task"]["relax_dataset"] = {"src": src}
    config["task"]["relax_opt"]["traj_dir"] = os.path.join(root, "relaxations")
    config["optim"]["eval_batch_size"] = S2EF_BATCH
    return dict(config, run_dir=root, identifier="smoke_relaxer", is_debug=True)  # is_debug: no experiment logger


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


def pipeline_path(device, systems, root):
    """Phase 16: run_pipeline once, sample -> convert -> relax -> score, with
    both trainers built from configs and checkpoints as the command line
    builds them.  Returns ``{"sampler"|"relaxer": (config path, checkpoint
    path), "relax_input": shard}`` for phase 19, and the scored tree
    (``"out_dir"``, ``"dft"``: the targets as a JSON file, ``"rate"``,
    ``"per_system"``) for phase 31's eval command."""
    write_shard(os.path.join(root, "relax_input"), systems)
    relax_input = os.path.join(root, "relax_input.adshard.npz")
    sampler_cfg = dict(copy.deepcopy(TRAIN_CONFIG), run_dir=root, identifier="smoke_pipeline", logger=None,
                       model=dict(TRAIN_CONFIG["model"], cell_reps=MODEL_KW["cell_reps"],
                                  max_ads=MODEL_KW["max_ads"]))
    files = {"relax_input": relax_input}
    t0 = time.perf_counter()
    for name, config, cls in (("sampler", sampler_cfg, DenoisingTrainer),
                              ("relaxer", relax_config(root, relax_input), S2EFTrainer)):
        saver = cls(config, device=device)  # random weights from the trainer's seed
        saver.init_state()
        files[name] = (write_config(os.path.join(root, f"{name}.yml"), config), saver.save("checkpoint"))
        del saver
    sampler = run_pipeline.build_trainer(*files["sampler"], "denoising")
    relaxer = run_pipeline.build_trainer(*files["relaxer"], "s2ef")
    t_build = time.perf_counter() - t0
    forwards, energy_forces = 0, relaxer.energy_forces_fn

    def counted(*args):
        nonlocal forwards
        forwards += 1
        return energy_forces(*args)

    relaxer.energy_forces_fn = counted
    rng = np.random.default_rng(11)
    dft = {str(s.sid): float(rng.normal(-1.0, 1.0)) for s in systems}  # synthetic DFT minima, one per sid
    out_dir = os.path.join(root, "out")
    files["dft"] = os.path.join(root, "dft_targets.json")
    with open(files["dft"], "w") as f:
        json.dump(dft, f)
    print(f"[pipeline] sampler painn_so3.yml widths, {PARAMS['num_steps']} ODE steps, B={len(systems)}; relaxer "
          f"S2EFTrainer (GemNet-OC, gemnet_relax.yml), cell_reps {relaxer.model.cell_reps} (auto), energies "
          f"denormalised by {relaxer.normalizers['energy'].state_dict()}; both built by run_pipeline.build_trainer "
          f"from configs and checkpoints saved first ({t_build:.3f} s); relax_opt {PIPELINE_RELAX_OPT}, "
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
    want_relax = gemnet_launches(relaxer.model, forwards)
    if sample_launches != want_sample or relax_launches != want_relax or launches != {**want_sample, **want_relax}:
        raise AssertionError(f"pipeline launched {launches} (sampling {sample_launches}, want {want_sample}; "
                             f"relaxation {relax_launches}, want {want_relax} for {forwards} forwards)")

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
          f"s = {system_steps / stages['relax']:.2f} relax system-steps/s; {forwards} GemNet-OC forwards of "
          f"{PIPELINE_RELAX_OPT['slots']} slots ({forwards * PIPELINE_RELAX_OPT['slots'] / stages['relax']:.2f} "
          f"slot-steps/s); {engine.host_reads} host reads; {sum(r.converged for r in results.values())} converged; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated; launches {launches}", flush=True)
    print(f"[pipeline] success rate {rate:.4f}; per system {per_system}; anomaly flags (dissociated, desorbed, "
          f"surface changed, intercalated) {flags}", flush=True)
    files.update(out_dir=out_dir, rate=rate, per_system=per_system)
    return files


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


def labelled_systems(systems, seed):
    """``systems`` with synthetic S2EF and IS2RS/IS2RE targets: energy,
    forces (zero on fixed atoms), relaxed energy and relaxed positions (the
    adsorbate moved)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in systems:
        ads = (s.tags == 2)[:, None]
        out.append(System(pos=s.pos, atomic_numbers=s.atomic_numbers, cell=s.cell, tags=s.tags, fixed=s.fixed,
                          sid=s.sid, fid=s.fid, energy=float(rng.normal(-1.0, 1.0)),
                          y_relaxed=float(rng.normal(-1.5, 1.0)),
                          forces=np.where(s.fixed[:, None], 0.0, rng.normal(0.0, 0.5, s.pos.shape)),
                          pos_relaxed=s.pos + np.where(ads, rng.normal(0.0, 0.2, s.pos.shape), 0.0)))
    return out


def check_relaxations(results_dir, traj_dir, systems, metrics):
    """run-relaxations' results: relaxed_positions.npz with every sid once
    and finite positions, fixed atoms where the input has them; one
    trajectory per sid of 2 to S2EF_STEPS + 1 finite frames with fixed atoms
    unmoved; IS2RS and IS2RE metrics logged, finite.  Returns the frames per
    trajectory."""
    relaxed = np.load(os.path.join(results_dir, "relaxed_positions.npz"))
    sids = sorted(str(s.sid) for s in systems)
    if sorted(relaxed["ids"].tolist()) != sids or relaxed["pos"].shape != (sum(s.natoms for s in systems), 3) or \
            not np.isfinite(relaxed["pos"]).all():
        raise AssertionError(f"relaxed_positions.npz: ids {relaxed['ids'].tolist()} (want {sids}), positions "
                             f"{relaxed['pos'].shape}")
    by_sid = {s.sid: s for s in systems}
    offsets = np.concatenate([[0], relaxed["chunk_idx"], [len(relaxed["pos"])]])
    frames = []
    for k, sid in enumerate(relaxed["ids"].tolist()):
        s = by_sid[int(sid)]
        pos = relaxed["pos"][offsets[k]:offsets[k + 1]]
        traj = Trajectory.load(os.path.join(traj_dir, f"{sid}{SUFFIX}"))
        if not (s.fixed.any() and (pos[s.fixed] == s.pos[s.fixed]).all()
                and (traj.positions[:, s.fixed] == s.pos[s.fixed]).all()):
            raise AssertionError(f"relaxation {sid} moved fixed atoms")
        if not 2 <= len(traj) <= S2EF_STEPS + 1 or not all(np.isfinite(x).all() for x in (traj.positions,
                                                                                          traj.energy)):
            raise AssertionError(f"trajectory {sid}: {len(traj)} frames or non-finite values")
        frames.append(len(traj))
    if len(metrics) != 1 or any(len(m) != 3 or not all(np.isfinite(v["metric"]) for v in m.values())
                                for m in metrics[0]):
        raise AssertionError(f"IS2RS/IS2RE metrics logged: {metrics}")
    return frames


def s2ef_tasks_path(device, systems, root, files, smi):
    """Phase 19: validate, predict and run-relaxations (both engines) with the
    S2EF trainer from phase 16's full-width GemNet-OC checkpoint, each with
    its exact launch counts; card against CPU for energy_forces_fn; then the
    pipeline's command line end to end.  Returns the launches summed over
    the four tasks."""
    labelled = labelled_systems(systems, 19)
    write_shard(os.path.join(root, "s2ef"), labelled)
    src = os.path.join(root, "s2ef.adshard.npz")
    ckpt = files["relaxer"][1]
    base = relax_config(root, src)
    base["task"].update(relaxation_steps=S2EF_STEPS, write_pos=True)
    print(f"[s2ef] {smi}; S2EFTrainer from phase 16's GemNet-OC checkpoint (gemnet_relax.yml widths), "
          f"{len(systems)} bench systems with synthetic energy, forces and relaxed targets; cuts: eval_batch_size "
          f"48 -> {S2EF_BATCH}, relaxation_steps 300 -> {S2EF_STEPS}, the command line's --relaxation-steps "
          f"{S2EF_STEPS}", flush=True)
    forwards = collections.Counter()  # model forwards by class, counted by a global forward pre-hook
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, args: forwards.update([type(module).__name__])
        if isinstance(module, (GemNetOC, PaiNN)) else None)
    engine_calls = []
    original = timed_calls(ContinuousRelaxationEngine, "run_dataset", engine_calls)
    total = collections.Counter()
    try:
        for label, mode, relax_opt in (("validate", "validate", {}), ("predict", "predict", {}),
                                       ("relax-batch", "run-relaxations", {"continuous": False}),
                                       ("relax-continuous", "run-relaxations",
                                        {"continuous": "auto", "slots": S2EF_BATCH})):
            cfg = copy.deepcopy(base)
            traj_dir = os.path.join(root, f"trajs-{label}")
            cfg["task"]["relax_opt"].update(relax_opt, traj_dir=traj_dir)
            cfg.update(mode=mode, checkpoint=ckpt, identifier=f"smoke_s2ef_{label}")
            with new_trainer_context(cfg) as ctx:
                trainer, captured = ctx.trainer, []
                if mode == "validate":
                    validate = trainer.validate
                    trainer.validate = lambda split="val": captured.append(validate(split))
                else:
                    trainer._log_relax_metrics = lambda is2rs, is2re, split="val": captured.append((is2rs, is2re))
                del engine_calls[:]
                torch.cuda.synchronize()
                forwards.clear()
                kernels.launches.clear()
                t0 = time.perf_counter()
                ctx.task.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = path_launches()
            want = gemnet_launches(trainer.model, forwards["GemNetOC"])
            if not forwards["GemNetOC"] or launches != want or forwards["PaiNN"]:
                raise AssertionError(f"{label}: launched {launches} in {dict(forwards)} forwards; want {want}")
            total.update(launches)
            if mode == "validate":
                metrics = {k: v["metric"] for k, v in captured[0].items()}
                if not all(np.isfinite(metrics[k]) for k in ("energy_mae", "forces_mae")):
                    raise AssertionError(f"validate: metrics {metrics}")
                what = "metrics " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            elif mode == "predict":
                pred = np.load(os.path.join(trainer.results_dir, "predictions.npz"))
                want_ids = sorted(f"{s.sid}_{s.fid}" for s in systems)
                if sorted(pred["ids"].tolist()) != want_ids or pred["outputs"].dtype != np.float16 or \
                        pred["outputs"].shape != (len(systems), 80, 3) or not np.isfinite(pred["outputs"]).all():
                    raise AssertionError(f"predictions.npz: ids {pred['ids'].tolist()}, outputs "
                                         f"{pred['outputs'].dtype} {pred['outputs'].shape}")
                what = f"predictions.npz holds {len(want_ids)} ids and forces {pred['outputs'].shape} f16, finite"
            else:
                if len(engine_calls) != (relax_opt["continuous"] == "auto"):
                    raise AssertionError(f"{label}: {len(engine_calls)} slot-refill engine runs")
                frames = check_relaxations(trainer.results_dir, traj_dir, labelled, captured)
                what = (f"{'slot-refill' if engine_calls else 'batch'} engine, {sum(frames) - len(frames)} L-BFGS "
                        f"system-steps, trajectories of {min(frames)}-{max(frames)} frames; " + ", ".join(
                            f"{k} {v['metric']:.4f}" for m in captured[0] for k, v in m.items()))
            print(f"[s2ef] {label}: {wall:.3f} s wall, {forwards['GemNetOC']} GemNet-OC forwards, launches "
                  f"{launches}; {what}", flush=True)

        # card against CPU: energy_forces_fn (energy denormalised, fixed atoms' forces zeroed) at B=2
        host = S2EFTrainer(dict(copy.deepcopy(base), cpu=True, identifier="smoke_s2ef_cpu"))
        host.load_checkpoint(ckpt)
        two = collate(labelled[:2], max_atoms=80, device="cpu")
        card = trainer.energy_forces_fn(two.to(device))
        check_model("S2EFTrainer.energy_forces_fn", zip(("energy", "forces"), card, host.energy_forces_fn(two)))
        del host

        # the pipeline's command line end to end, with phase 16's configs and checkpoints
        rng = np.random.default_rng(23)
        targets = os.path.join(root, "targets.pkl")
        with open(targets, "wb") as f:
            pickle.dump({s.sid: [("smoke", float(rng.normal(-1.0, 1.0)))] for s in systems}, f)
        argv = ["--diffusion-config", files["sampler"][0], "--diffusion-ckpt", files["sampler"][1],
                "--relax-config", files["relaxer"][0], "--relax-ckpt", ckpt, "--relax-dataset", files["relax_input"],
                "--out-dir", os.path.join(root, "cli"), "--nsites", "1", "--batch-size", str(len(systems)),
                "--relaxation-steps", str(S2EF_STEPS), "--dft-targets", targets]
        scored, printed = [], []
        score = timed_calls(pipeline, "success_rate", scored)
        handler = logging.Handler()
        handler.emit = lambda record: printed.append(record.getMessage())
        logging.getLogger().addHandler(handler)
        try:
            forwards.clear()
            kernels.launches.clear()
            t0 = time.perf_counter()
            rate = run_pipeline.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = path_launches()
        finally:
            pipeline.success_rate = score
            logging.getLogger().removeHandler(handler)
    finally:
        hook.remove()
        ContinuousRelaxationEngine.run_dataset = original
    scorer_rate = scored[0][3][0] if len(scored) == 1 else None
    lines = [m for m in printed if m.startswith("Success rate:") and "(" not in m]
    if rate is None or rate != scorer_rate or lines != [f"Success rate: {scorer_rate * 100:.1f}%"]:
        raise AssertionError(f"run_pipeline.main returned {rate} and printed {lines}; the scorer gave {scorer_rate}")
    want = {"painn_message_fused": TRAIN_CONFIG["model"]["num_layers"] * forwards["PaiNN"],
            **gemnet_launches(trainer.model, forwards["GemNetOC"])}
    if launches != want:
        raise AssertionError(f"run_pipeline.main launched {launches} in {dict(forwards)} forwards; want {want}")
    step = os.path.join(root, "cli", "0")
    for stage in ("sampled", "relaxations"):
        if sorted(os.listdir(os.path.join(step, stage))) != sorted(f"{s.sid}{SUFFIX}" for s in systems):
            raise AssertionError(f"run_pipeline.main: {stage} holds {os.listdir(os.path.join(step, stage))}")
    print(f"[s2ef] python -m adsorbdiff_tpu_torch.run_pipeline {' '.join(argv)}: {wall:.3f} s wall (both trainers "
          f"built from configs and checkpoints), {forwards['PaiNN']} PaiNN and {forwards['GemNetOC']} GemNet-OC "
          f"forwards, launches {launches}; printed '{lines[0]}', the scorer's rate {scorer_rate:.4f}", flush=True)
    return total


# --------------------------------------------------------------------------
# S2EF training: the quad chain's VJP, gemnet_relax.yml's trainer, card vs CPU
# --------------------------------------------------------------------------
def check_quad_vjp(device, gen, shape, negative_keys=3):
    """gemnet_quad_chain with xm and qp needing gradients: one kernel launch
    for forward and backward, the output, dxm and dqp within the kernel gate
    of autograd through the plain version, for a random cotangent."""
    s = shape[5]
    b, n, u, q, k2, _, e, f = shape
    inputs = quad_inputs(gen, device, *shape, negative_keys=negative_keys)
    g = torch.randn((b, n, u, f, e), generator=gen).to(device)
    leaves = {k: inputs[k].clone().requires_grad_() for k in ("xm", "qp")}
    before = dict(kernels.launches)
    out = kernels.gemnet_quad_chain(**dict(inputs, **leaves), num_spherical=s)
    grads = torch.autograd.grad(out, (leaves["xm"], leaves["qp"]), g)
    torch.cuda.synchronize()
    launched = launches_since(before)
    if launched != {"gemnet_quad_chain": 1}:
        raise AssertionError(f"gemnet_quad_chain forward and backward launched {launched}, want one quad chain")
    plain = {k: inputs[k].clone().requires_grad_() for k in ("xm", "qp")}
    want = kernels.gemnet_quad_chain_reference(**dict(inputs, **plain), num_spherical=s)
    want_grads = torch.autograd.grad(want, (plain["xm"], plain["qp"]), g)
    err = check_close(f"gemnet_quad_chain VJP b,n,u,q,k2,s,e,f={shape} (out, dxm, dqp)", [out.detach(), *grads],
                      [want.detach(), *want_grads])
    return inputs, g, grads, err


def quad_vjp_bound_ms(inputs, g, grads, s):
    """The VJP's least work per cell: the basis ~(4S + 10) per (u, q, k), d2 =
    y . xm and dxm = y^T . dd2 (2 U Q K2 S E each), dd2 = qp . g and dqp =
    g . d2 (2 U S Q F E each); every input, the cotangent g and both
    gradients moved once."""
    b, n, u, q, _ = inputs["n1"].shape
    k2, e = inputs["xm"].shape[3:]
    f = inputs["qp"].shape[-1]
    flops = b * n * (4 * u * q * k2 * s * e + 4 * u * s * q * f * e + u * q * k2 * (4 * s + 10))
    return (*bound(flops, list(inputs.values()) + [g, *grads]), flops)


def quad_vjp_path(device, gen):
    """Phase 20: the quad chain's VJP on the card at the S2EF training shape
    and ragged shapes; the geometry gets no gradient on the card."""
    inputs, g, grads, err = check_quad_vjp(device, gen, QUAD_TRAIN_SHAPE)
    # ragged, as phase 3: two passes of 32 columns e and f; two level passes; S*Q*F odd; every main key -1; U = 1
    for shape, negative_keys in (((2, 3, 7, 4, 13, 7, 40, 48), 3), ((1, 3, 9, 5, 11, 9, 16, 16), 3),
                                 ((2, 4, 10, 3, 7, 5, 12, 9), 3), ((2, 5, 30, 8, 30, 7, 32, 32), 30),
                                 ((2, 5, 1, 8, 30, 7, 32, 32), 0)):
        check_quad_vjp(device, gen, shape, negative_keys)
    s = QUAD_TRAIN_SHAPE[5]
    refused = []
    for name in ("n1", "n2"):
        try:
            kernels.gemnet_quad_chain(**dict(inputs, **{name: inputs[name].clone().requires_grad_()}), num_spherical=s)
        except NotImplementedError:
            refused.append(f"gemnet_quad_chain with {name}")
    a = inputs["n1"][0, 0, :4, 0].clone().requires_grad_()  # [4, 3]: one problem of masked_legendre_cos
    try:
        kernels.masked_legendre_cos(a[None], inputs["n2"][0, 0, 0].t().contiguous()[None],
                                    torch.ones((1, 4, inputs["n2"].shape[3]), dtype=torch.bool, device=device), s)
    except NotImplementedError:
        refused.append("masked_legendre_cos with a")
    if len(refused) != 3:
        raise AssertionError(f"inputs needing a gradient refused only by {refused}")
    fwd_ms = cuda_ms(lambda: kernels.gemnet_quad_chain(**inputs, num_spherical=s), 10)
    vjp = lambda: kernels.gemnet_quad_chain_vjp(**inputs, num_spherical=s, g=g)  # noqa: E731
    ms = cuda_ms(vjp, 5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vjp()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    bound_ms, bound_by, nbytes, flops = quad_vjp_bound_ms(inputs, g, grads, s)
    print(f"[kernel] gemnet_quad_chain VJP (a plain recompute, no kernel) at the S2EF training shape "
          f"{QUAD_TRAIN_SHAPE}: {ms:.4f} ms, peak {peak:.1f} MiB above what was allocated before it, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP f32 = {flops / F32_FLOPS * 1e3:.4f} ms, "
          f"{nbytes / 1e6:.2f} MB = {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), {100 * bound_ms / ms:.1f}% of the bound; "
          f"the forward kernel at that shape {fwd_ms:.4f} ms; refused (no gradient of the geometry on the card): "
          f"{', '.join(refused)}", flush=True)
    return err


def s2ef_train_config(root, paths):
    """gemnet_relax.yml as published, its dataset entries at the train and
    val shards (the relax set at the val shard: the trainer reads it, this
    phase runs no relaxation).  Cuts: max_epochs 80 -> 1, eval_every 5000 ->
    S2EF_TRAIN_STEPS (one validation and one checkpoint, at the epoch's
    end), eval_batch_size 48 -> S2EF_TRAIN_BATCH (the val shard's size)."""
    config, _, _ = load_config(RELAX_CONFIG)
    config["dataset"][0]["src"], config["dataset"][1]["src"] = paths["train"], paths["val"]
    config["task"]["relax_dataset"] = {"src": paths["val"]}
    config["optim"].update(max_epochs=1, eval_every=S2EF_TRAIN_STEPS, eval_batch_size=S2EF_TRAIN_BATCH)
    return dict(config, run_dir=root, identifier="smoke_s2ef_train", is_debug=True)  # is_debug: no logger


def s2ef_training_path(device, root, smi):
    """Phases 21 and 22: S2EFTrainer.train() for one epoch of
    gemnet_relax.yml, its checkpoint reloaded; 3 steps of the GemNet-OC so3
    DenoisingTrainer; card against CPU for one S2EF training step.  Returns
    phase 21's launches."""
    systems = labelled_systems(bench_systems(S2EF_TRAIN_BATCH * (S2EF_TRAIN_STEPS + 1)), 21)
    paths = {}
    for split, part in (("train", systems[:-S2EF_TRAIN_BATCH]), ("val", systems[-S2EF_TRAIN_BATCH:])):
        write_shard(os.path.join(root, "s2ef_" + split), part)
        paths[split] = os.path.join(root, f"s2ef_{split}.adshard.npz")
    config = s2ef_train_config(root, paths)
    trainer = S2EFTrainer(config, device=device)
    optim = trainer.optim_cfg
    print(f"[s2ef-train] {smi}; gemnet_relax.yml as published (trainer: forces, GemNet-OC at its widths, cell_reps "
          f"{trainer.model.cell_reps} (auto), B={optim['batch_size']}, AdamW {optim['lr_initial']}, weight decay "
          f"{optim['optimizer_params']['weight_decay']}, {optim['scheduler_params']['lambda_type']} LambdaLR with "
          f"warm-up, clip {optim['clip_grad_norm']}, EMA {optim['ema_decay']}, force coefficient "
          f"{optim['force_coefficient']}); {len(trainer.train_batcher)} steps on bench systems with synthetic "
          f"energies and forces; cuts: max_epochs 80 -> 1, eval_every 5000 -> {S2EF_TRAIN_STEPS}, eval_batch_size "
          f"48 -> {S2EF_TRAIN_BATCH}", flush=True)
    per_forward = gemnet_launches(trainer.model, 1)
    total = collections.Counter(train_one_epoch(trainer, S2EF_TRAIN_STEPS, per_forward, val_forward=per_forward,
                                                val_metrics=("energy_mae", "forces_mae")))
    RATES["s2ef_train"], RATES["s2ef_train_peak"] = RATES["epoch"], RATES["epoch_peak"]
    # the checkpoint train() saved at the epoch's end, in a fresh trainer: its predictions are the EMA model's
    fresh = S2EFTrainer(config, device=device)
    fresh.load_checkpoint(os.path.join(trainer.ckpt_dir, "checkpoint"))
    batch = next(iter(trainer.val_batcher)).to(device)
    got, want = fresh.predict(batch), trainer.predict(batch)
    if fresh.step != S2EF_TRAIN_STEPS or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"the reloaded checkpoint (step {fresh.step}) predicts otherwise: energy max |diff| "
                             f"{(got[0] - want[0]).abs().max().item()}")
    print(f"[s2ef-train] the checkpoint saved at step {fresh.step} loads into a fresh S2EFTrainer whose predict "
          f"equals the EMA model's bit for bit (energy and forces at B={batch.batch_size})", flush=True)
    del fresh, trainer, batch

    # GemNet-OC so3 denoising training: gemnet_so3.yml + base.yml, 3 steps
    paths = write_training_shards(root, {"so3_train": SO3_TRAIN_BATCH * SO3_TRAIN_STEPS})
    so3 = dict(copy.deepcopy(GEMNET_SO3_CONFIG), run_dir=root, dataset=[{"src": paths["so3_train"]}],
               identifier="smoke_gemnet_so3_train")
    so3["optim"]["batch_size"] = SO3_TRAIN_BATCH
    trainer = DenoisingTrainer(so3, device=device)
    want = gemnet_launches(trainer.model, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    losses, per_step = [], []
    t0 = time.perf_counter()
    for step, (_, batch) in enumerate(trainer._batches(trainer.train_batcher)):
        before = dict(kernels.launches)
        aux = trainer.train_step(batch, generator=torch.Generator(device=device).manual_seed(step))
        per_step.append(launches_since(before))
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    losses = torch.stack(losses).cpu()
    if len(per_step) != SO3_TRAIN_STEPS or any(c != want for c in per_step) or not torch.isfinite(losses).all():
        raise AssertionError(f"GemNet-OC so3 training: launches {per_step}, want {want} in each of {SO3_TRAIN_STEPS} "
                             f"steps; losses {losses.tolist()}")
    total.update(launches)
    RATES["so3_peak"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[so3-train] GemNet-OC gemnet_so3.yml + base.yml, B={SO3_TRAIN_BATCH}, {SO3_TRAIN_STEPS} steps of "
          f"DenoisingTrainer.train_step in {wall:.3f} s, peak {RATES['so3_peak']:.1f} MiB "
          f"allocated, launches {launches}; losses {', '.join(f'{x:.4f}' for x in losses.tolist())}", flush=True)
    del trainer

    # 22. card vs CPU, one S2EF training step at B=2
    check_training_step(config, device, "GemNet-OC S2EF", S2EFTrainer, systems[:2])
    return total


# --------------------------------------------------------------------------
# ROADMAP A.7: Langevin sampling, accumulation, the plateau schedule
# --------------------------------------------------------------------------
def langevin_path(device, systems):
    """Phase 23: 100 steps of Langevin sampling with phase 4's PaiNN (its
    seed, so its weights) at B=16, and 10 steps card against CPU at B=2.
    Returns the run's launches."""
    batch = collate(systems, max_atoms=80, device=device)
    model = PaiNN(**MODEL_KW, device=device, generator=torch.Generator().manual_seed(0))
    params = dict(PARAMS, n_step_each=1)
    engine = DiffusionEngine(make_score_fn(model), params, sampler="langevin", device=device)
    DiffusionEngine(make_score_fn(model), dict(params, num_steps=2), sampler="langevin", device=device).run(
        batch, generator=torch.Generator(device=device).manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    res = engine.run(batch, generator=torch.Generator(device=device).manual_seed(25))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    total = params["num_steps"] * params["n_step_each"]
    if launches != {"painn_message_fused": model.num_layers * total}:
        raise AssertionError(f"Langevin sampling launched {launches}, want painn_message_fused x"
                             f"{model.num_layers * total}")
    traj = res.traj_pos
    if traj.shape != (total + 1, 16, 80, 3) or not torch.isfinite(traj).all() or int(res.converged_at) != total:
        raise AssertionError(f"Langevin trajectory {tuple(traj.shape)}, finite {bool(torch.isfinite(traj).all())}")
    slab, ads = ~batch.ads_mask, batch.ads_mask
    if not torch.equal(traj[:, slab], traj[:1, slab].expand(total + 1, -1, -1)):
        raise AssertionError("Langevin sampling moved slab atoms")
    moved = traj[-1] - traj[0]  # per system one xy translation of every adsorbate atom (f32 sums of 100 steps)
    spread = max((moved[i, ads[i]] - moved[i, ads[i]][:1]).abs().max().item() for i in range(batch.batch_size))
    dz = moved[ads][:, 2].abs().max().item()
    if spread > 1e-3 or dz > 1e-5:
        raise AssertionError(f"Langevin moves are not rigid xy translations: spread {spread}, |dz| {dz}")
    rate = total * batch.batch_size / wall
    print(f"[langevin] {total} Langevin steps (n_step_each 1, step_lr {params.get('step_lr', 1e-4)}), B=16: "
          f"{wall:.3f} s wall, {rate:.1f} system-steps/s (phase 4's reverse diffusion: {RATES['sample']:.1f}), "
          f"launches {launches}; adsorbates moved rigidly in xy (spread {spread:.2e} A, |dz| {dz:.1e} A, largest "
          f"move {moved[ads].norm(dim=-1).amax().item():.3f} A)", flush=True)
    # card against CPU: 10 steps at B=2 from the same frac and noise tensors
    small = collate(systems[:2], max_atoms=80, device=device)
    draws = torch.Generator().manual_seed(26)
    frac, noise = torch.rand((2, 3), generator=draws), torch.randn((10, 2, 3), generator=draws)
    p10 = dict(params, num_steps=10)
    with torch.no_grad():
        card = langevin_dynamics(make_score_fn(model), small, p10, frac=frac.to(device), noise=noise.to(device))
        host = langevin_dynamics(make_score_fn(copy.deepcopy(model).to("cpu")), small.to("cpu"), p10, frac=frac,
                                 noise=noise)
        score = masked_mean(make_score_fn(model)(small)[0], small.ads_mask, dim=1).cpu()
        host_score = masked_mean(make_score_fn(copy.deepcopy(model).to("cpu"))(small.to("cpu"))[0],
                                 small.ads_mask.cpu(), dim=1)
    err = (card.traj_pos.cpu() - host.traj_pos).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"Langevin card vs CPU: positions differ by {err} A after 10 steps")
    print(f"[check] card vs CPU Langevin, 10 steps at B=2: max |diff| of the positions {err:.3e} A (limit 1e-4); "
          f"the first step's mean translation score max |card - cpu| {(score - host_score).abs().max().item():.3e} "
          f"of max |cpu| {host_score.abs().max().item():.3e}, times a step size of at most "
          f"{params.get('step_lr', 1e-4) * (PARAMS['ads_std_high'] / PARAMS['ads_std_low']) ** 2:.4f} A^2",
          flush=True)
    return launches


def sync_sources(record):
    """Run ``record()`` with the sync debug mode on ``warn``: the
    (file, line) of each operation that made the host wait on the card."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{os.path.abspath(w.filename)}:{w.lineno}" for w in seen
                               if "synchronizing" in str(w.message))


def options_training_path(device, root):
    """Phase 24: gemnet_so3.yml + base.yml training at B=16 with
    grad_accumulation_steps 3 (the published effective batch of 48), 6
    micro-steps; then 6 S2EF steps of gemnet_relax.yml with the
    ReduceLROnPlateau schedule.  Returns the launches."""
    total = collections.Counter()
    paths = write_training_shards(root, {"accum_train": SO3_TRAIN_BATCH * ACCUM_STEPS})
    cfg = dict(copy.deepcopy(GEMNET_SO3_CONFIG), run_dir=root, dataset=[{"src": paths["accum_train"]}],
               identifier="smoke_gemnet_so3_accum")
    cfg["optim"].update(batch_size=SO3_TRAIN_BATCH, grad_accumulation_steps=ACCUM_STEPS)
    trainer = DenoisingTrainer(cfg, device=device)
    trainer.init_state()
    batches = [b for _, b in trainer._batches(trainer.train_batcher, depth=0)]
    want = gemnet_launches(trainer.model, 1)
    d = float(np.float32(trainer.ema_decay))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    losses, per_step, moved, ema_moved = [], [], [], []
    prev, prev_ema = trainer._flat.clone(), trainer._ema_flat.clone()
    t0 = time.perf_counter()
    for step in range(2 * ACCUM_STEPS):
        before = dict(kernels.launches)
        aux = trainer.train_step(batches[step % len(batches)],
                                 generator=torch.Generator(device=device).manual_seed(step))
        per_step.append(launches_since(before))
        losses.append(aux["loss"])
        moved.append(not torch.equal(trainer._flat, prev))
        ema_moved.append(not torch.equal(trainer._ema_flat, prev_ema))
        if not torch.equal(trainer._ema_flat, d * prev_ema + float(np.float32(1) - np.float32(d)) * trainer._flat):
            raise AssertionError(f"accumulated training, micro-step {step + 1}: the EMA did not decay toward the "
                                 f"params")
        prev, prev_ema = trainer._flat.clone(), trainer._ema_flat.clone()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = path_launches()
    total.update(launches)
    losses = torch.stack(losses).cpu()
    want_moved = [(step + 1) % ACCUM_STEPS == 0 for step in range(2 * ACCUM_STEPS)]
    if (moved != want_moved or not all(ema_moved[ACCUM_STEPS - 1:]) or any(c != want for c in per_step)
            or not torch.isfinite(losses).all() or int(trainer.count) != 2 or int(trainer.mini_step) != 0):
        raise AssertionError(f"accumulated training: params moved {moved} (want {want_moved}), EMA moved "
                             f"{ema_moved}, launches {per_step} (want {want} each), losses {losses.tolist()}, Adam "
                             f"count {int(trainer.count)}")
    print(f"[accum-train] GemNet-OC gemnet_so3.yml + base.yml, B={SO3_TRAIN_BATCH} x grad_accumulation_steps "
          f"{ACCUM_STEPS} (the published effective batch {SO3_TRAIN_BATCH * ACCUM_STEPS}), {2 * ACCUM_STEPS} "
          f"micro-steps in {wall:.3f} s, peak {peak:.1f} MiB (phase 21's B={SO3_TRAIN_BATCH} so3 steps: "
          f"{RATES['so3_peak']:.1f}); params moved after micro-steps "
          f"{[i + 1 for i, m in enumerate(moved) if m]}, the EMA at {[i + 1 for i, m in enumerate(ema_moved) if m]} "
          f"(equal to its decay toward the params at every one); launches {per_step[0]} each; losses "
          f"{', '.join(f'{x:.4f}' for x in losses.tolist())}", flush=True)
    del trainer, batches

    # ReduceLROnPlateau, factor 0.5, patience 2, on gemnet_relax.yml's S2EF trainer
    systems = labelled_systems(bench_systems(S2EF_TRAIN_BATCH * PLATEAU_STEPS), 26)
    write_shard(os.path.join(root, "plateau_train"), systems)
    src = os.path.join(root, "plateau_train.adshard.npz")
    config = s2ef_train_config(root, {"train": src, "val": src})
    config["optim"].update(scheduler="ReduceLROnPlateau", factor=0.5, patience=2)
    config["identifier"] = "smoke_plateau"
    trainer = S2EFTrainer(config, device=device)
    trainer.init_state()
    batches = [b for _, b in trainer._batches(trainer.train_batcher, depth=0)]
    want = gemnet_launches(trainer.model, 1)
    kernels.launches.clear()
    losses = []
    syncs = sync_sources(lambda: losses.extend(trainer.train_step(b)["loss"] for b in batches))
    launches = path_launches()
    total.update(launches)
    losses = torch.stack(losses).cpu()
    train_dir = os.path.dirname(os.path.abspath(sys.modules[S2EFTrainer.__module__].__file__)) + os.sep
    in_update = {k: v for k, v in syncs.items() if k.startswith(train_dir)}
    state = (trainer.plateau_best, trainer.plateau_count, trainer.plateau_scale)
    if (not torch.isfinite(losses).all() or launches != {k: v * PLATEAU_STEPS for k, v in want.items()}
            or any(t.device.type != "cuda" for t in state) or in_update):
        raise AssertionError(f"plateau training: losses {losses.tolist()}, launches {launches}, state on "
                             f"{[t.device.type for t in state]}, host reads in the trainer {in_update}")
    print(f"[plateau-train] gemnet_relax.yml with scheduler ReduceLROnPlateau (factor 0.5, patience 2), "
          f"B={S2EF_TRAIN_BATCH}, {PLATEAU_STEPS} steps: losses {', '.join(f'{x:.4f}' for x in losses.tolist())}; "
          f"scale {trainer.plateau_scale.item()}, best {trainer.plateau_best.item():.4f}, plateau count "
          f"{trainer.plateau_count.item()} (device tensors); launches {launches}; operations that made the host "
          f"wait during the steps: {dict(syncs) or 'none'} (none in the trainer's update)", flush=True)
    return total


# --------------------------------------------------------------------------
# ROADMAP A.8 step 1: compute_dtype bfloat16 and amp (phases 25-28)
# --------------------------------------------------------------------------
BF16 = torch.bfloat16
# phase 25's gates, bf16 variant against its bf16 plain version (rtol x max|plain| + KERNEL_ATOL): f32 outputs after
# a bf16-rounded basis (f32 sums in another order; a basis value an f32 ulp apart can round to the neighbouring bf16
# number); a bf16 output, one bf16 ulp of the largest element; the quad chain's bf16 output, rounded once from f32
# sums in another order over a longer chain
BF16_RTOL = {"painn_message_fused.bf16": 1e-3, "painn_message_fused_bwd.bf16": 1e-3,
             "masked_legendre_cos.bf16": 4e-3, "gemnet_quad_chain.bf16": 1e-2}
# phases 26-28: a bf16 model on the card against the same bf16 model on the CPU, max|diff| <= 3e-2 * max|cpu|
# (the roundoff spread of bf16 at the test widths, 0.05-0.8% of max for PaiNN and ~1% for GemNet-OC's forces, with
# room for full width), and never more than the CPU's bf16 is from its f32 (a card that stayed in f32 would pass a
# wider limit); a training step: loss within 3e-2 relative, every gradient within 5e-2 * max|cpu| but those of
# BF16_GRAD_LIMITS
BF16_MODEL_RTOL, BF16_LOSS_RTOL, BF16_GRAD_RTOL = 3e-2, 3e-2, 5e-2
# the card's bf16 output (or gradients, as one vector) must be at least this fraction of the CPU's bf16-to-f32
# distance away from the CPU's f32: it rounds where the CPU's bf16 rounds, not nowhere
BF16_SEPARATION = 0.5
BF16_PERTURB = 2e-7  # the relative parameter perturbation of the roundoff spreads printed and checked
# phase 28: no CPU gradient's roundoff spread (its change over BF16_SPREAD_DRAWS passes with parameters x (1 +
# BF16_PERTURB N(0,1))) may pass this fraction of max|cpu|: the fixed limits below were set where it was smaller
BF16_SPREAD_CEILING, BF16_SPREAD_DRAWS = 0.1, 3
# phase 28: the gradients whose bf16 value at B=2 sums so many cancelling terms that roundoff alone moves them past
# 5e-2 of their max, each with its fixed limit (PERF.md section 2); no other gradient is raised
# (PaiNN's: 1.25 x its recorded spread 6.127e-2, rounded up; its card-to-CPU distance read 7.034e-2, its CPU
# bf16-to-f32 distance 4.622e-2, so no per-tensor limit tells bf16 from f32 there: the whole-gradient checks do)
BF16_GRAD_LIMITS = {"PaiNN amp": {"out_forces.output_network.0.vec1_proj.weight": 0.077}, "GemNet-OC S2EF amp": {}}


def bf16_launches(name, count):
    return {name + ".bf16": count}


def check_bf16(name, got, want):
    """check_close at the bf16 variant's gate, outputs compared in f32."""
    return check_close(name, [g.float() for g in got], [w.float() for w in want], BF16_RTOL[name.split(" ")[0]])


def bf16_message_inputs(gen, device, shape, cutoff, nl=None, unit=None, vec_bf16=True):
    inputs = message_inputs(gen, device, *shape, cutoff, nl=nl, unit=unit)
    inputs["xh"] = inputs["xh"].to(BF16)
    if vec_bf16:
        inputs["vec"] = inputs["vec"].to(BF16)
    return inputs


def bf16_plan_line(plan):
    return (f"plan: pre-pass {plan.basis_blocks} blocks of 8 warps, 4 tiles a warp ({plan.tiles} tiles of 8 slots a "
            f"target, up to {plan.chunks} chunks a tile, {plan.scratch_bytes / 1e6:.2f} MB scratch); main kernel "
            f"{plan.tpb} targets a block, {plan.blocks // plan.slices} ranges x {plan.slices} slices of 32 columns = "
            f"{plan.blocks} blocks x {plan.threads} threads, {plan.per_sm} an SM, {plan.waves:.2f} waves, {plan.load} "
            f"targets on a block's busiest warp, {plan.smem_bytes} B shared (W^T rows of {plan.w_stride} bf16)")


def chunk_ratio(inputs, cutoff):
    """Basis rows the bf16 forward kernel multiplies (each 8-slot tile's
    16-row chunks, kernels.painn_bf16_chunks, times its valid slots) over
    the non-zero basis values those slots need."""
    src, dist, mask = inputs["src"], inputs["dist"], inputs["mask"]
    b, n, k = src.shape
    first, last = kernels.painn_bf16_chunks(dist, mask, src, inputs["weight"].shape[0], cutoff)
    valid = mask & (src >= 0) & (src < n)
    per_tile = torch.nn.functional.pad(valid, (0, first.shape[-1] * 8 - k)).reshape(b, n, -1, 8).sum(-1)
    _, rows = basis_rows(inputs, cutoff)
    return float((16 * torch.clamp(last - first + 1, min=0) * per_tile).sum()) / rows


def check_bf16_message(device, gen, shape, cutoff, nl=None, unit=None, vec_bf16=True, fill=None):
    """The bf16 forward against its plain version; ``fill`` as
    message_fill's."""
    inputs = bf16_message_inputs(gen, device, shape, cutoff, nl, unit, vec_bf16)
    plain = message_fill(inputs, fill, shape[1], cutoff)
    before = dict(kernels.launches)
    got = kernels.painn_message_fused(**inputs, cutoff=cutoff)
    torch.cuda.synchronize()
    if launches_since(before) != bf16_launches("painn_message_fused", 1):
        raise AssertionError(f"painn_message_fused with bf16 xh launched {launches_since(before)}")
    plan = kernels.painn_bf16_plan(*shape, kernels._sm_count(device))
    err = check_bf16(f"painn_message_fused.bf16 b,n,k,r,h={shape} vec {'bf16' if vec_bf16 else 'f32'}"
                     f"{' ' + fill if fill else ''} ({bf16_plan_line(plan)})", got,
                     kernels.painn_message_fused_reference(**plain, cutoff=cutoff))
    return inputs, got, err


def check_bf16_message_bwd(device, gen, shape, cutoff, nl=None, unit=None, vec_bf16=True):
    b, n, _, _, h = shape
    inputs = bf16_message_inputs(gen, device, shape, cutoff, nl, unit, vec_bf16)
    cts = (torch.randn((b, n, h), generator=gen).to(device), torch.randn((b, n, 3, h), generator=gen).to(device))
    before = dict(kernels.launches)
    got = kernels.painn_message_fused_bwd(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=cutoff)
    torch.cuda.synchronize()
    if launches_since(before) != bf16_launches("painn_message_fused_bwd", 1):
        raise AssertionError(f"painn_message_fused_bwd with bf16 xh launched {launches_since(before)}")
    err = check_bf16(f"painn_message_fused_bwd.bf16 b,n,k,r,h={shape} vec {'bf16' if vec_bf16 else 'f32'}", got,
                     kernels.painn_message_fused_bwd_reference(**inputs, dx_ct=cts[0], dvec_ct=cts[1],
                                                               cutoff=cutoff))
    return inputs, cts, got, err


def check_bf16_quad(device, gen, shape, negative_keys=3):
    s = shape[5]
    inputs = quad_inputs(gen, device, *shape, negative_keys=negative_keys)
    before = dict(kernels.launches)
    got = kernels.gemnet_quad_chain(**inputs, num_spherical=s, out_dtype=BF16)
    torch.cuda.synchronize()
    if launches_since(before) != bf16_launches("gemnet_quad_chain", 1) or got.dtype != BF16:
        raise AssertionError(f"gemnet_quad_chain with a bf16 out launched {launches_since(before)}, {got.dtype}")
    err = check_bf16(f"gemnet_quad_chain.bf16 b,n,u,q,k2,s,e,f={shape}",
                     [got], [kernels.gemnet_quad_chain_reference(**inputs, num_spherical=s, out_dtype=BF16)])
    return inputs, got, err


# the TPU kernels the bf16 variants' sources replace (the f32 rows' "replaces")
REPLACES = {"painn_message_fused": "adsorbdiff_tpu/ops/pallas_kernels.py:336",
            "painn_message_fused_bwd": "adsorbdiff_tpu/ops/pallas_kernels.py:566",
            "masked_legendre_cos": "adsorbdiff_tpu/ops/pallas_kernels.py:1613",
            "gemnet_quad_chain": "adsorbdiff_tpu/ops/pallas_kernels.py:1728"}


def bf16_row(name, err, ms, plain_ms, bound_ms, bound_by, source=None, **extra):
    """A bf16 variant's kernels-line row (its launches filled in by main);
    ``source``: the file under csrc/ without ``.cu`` where it is not the f32
    kernel's."""
    return dict(name=name + ".bf16", source=f"adsorbdiff_tpu_torch/csrc/{source or name}.cu",
                replaces=REPLACES[name], launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, **extra)


def bf16_kernel_checks(device, gen, systems, relax_model):
    """Phase 25: the four bf16 variants against their bf16 plain versions at
    their paths' shapes and two ragged shapes each, timed beside their bounds
    (bf16 bytes); returns their kernels-line rows, launches still 0."""
    print(f"[bf16] torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction} (cuBLAS's bf16 GEMMs)", flush=True)
    rows = []
    # painn_message_fused: the sampling shape on the bench graph (vec bf16, layers 1-2; vec f32, layers 3-6)
    painn_model = PaiNN(**MODEL_KW, device=device)  # painn_so3.yml's widths
    k, r = painn_model.max_neighbors, painn_model.message_layers[0].rbf_proj.in_features
    h, cutoff = painn_model.hidden_channels, painn_model.cutoff
    del painn_model
    batch = collate(systems, max_atoms=80, device=device)
    nl, _, unit = generate_graph(batch, cutoff=cutoff, max_neighbors=k, cell_reps=MODEL_KW["cell_reps"])
    shape = (batch.batch_size, batch.max_atoms, k, r, h)
    inputs, outputs, err = check_bf16_message(device, gen, shape, cutoff, nl, unit)
    inputs_vf32, _, err_vf32 = check_bf16_message(device, gen, shape, cutoff, nl, unit, vec_bf16=False)
    err = max(err, err_vf32)
    # two ragged shapes of phase 3; K = 1; K = 17 with R = 21, H = 40 and slots past the cutoff; N = 1; sources
    # out of range; each in both entries
    for ragged, fill in (((2, 13, 10, 16, 64), None), ((1, 37, 45, 128, 192), None), ((2, 13, 1, 16, 64), None),
                         ((2, 13, 17, 21, 40), "past-cutoff"), ((3, 1, 6, 16, 64), None),
                         ((2, 13, 10, 16, 64), "bad-src")):
        for vec_bf16 in (True, False):
            err = max(err, check_bf16_message(device, gen, ragged, 6.0, vec_bf16=vec_bf16, fill=fill)[2])
    ms = cuda_ms(lambda: kernels.painn_message_fused(**inputs, cutoff=cutoff), 200)
    dev_ms = device_ms(lambda: kernels.painn_message_fused(**inputs, cutoff=cutoff), 50)
    ms_vf32 = cuda_ms(lambda: kernels.painn_message_fused(**inputs_vf32, cutoff=cutoff), 200)
    widened = dict(inputs, xh=inputs["xh"].float(), vec=inputs["vec"].float())
    f32_ms = cuda_ms(lambda: kernels.painn_message_fused(**widened, cutoff=cutoff), 200)
    plain_ms = cuda_ms(lambda: kernels.painn_message_fused_reference(**inputs, cutoff=cutoff), 5)
    bound_ms, bound_by, nbytes, flops = message_bound_ms(inputs, outputs, cutoff)
    print(f"[kernel] painn_message_fused.bf16 at {shape} (xh, vec bf16): {ms:.4f} ms wall back to back (the "
          f"wrapper's W pack included), {dev_ms:.4f} ms on the device; vec f32 {ms_vf32:.4f} ms; the f32 kernel on "
          f"the same values widened {f32_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops_text(flops, True)}, {nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; its chunks "
          f"multiply {chunk_ratio(inputs, cutoff):.3f}x the non-zero basis rows; "
          f"{bf16_plan_line(kernels.painn_bf16_plan(*shape, kernels._sm_count(device)))}; ptxas: "
          f"{' | '.join(ptxas_lines('painn_message_fused_bf16')) or 'not built in this process'}", flush=True)
    rows.append(bf16_row("painn_message_fused", err, ms, plain_ms, bound_ms, bound_by,
                         source="painn_message_fused_bf16", device_ms=dev_ms, vf32_ms=ms_vf32, f32_kernel_ms=f32_ms))
    del inputs, outputs, inputs_vf32, widened

    # painn_message_fused_bwd: the training shape (B=48) on the bench graph
    big = collate(bench_systems(TRAIN_BATCH), max_atoms=80, device=device)
    nl, _, unit = generate_graph(big, cutoff=cutoff, max_neighbors=k, cell_reps=MODEL_KW["cell_reps"])
    shape = (TRAIN_BATCH, big.max_atoms, k, r, h)
    inputs, cts, outputs, err = check_bf16_message_bwd(device, gen, shape, cutoff, nl, unit)
    err = max(err, check_bf16_message_bwd(device, gen, shape, cutoff, nl, unit, vec_bf16=False)[3])
    for ragged in ((2, 13, 10, 16, 64), (1, 37, 45, 128, 192)):
        err = max(err, check_bf16_message_bwd(device, gen, ragged, 6.0)[3])
    bwd = lambda: kernels.painn_message_fused_bwd(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=cutoff)  # noqa: E731
    ms = cuda_ms(bwd, 10)
    plain_ms = cuda_ms(lambda: kernels.painn_message_fused_bwd_reference(**inputs, dx_ct=cts[0], dvec_ct=cts[1],
                                                                         cutoff=cutoff), 2)
    bound_ms, bound_by, nbytes, flops = message_bwd_bound_ms(inputs, cts, outputs, cutoff)
    print(f"[kernel] painn_message_fused_bwd.bf16 at {shape} (xh, vec bf16): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP f32, {nbytes / 1e6:.2f} MB), "
          f"{100 * bound_ms / ms:.1f}% of the bound; "
          f"{bwd_plan_line(kernels.painn_bwd_plan(*shape, kernels._sm_count(device)))}; ptxas (bf16 instances): "
          f"{' | '.join(ptxas_lines('painn_message_fused_bwd', '__nv_bfloat16')) or 'not built in this process'}",
          flush=True)
    rows.append(bf16_row("painn_message_fused_bwd", err, ms, plain_ms, bound_ms, bound_by))
    del inputs, cts, outputs, big, nl, unit

    # masked_legendre_cos: the grouped call of one B=8 bf16 GemNet-OC forward; two ragged groups
    relax = collate(systems[:RELAX_BATCH], max_atoms=80, device=device)
    s = relax_model.num_spherical
    with torch.no_grad():
        calls = capture_calls(gemnet_oc, "gemnet_cbf_bases", lambda: relax_model(relax))
    if len(calls) != 1 or len(calls[0][0]) != 3 or calls[0][2:] != (BF16,):
        raise AssertionError(f"one bf16 GemNet-OC forward called gemnet_cbf_bases as {[c[1:] for c in calls]}")
    problems = [tuple(p) for p in calls[0][0]]
    del calls

    def group(probs):
        before = dict(kernels.launches)
        got = kernels.gemnet_cbf_bases(probs, s, BF16)
        torch.cuda.synchronize()
        if launches_since(before) != bf16_launches("masked_legendre_cos", 1):
            raise AssertionError(f"gemnet_cbf_bases in bf16 launched {launches_since(before)}")
        return got, check_bf16(f"masked_legendre_cos.bf16 group (M, K) {[(u.shape[2], v.shape[2]) for u, v, _ in probs]}"
                               f" S={s}", [g for g in got if g.numel()],
                               [kernels.gemnet_cbf_basis_reference(*p, s, BF16) for p, g in zip(probs, got)
                                if g.numel()])

    outs, err = group(problems)
    for shapes in ([((3, 5), 29, 12), ((3, 5), 12, 20)], [((2, 3), 7, 5), ((2, 3), 5, 3)]):
        err = max(err, group([legendre_inputs(gen, device, lead + (m,), lead + (k,), lead + (m, k), unit=True)
                              for lead, m, k in shapes])[1])
    ms = cuda_ms(lambda: kernels.gemnet_cbf_bases(problems, s, BF16), 200)
    dev_ms = device_ms(lambda: kernels.gemnet_cbf_bases(problems, s, BF16), 20)
    plain_ms = cuda_ms(lambda: [kernels.gemnet_cbf_basis_reference(*p, s, BF16) for p in problems], 5)
    bounds = [legendre_bound_ms(p, out, s) for p, out in zip(problems, outs)]
    bound_ms, nbytes, flops = (sum(b[i] for b in bounds) for i in (0, 2, 3))
    by = "bytes" if {b[1] for b in bounds} == {"bytes"} else "operations"
    print(f"[kernel] masked_legendre_cos.bf16, one grouped launch a bf16 forward: wall {ms:.4f} ms, device "
          f"{dev_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB), "
          f"{100 * bound_ms / dev_ms:.1f}% of the bound on the device; ptxas (bf16 instance): "
          f"{' | '.join(ptxas_lines('masked_legendre_cos', '__nv_bfloat16')) or 'not built in this process'}",
          flush=True)
    rows.append(bf16_row("masked_legendre_cos", err, ms, plain_ms, bound_ms, by, device_ms=dev_ms))
    del outs, problems

    # gemnet_quad_chain: f32 xm and qp, bf16 out (the model's) at the relaxation shape and two ragged shapes
    shape = (relax.batch_size, relax.max_atoms, relax_model.max_neighbors, relax_model.max_neighbors_qint,
             relax_model.max_neighbors, s, relax_model.emb_size_quad_in, relax_model.emb_size_sbf)
    inputs, out, err = check_bf16_quad(device, gen, shape)
    for ragged in ((2, 7, 12, 4, 13, 4, 8, 8), (2, 3, 7, 4, 13, 7, 40, 48)):
        err = max(err, check_bf16_quad(device, gen, ragged)[2])
    ms = cuda_ms(lambda: kernels.gemnet_quad_chain(**inputs, num_spherical=s, out_dtype=BF16), 20)
    plain_ms = cuda_ms(lambda: kernels.gemnet_quad_chain_reference(**inputs, num_spherical=s, out_dtype=BF16), 5)
    bound_ms, bound_by, nbytes, flops = quad_bound_ms(inputs, out, s)
    print(f"[kernel] gemnet_quad_chain.bf16 at {shape}, f32 xm and qp, bf16 out (GemNet-OC's bf16 path): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP "
          f"f32, {nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound; "
          f"{quad_plan_line(kernels.quad_chain_plan(shape[0] * shape[1], *shape[2:], kernels._sm_count(device)))}"
          f"; ptxas (bf16 instance): "
          f"{' | '.join(ptxas_lines('gemnet_quad_chain', '__nv_bfloat16')) or 'not built in this process'}",
          flush=True)
    rows.append(bf16_row("gemnet_quad_chain", err, ms, plain_ms, bound_ms, bound_by))
    del inputs, out
    # its VJP at the S2EF training shape, as the bf16 training step runs it: f32 xm and qp, a bf16 out and
    # cotangent; the backward recomputes the plain version in xm's dtype
    b, n, u, q, k2, s_, e, f = QUAD_TRAIN_SHAPE
    inputs = quad_inputs(gen, device, *QUAD_TRAIN_SHAPE)
    g = torch.randn((b, n, u, f, e), generator=gen).to(device).to(BF16)
    leaves = {k: inputs[k].clone().requires_grad_() for k in ("xm", "qp")}
    before = dict(kernels.launches)
    out = kernels.gemnet_quad_chain(**dict(inputs, **leaves), num_spherical=s_, out_dtype=BF16)
    grads = torch.autograd.grad(out, (leaves["xm"], leaves["qp"]), g)
    torch.cuda.synchronize()
    if launches_since(before) != bf16_launches("gemnet_quad_chain", 1):
        raise AssertionError(f"the bf16 quad chain's forward and VJP launched {launches_since(before)}")
    plain = {k: inputs[k].clone().requires_grad_() for k in ("xm", "qp")}
    want = kernels.gemnet_quad_chain_reference(**dict(inputs, **plain), num_spherical=s_, out_dtype=BF16)
    want_grads = torch.autograd.grad(want, (plain["xm"], plain["qp"]), g)
    check_bf16(f"gemnet_quad_chain.bf16 VJP at {QUAD_TRAIN_SHAPE} (out, dxm, dqp)", [out.detach(), *grads],
               [want.detach(), *want_grads])
    vjp_ms = cuda_ms(lambda: kernels.gemnet_quad_chain_vjp(**inputs, num_spherical=s_, g=g), 5)
    print(f"[kernel] gemnet_quad_chain.bf16 VJP (a plain f32 recompute) at {QUAD_TRAIN_SHAPE}: {vjp_ms:.4f} ms",
          flush=True)
    return rows


def rel_dist(a, b):
    """max|a - b| / max|b|."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def check_bf16_training_step(config, device, model_name, trainer_cls=DenoisingTrainer, systems=None):
    """Phase 28's training step under amp at B=2 on the card against the
    same step on the CPU in bf16 and, from the same parameters, in f32 (amp
    off); every distance is max|diff| / max|cpu bf16| of its tensor:
    - the loss within BF16_LOSS_RTOL, grad_norm and every gradient within
      BF16_GRAD_RTOL, or within the gradient's fixed entry of
      BF16_GRAD_LIMITS[model_name];
    - no CPU bf16 gradient's roundoff spread (BF16_SPREAD_DRAWS passes with
      parameters x (1 + BF16_PERTURB N(0,1))) past BF16_SPREAD_CEILING;
    - the gradients as one vector: card bf16 at most as far from CPU bf16
      as CPU f32 is, and at least BF16_SEPARATION of that from CPU f32.
    The faults are raised together after the printout."""
    small, two, draws = training_step_inputs(config, systems)
    card, host = trainer_cls(small, device=device), trainer_cls(dict(small, cpu=True))
    host32 = trainer_cls(dict(small, cpu=True, amp=False))
    if host32.model.compute_dtype is not None:
        raise AssertionError(f"amp off built a {host32.model.compute_dtype} model")
    for tr in (card, host, host32):
        tr.init_state()
    with torch.no_grad():
        host32._flat.copy_(host._flat)
    results = [step_loss_and_grads(tr, b, draws, trainer_cls) for tr, b in
               ((card, two.to(device)), (host, two), (host32, two))]
    names = [n for n, _ in host.model.named_parameters()]
    host_grads, host32_grads = results[1][2], results[2][2]
    spread = {name: 0.0 for name in names}
    rng = torch.Generator().manual_seed(29)
    for _ in range(BF16_SPREAD_DRAWS):
        saved = host._flat.clone()
        with torch.no_grad():
            host._flat.mul_(1 + BF16_PERTURB * torch.randn(host._flat.shape, generator=rng))
        grads = step_loss_and_grads(host, two, draws, trainer_cls)[2]
        with torch.no_grad():
            host._flat.copy_(saved)
        for name, g, h in zip(names, grads, host_grads):
            spread[name] = max(spread[name], rel_dist(g, h))
    (card_aux, card_grads), (host_aux, _) = [(tr._finalize_train_step(loss, aux, list(grads)), [g.cpu() for g in grads])
                                             for tr, (loss, aux, grads) in zip((card, host), results[:2])]
    fixed = BF16_GRAD_LIMITS[model_name]
    faults, rows = [], []
    for name, c, h, h32 in zip(names, card_grads, host_grads, host32_grads):
        row = dict(name=name, err=rel_dist(c, h), limit=fixed.get(name, BF16_GRAD_RTOL), spread=spread[name],
                   cpu_bf16_vs_f32=rel_dist(h32, h),
                   card_vs_cpu_f32=(c - h32).abs().max().item() / max(h.abs().max().item(), 1e-30))
        rows.append(row)
        if not (torch.isfinite(c).all() and row["err"] <= row["limit"]):
            faults.append(f"{name}: {row['err']:.3e} > {row['limit']}")
        if row["spread"] > BF16_SPREAD_CEILING:
            faults.append(f"{name}: roundoff spread {row['spread']:.3e} > {BF16_SPREAD_CEILING}")
    for name, c, h, r in (("loss", card_aux["loss"].cpu(), host_aux["loss"], BF16_LOSS_RTOL),
                          ("grad_norm", card_aux["grad_norm"].cpu(), host_aux["grad_norm"], BF16_GRAD_RTOL)):
        if not rel_dist(c, h) <= r:
            faults.append(f"{name}: {rel_dist(c, h):.3e} > {r}")
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs])  # noqa: E731
    c_all, h_all, h32_all = flat(card_grads), flat(host_grads), flat(host32_grads)
    e_all, d32_all = rel_dist(c_all, h_all), rel_dist(h32_all, h_all)
    sep_all = (c_all - h32_all).abs().max().item() / h_all.abs().max().item()
    if not e_all <= d32_all:
        faults.append(f"all gradients: card to CPU bf16 {e_all:.3e} > CPU bf16 to f32 {d32_all:.3e}")
    if not sep_all >= BF16_SEPARATION * d32_all:
        faults.append(f"all gradients: card bf16 to CPU f32 {sep_all:.3e} < {BF16_SEPARATION} x {d32_all:.3e}: "
                      "the card did not round as bf16 does")
    worst = max(rows, key=lambda r: r["err"])
    print(f"[check] card vs CPU {model_name} training step at B=2: loss {card_aux['loss'].item():.6f} / "
          f"{host_aux['loss'].item():.6f} (cpu f32 {results[2][0].item():.6f}), grad_norm "
          f"{card_aux['grad_norm'].item():.6f} / {host_aux['grad_norm'].item():.6f}; {len(names)} gradients, worst "
          f"max|diff| / max|cpu| {worst['err']:.3e} ({worst['name']}, limit {worst['limit']}; {BF16_GRAD_RTOL} but "
          f"{len(fixed)} fixed); {sum(r['err'] > r['cpu_bf16_vs_f32'] for r in rows)} gradient(s) further from cpu "
          f"bf16 than cpu f32 is (at their roundoff floor); all gradients as one vector: card bf16 to cpu bf16 "
          f"{e_all:.3e}, cpu bf16 to cpu "
          f"f32 {d32_all:.3e}, card bf16 to cpu f32 {sep_all:.3e}; roundoff spread of {BF16_SPREAD_DRAWS} passes "
          f"with parameters x (1 + {BF16_PERTURB} N(0,1)): median "
          f"{float(np.median([r['spread'] for r in rows])):.3e}, largest {max(r['spread'] for r in rows):.3e} "
          f"(ceiling {BF16_SPREAD_CEILING})", flush=True)
    for r in sorted(rows, key=lambda r: -r["err"]):
        if r["err"] > BF16_GRAD_RTOL / 2 or r["name"] in fixed:
            print(f"[check]   {r['name']}: card vs cpu bf16 {r['err']:.3e} (limit {r['limit']}), spread "
                  f"{r['spread']:.3e}, cpu bf16 vs cpu f32 {r['cpu_bf16_vs_f32']:.3e}, card bf16 vs cpu f32 "
                  f"{r['card_vs_cpu_f32']:.3e}", flush=True)
    if faults:
        raise AssertionError(f"card vs CPU {model_name} training step: " + "; ".join(faults))


def bf16_card_vs_cpu(what, model16, model32, small, heads, fixed=None):
    """A bf16 model at B=2 on the card against the same model on the CPU,
    per output within BF16_MODEL_RTOL * max|cpu| and within the CPU's bf16
    distance from its f32 forward, or within the ``fixed`` fraction of
    max|cpu| where that is given, and at least BF16_SEPARATION of that
    distance from the f32 forward; printed beside the spread of three CPU
    bf16 forwards whose parameters are perturbed by BF16_PERTURB relative,
    which must stay below a ``fixed`` limit."""
    cpu16 = copy.deepcopy(model16).to("cpu")
    cpu32 = copy.deepcopy(model32).to("cpu")
    host_batch = small.to("cpu")

    def outputs(model, batch):
        with torch.no_grad():
            out = model(batch)
        out = out if isinstance(out, dict) else dict(zip(heads, out if isinstance(out, tuple) else (out,)))
        return {h: out[h].float().cpu() for h in heads}

    t0 = time.perf_counter()
    card, host, host32 = outputs(model16, small), outputs(cpu16, host_batch), outputs(cpu32, host_batch)
    t_cpu = time.perf_counter() - t0
    spread = {h: 0.0 for h in heads}
    rng = torch.Generator().manual_seed(27)
    for _ in range(3):
        perturbed = copy.deepcopy(cpu16)
        with torch.no_grad():
            for p in perturbed.parameters():
                p.mul_(1 + BF16_PERTURB * torch.randn(p.shape, generator=rng))
        out = outputs(perturbed, host_batch)
        for h in heads:
            spread[h] = max(spread[h], ((out[h] - host[h]).abs().max() / host[h].abs().max()).item())
    for h in heads:
        if card[h].dtype != torch.float32 or not torch.isfinite(card[h]).all():
            raise AssertionError(f"card bf16 {what} {h}: {card[h].dtype}, finite {bool(torch.isfinite(card[h]).all())}")
        e, sep, d32 = rel_dist(card[h], host[h]), rel_dist(card[h], host32[h]), rel_dist(host[h], host32[h])
        limit = min(BF16_MODEL_RTOL, d32) if fixed is None else fixed
        print(f"[bf16] card vs CPU {what} {h} at B=2: max|card bf16 - cpu bf16| / max|cpu bf16| {e:.3e} (limit "
              f"{limit:.3e}, " + (f"the smaller of {BF16_MODEL_RTOL} and " if fixed is None else "fixed; ") +
              f"cpu bf16 vs cpu f32 {d32:.3e}); card bf16 vs cpu f32 {sep:.3e} (at least {BF16_SEPARATION} x "
              f"{d32:.3e}); spread of 3 cpu bf16 forwards with parameters x (1 + {BF16_PERTURB} N(0,1)) "
              f"{spread[h]:.3e}{'' if fixed is None else ' (below the limit)'}; CPU forwards {t_cpu:.1f} s", flush=True)
        if fixed is not None and not spread[h] < fixed:
            raise AssertionError(f"cpu bf16 {what} {h}: roundoff spread {spread[h]} reaches the fixed limit {fixed}")
        if not e <= limit:
            raise AssertionError(f"card vs CPU bf16 {what} {h}: {e} > {limit}")
        if not sep >= BF16_SEPARATION * d32:
            raise AssertionError(f"card bf16 {what} {h} is {sep} from the CPU's f32, less than {BF16_SEPARATION} x "
                                 f"the CPU's bf16-to-f32 {d32}: the card did not round as bf16 does")


def rigid_adsorbates(res, batch):
    """Slab unmoved and every adsorbate's interatomic distances kept, from
    the first frame to the last (reverse diffusion moves it as a rigid
    body); returns the largest change of such a distance."""
    slab, ads = ~batch.ads_mask, batch.ads_mask
    traj = res.traj_pos
    if not torch.equal(traj[:, slab], traj[:1, slab].expand(len(traj), -1, -1)):
        raise AssertionError("bf16 sampling moved slab atoms")
    worst = 0.0
    for i in range(batch.batch_size):
        a, z = traj[0, i][ads[i]], traj[-1, i][ads[i]]
        worst = max(worst, (torch.cdist(a[None], a[None]) - torch.cdist(z[None], z[None])).abs().max().item())
    if worst > 1e-3:
        raise AssertionError(f"bf16 sampling deformed an adsorbate: a distance changed by {worst} A")
    return worst


def bf16_sampling_path(device, systems):
    """Phase 26: PaiNN in bf16 at the painn_so3.yml widths, card vs CPU at B=2
    and 100 ODE steps at B=16 with the hoisted static graph.  Returns the
    run's launches."""
    model16 = PaiNN(**MODEL_KW, compute_dtype="bfloat16", device=device, generator=torch.Generator().manual_seed(0))
    model32 = PaiNN(**MODEL_KW, device=device, generator=torch.Generator().manual_seed(0))  # phase 4's weights
    bf16_card_vs_cpu("PaiNN", model16, model32, collate(systems[:2], max_atoms=80, device=device),
                     ("out_forces", "out_forces2"))
    del model32
    batch = collate(systems, max_atoms=80, device=device)
    engine = DiffusionEngine(make_score_fn(model16), PARAMS, static_fn=model16.prepare_static, device=device)
    DiffusionEngine(make_score_fn(model16), dict(PARAMS, num_steps=2), static_fn=model16.prepare_static,
                    device=device).run(batch, generator=torch.Generator(device=device).manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    res = engine.run(batch, generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    want = bf16_launches("painn_message_fused", model16.num_layers * PARAMS["num_steps"])
    if launches != want:
        raise AssertionError(f"bf16 sampling launched {launches}, want {want} and no f32 launch")
    if res.traj_pos.dtype != torch.float32 or not torch.isfinite(res.traj_pos).all():
        raise AssertionError("bf16 sampling: positions not finite f32")
    worst = rigid_adsorbates(res, batch)
    rate = PARAMS["num_steps"] * batch.batch_size / wall
    print(f"[bf16-sample] 100-step ODE sampling in bf16, B=16: {wall:.3f} s wall, {rate:.1f} system-steps/s (phase "
          f"4's f32: {RATES['sample']:.1f}), peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches "
          f"{launches}; slab unmoved, adsorbate distances kept within {worst:.1e} A", flush=True)
    return launches


def bf16_relax_kw(device, systems):
    """Phase 6's GemNet-OC arguments (gemnet_relax.yml widths, cell_reps from
    auto_cell_reps of ``systems``)."""
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], GEMNET_KW["cutoff"])
    return dict(GEMNET_KW, cell_reps=cell_reps, device=device)


def bf16_relax_path(device, systems, model16, kw):
    """Phase 27: ``model16`` (GemNet-OC in bf16 at the gemnet_relax.yml
    widths, phase 6's seed and so its weights), card vs CPU at B=2 and 100
    L-BFGS steps at B=8 with the Verlet graph.  Returns the run's
    launches."""
    model32 = GemNetOC(**kw, generator=torch.Generator().manual_seed(3))  # the same weights in f32
    bf16_card_vs_cpu("GemNet-OC", model16, model32, collate(systems[:2], max_atoms=80, device=device),
                     ("energy", "forces"))
    del model32
    batch = collate(systems, max_atoms=80, device=device)
    b, n = batch.batch_size, batch.max_atoms
    RelaxationEngine.from_model(model16, dict(RELAX_OPT, steps=2), device=device).run(batch)  # warm-up
    engine = RelaxationEngine.from_model(model16, RELAX_OPT, device=device)
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
    want = {k + ".bf16": v for k, v in gemnet_launches(model16, forwards).items()}
    if launches != want:
        raise AssertionError(f"bf16 relaxation launched {launches}, want {want} ({forwards} forwards)")
    for name in ("traj_pos", "traj_energy", "traj_forces", "energy", "forces"):
        t = getattr(res, name)
        if t.dtype != torch.float32 or not torch.isfinite(t).all():
            raise AssertionError(f"bf16 relaxation {name}: {t.dtype}, finite {bool(torch.isfinite(t).all())}")
    fixed = batch.fixed & batch.atom_mask
    if not (bool(fixed.any()) and torch.equal(res.traj_pos[:, fixed], batch.pos[fixed].expand(len(res.traj_pos), -1, -1))):
        raise AssertionError("bf16 relaxation moved fixed atoms")
    rate = res.nsteps * b / wall
    print(f"[bf16-relax] {res.nsteps} L-BFGS steps in bf16, B={b}: {wall:.3f} s wall, {rate:.2f} relax "
          f"system-steps/s (phase 6's f32: {RATES['relax']:.2f}), peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB, {forwards} model forwards, launches {launches}, {res.rebuilds} Verlet rebuilds; fixed atoms unmoved, "
          f"largest move {(res.batch.pos - batch.pos).norm(dim=-1).amax().item():.3f} A", flush=True)
    fn = make_mlff_energy_forces(model16)
    cand = model16.prepare_candidates(batch, RELAX_OPT["k_cand"])
    print(f"[bf16-relax] one bf16 model forward: {cuda_ms(lambda: fn(batch, cand), 5):.3f} ms (phase 6's f32: "
          f"{RATES['relax_forward']:.3f} ms)", flush=True)
    return launches


def bf16_training_path(device, root):
    """Phase 28: DenoisingTrainer.train() (painn_so3.yml + base.yml, phase 8's
    cut) and S2EFTrainer.train() (gemnet_relax.yml, phase 21's cut) with
    amp: true; one step of each at B=2 card against CPU.  Returns the
    launches."""
    total = collections.Counter()
    paths = write_training_shards(root, {"bf16_train": TRAIN_BATCH * TRAIN_STEPS, "bf16_val": TRAIN_BATCH})
    config = dict(copy.deepcopy(TRAIN_CONFIG), run_dir=root, amp=True, identifier="smoke_bf16",
                  dataset=[{"src": paths["bf16_train"]}, {"src": paths["bf16_val"]}])
    trainer = DenoisingTrainer(config, device=device)
    if trainer.model.compute_dtype != "bfloat16":
        raise AssertionError(f"amp built a {trainer.model.compute_dtype} model")
    layers = trainer.model.num_layers
    total.update(train_one_epoch(trainer, TRAIN_STEPS, {"painn_message_fused.bf16": layers,
                                                        "painn_message_fused_bwd.bf16": layers}))
    print(f"[bf16-train] PaiNN with amp: {RATES['epoch']:.2f} systems/s (phase 8's f32: {RATES['painn_train']:.2f}), "
          f"peak {RATES['epoch_peak']:.1f} MiB (f32: {RATES['painn_train_peak']:.1f})", flush=True)
    if trainer.ema_module.compute_dtype != "bfloat16":
        raise AssertionError("amp: the EMA model does not compute in bf16")
    del trainer
    check_bf16_training_step(config, device, "PaiNN amp")

    systems = labelled_systems(bench_systems(S2EF_TRAIN_BATCH * (S2EF_TRAIN_STEPS + 1)), 28)
    spaths = {}
    for split, part in (("train", systems[:-S2EF_TRAIN_BATCH]), ("val", systems[-S2EF_TRAIN_BATCH:])):
        write_shard(os.path.join(root, "bf16_s2ef_" + split), part)
        spaths[split] = os.path.join(root, f"bf16_s2ef_{split}.adshard.npz")
    config = dict(s2ef_train_config(root, spaths), amp=True, identifier="smoke_bf16_s2ef")
    trainer = S2EFTrainer(config, device=device)
    per_forward = {k + ".bf16": v for k, v in gemnet_launches(trainer.model, 1).items()}
    total.update(train_one_epoch(trainer, S2EF_TRAIN_STEPS, per_forward, val_forward=per_forward,
                                 val_metrics=("energy_mae", "forces_mae")))
    print(f"[bf16-train] GemNet-OC S2EF with amp: {RATES['epoch']:.2f} systems/s (phase 21's f32: "
          f"{RATES['s2ef_train']:.2f}), peak {RATES['epoch_peak']:.1f} MiB (f32: {RATES['s2ef_train_peak']:.1f})",
          flush=True)
    del trainer
    check_bf16_training_step(config, device, "GemNet-OC S2EF amp", S2EFTrainer, systems[:2])
    return total


# --------------------------------------------------------------------------
# ROADMAP A.8 step 2: EquiformerV2 in bf16 (phases 25, 29 and 30)
# --------------------------------------------------------------------------
# phases 29-30: the gradients of a B=2 amp step whose roundoff alone moves them past 5e-2 of their max, each with a
# fixed limit (PERF.md section 2); no other gradient is raised
BF16_GRAD_LIMITS.update({"EquiformerV2 amp": {}, "EquiformerV2 conditional amp": {}})
# phase 30's B=2 amp steps card against CPU: depth cut 8 -> 4 layers (at 8, each model's five CPU steps, bf16, f32
# and three perturbed, took ~130 s of the card machine's host, 267 s for both models in all)
EQV2_STEP_LAYERS = 4
# phase 29's B=2 forward card against CPU, per output, of max|cpu|: a fixed limit, 1.25x the largest roundoff spread
# recorded there (1.795e-2, force_block).  The CPU's bf16-to-f32 distance d is no limit for EquiformerV2: its own
# roundoff spread reached d at 2, 4 and 8 layers alike (0.65-1.02 of it, scripts/spread_torch_bf16_eqv2.py)
BF16_EQV2_MODEL_LIMIT = 2.25e-2


def bf16_eqv2_kernel_checks(device, gen, systems):
    """Phase 25, EquiformerV2: phases 10a-b, 13a and 13b's checks on the
    bf16 variants, at the inputs of one bf16 forward at the eqv2_so3.yml
    widths (B=16 sampling; s2_grid_silu_bwd at a B=12 forward's, the
    training shape, with a bf16 cotangent).  Returns the kernels-line rows,
    launches still 0."""
    model = EquiformerV2(**EQV2_KW, compute_dtype="bfloat16", device=device, generator=torch.Generator().manual_seed(7))
    batch = collate(systems, max_atoms=80, device=device)
    static = model.prepare_static(batch)
    with torch.no_grad():
        calls = capture_first_calls(equiformer_v2, ("eqv2_attn_conv1", "s2_grid_silu"), lambda: model(batch, static))
    h = calls["s2_grid_silu"][0][0]
    args = calls["eqv2_attn_conv1"][0]
    if h.dtype != BF16 or args[4].dtype != BF16 or args[2].dtype != torch.float32:
        raise AssertionError(f"the bf16 model's S^2 activation took {h.dtype}, its conv1 messages {args[4].dtype} "
                             f"and embeddings {args[2].dtype}")
    rows = [s2_kernel_checks(device, gen, *calls["s2_grid_silu"][0]),
            conv1_kernel_checks(device, gen, *calls["eqv2_attn_conv1"])]
    # the wide route takes f32 messages only
    w_args, w_kw = conv1_inputs(gen, device, 4, 2, (64,), 128, 64, 576, 600, CONV1_WIDE, 12.0)
    w_args[4], w_args[5] = w_args[4].to(BF16), w_args[5].to(BF16)
    try:
        kernels.eqv2_attn_conv1(*w_args, **w_kw)
    except TypeError as exc:
        print(f"[kernel] eqv2_attn_conv1 wide route with bf16 messages raises TypeError: {exc}", flush=True)
    else:
        raise AssertionError("eqv2_attn_conv1's wide route took bf16 messages")
    del calls, h, args, w_args
    rows.append(check_rotations(device, gen, batch, model, BF16))
    big = collate(bench_systems(EQV2_TRAIN_BATCH), max_atoms=80, device=device)
    with torch.no_grad():
        h, to_m, from_m = capture_first_calls(equiformer_v2, ("s2_grid_silu",), lambda: model(big))["s2_grid_silu"][0]
    rows.append(s2_bwd_kernel_checks(device, gen, h, torch.randn(h.shape, generator=gen).to(device).to(BF16), to_m,
                                     from_m))
    return rows


def eqv2_bf16_launches(model, forwards, backwards=0):
    """Launches of ``forwards`` bf16 EquiformerV2 forwards and ``backwards``
    backwards: per forward one conv1, one S^2 activation and three rotations
    per attention (the blocks' and the heads') in bf16, the edge-degree
    rotation in f32; per backward each rotation's dual and each S^2
    activation's backward."""
    attn = model.num_layers + 2
    want = {"eqv2_attn_conv1.bf16": attn * forwards, "s2_grid_silu.bf16": attn * forwards,
            "eqv2_edge_rotate.bf16": 3 * attn * (forwards + backwards), "eqv2_edge_rotate": forwards + backwards}
    if backwards:
        want["s2_grid_silu_bwd.bf16"] = attn * backwards
    return want


def bf16_eqv2_sampling_path(device, systems):
    """Phase 29: EquiformerV2 in bf16 at the eqv2_so3.yml widths (phase 11's
    weights), card vs CPU at B=2 (at BF16_EQV2_MODEL_LIMIT) and 100 ODE
    steps at B=16 with the hoisted static graph.  Returns the run's
    launches."""
    model16, model32 = (EquiformerV2(**EQV2_KW, compute_dtype=cdt, device=device,
                                     generator=torch.Generator().manual_seed(7)) for cdt in ("bfloat16", None))
    bf16_card_vs_cpu("EquiformerV2", model16, model32, collate(systems[:2], max_atoms=80, device=device),
                     ("force_block", "force_block2"), fixed=BF16_EQV2_MODEL_LIMIT)
    del model32
    batch = collate(systems, max_atoms=80, device=device)
    score_fn = make_score_fn(model16)
    engine = DiffusionEngine(score_fn, EQV2_PARAMS, static_fn=model16.prepare_static, device=device)
    DiffusionEngine(score_fn, dict(EQV2_PARAMS, num_steps=2), static_fn=model16.prepare_static,
                    device=device).run(batch, generator=torch.Generator(device=device).manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    res = engine.run(batch, generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    want = eqv2_bf16_launches(model16, EQV2_PARAMS["num_steps"])
    if launches != want:
        raise AssertionError(f"bf16 EquiformerV2 sampling launched {launches}, want {want}")
    if res.traj_pos.dtype != torch.float32 or not torch.isfinite(res.traj_pos).all():
        raise AssertionError("bf16 EquiformerV2 sampling: positions not finite f32")
    slab = ~batch.ads_mask
    if not torch.equal(res.batch.pos[slab], batch.pos[slab]):
        raise AssertionError("bf16 EquiformerV2 sampling moved slab atoms")
    rate = EQV2_PARAMS["num_steps"] * batch.batch_size / wall
    static = model16.prepare_static(batch)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: score_fn(batch, static), 5)
    print(f"[bf16-eqv2] {EQV2_PARAMS['num_steps']}-step ODE sampling in bf16, B=16, eqv2_so3.yml widths: "
          f"{wall:.3f} s wall, {rate:.2f} system-steps/s (phase 11's f32: {RATES['eqv2_sample']:.2f}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (f32: {RATES['eqv2_sample_peak']:.1f}), launches "
          f"{launches}; one score forward {forward_ms:.3f} ms (f32: {RATES['eqv2_forward']:.3f})", flush=True)
    return launches


def conv1_vjp_timing(what, device, gen, model, batch, noised_fn):
    """The conv1 VJP at the first attention block's inputs of a training
    forward of ``model``: its time (a plain recompute under autograd) beside
    conv1_bwd_bound_ms."""
    with torch.no_grad():
        args, kw = capture_first_calls(equiformer_v2, ("eqv2_attn_conv1",), noised_fn)["eqv2_attn_conv1"]
    dist, mask, *edge_inputs = (t.detach().clone() for t in args[:6])
    edge_inputs = [t.requires_grad_(True) for t in edge_inputs]
    trees = [{m: {k: v.detach().clone().requires_grad_(True) for k, v in mod.items()} for m, mod in tree.items()}
             for tree in args[6:]]
    leaves = edge_inputs + [v for tree in trees for mod in tree.values() for v in mod.values()]
    outs = kernels.eqv2_attn_conv1(dist, mask, *edge_inputs, *trees, **kw)
    cts = [torch.randn(o.shape, generator=gen).to(device).to(o.dtype) for o in outs]
    grads = torch.autograd.grad(outs, leaves, cts, retain_graph=True)
    vjp_ms = cuda_ms(lambda: torch.autograd.grad(outs, leaves, cts, retain_graph=True), 3)
    bound_ms, by, nbytes, flops = conv1_bwd_bound_ms([dist, mask, *edge_inputs, *trees], kw, cts, grads)
    print(f"[kernel] eqv2_attn_conv1 VJP{what} (plain recompute under autograd) at E={dist.numel()}, messages "
          f"{edge_inputs[2].dtype}: {vjp_ms:.4f} ms, bound {bound_ms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP f32, "
          f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / vjp_ms:.1f}% of the bound", flush=True)
    return vjp_ms, bound_ms


def bf16_eqv2_training_path(device, root):
    """Phase 30: DenoisingTrainer.train() on eqv2_so3.yml + base.yml with amp
    (phase 14's cut: one 20-step epoch at B=12), the conv1 VJP in bf16, then
    one amp step at B=2 card against CPU for the plain and the
    energy-conditional model (eqv2_conditional.yml), cut to
    EQV2_STEP_LAYERS layers.  Returns the launches."""
    paths = write_training_shards(root, {"bf16_eqv2_train": EQV2_TRAIN_BATCH * EQV2_TRAIN_STEPS,
                                         "bf16_eqv2_val": EQV2_EVAL_BATCH})
    config = dict(copy.deepcopy(EQV2_TRAIN_CONFIG), run_dir=root, amp=True, identifier="smoke_bf16_eqv2",
                  dataset=[{"src": paths["bf16_eqv2_train"]}, {"src": paths["bf16_eqv2_val"]}])
    trainer = DenoisingTrainer(config, device=device)
    model = trainer.model
    if model.compute_dtype != "bfloat16":
        raise AssertionError(f"amp built a {model.compute_dtype} EquiformerV2")
    gen = torch.Generator().manual_seed(30)
    batch = next(iter(trainer.train_batcher)).to(device)
    batch = batch.replace(pos=batch.pos_relaxed)
    noised, _ = trainer.schedule_fn(batch, trainer.denoising_pos_params, torch.Generator(device=device).manual_seed(4))
    conv1_vjp_timing(" in bf16", device, gen, model, noised, lambda: model(noised))
    del batch, noised
    launches = train_one_epoch(trainer, EQV2_TRAIN_STEPS, eqv2_bf16_launches(model, 1, 1))
    if trainer.ema_module.compute_dtype != "bfloat16":
        raise AssertionError("amp: the EquiformerV2 EMA model does not compute in bf16")
    print(f"[bf16-eqv2-train] EquiformerV2 with amp: {RATES['epoch']:.2f} systems/s (phase 14's f32: "
          f"{RATES['eqv2_train']:.2f}), peak {RATES['epoch_peak']:.1f} MiB (f32: {RATES['eqv2_train_peak']:.1f})",
          flush=True)
    del trainer, model
    config = dict(config, model=dict(config["model"], num_layers=EQV2_STEP_LAYERS))
    check_bf16_training_step(config, device, "EquiformerV2 amp")
    conditional = dict(config, model=dict(config["model"], energy_encoding="scalar"))
    check_bf16_training_step(conditional, device, "EquiformerV2 conditional amp",
                             systems=labelled_systems(bench_systems(2), 30))
    return launches


# --------------------------------------------------------------------------
# phase 31: reference checkpoints
# --------------------------------------------------------------------------
# the embedded model configs of reference checkpoints at published widths (what base_trainer.py saves under
# config.model_attributes): EquiformerV2 at configs/denoising/eqv2_conditional.yml (eqv2_so3.yml + the scalar energy
# encoding) with the reference's own keys, PaiNN at painn_so3.yml, GemNet-OC at gemnet_relax.yml
REF_EQV2 = ("adsorbdiff.models.equiformer_v2.equiformer_v2_denoising.EquiformerV2S_OC20_DenoisingPos", dict(
    num_layers=8, sphere_channels=128, attn_hidden_channels=64, num_heads=8, attn_alpha_channels=64,
    attn_value_channels=16, ffn_hidden_channels=128, norm_type="layer_norm_sh", lmax_list=[4], mmax_list=[2],
    grid_resolution=18, num_sphere_samples=128, edge_channels=128, use_atom_edge_embedding=True,
    share_atom_edge_embedding=False, use_m_share_rad=False, distance_function="gaussian", num_distance_basis=512,
    attn_activation="silu", use_s2_act_attn=False, use_attn_renorm=True, ffn_activation="silu", use_gate_act=False,
    use_grid_mlp=True, use_sep_s2_act=True, weight_init="uniform", max_neighbors=20, max_radius=12.0,
    max_num_elements=90, use_pbc=True, regress_forces=True, otf_graph=True, FOR_denoising=True, so3_denoising=True,
    energy_encoding="scalar"))
REF_PAINN = ("adsorbdiff.models.painn.painn_denoising.PaiNN", dict(
    hidden_channels=512, num_layers=6, num_rbf=128, max_radius=12.0, max_neighbors=50, so3_denoising=True,
    use_pbc=True, otf_graph=True, regress_forces=True))
REF_GEMNET = ("gemnet_oc", dict(
    {k: v for k, v in GEMNET_KW.items() if k not in ("mode", "fused_quad")}, qint_tags=[1, 2], regress_forces=True,
    direct_forces=True, otf_graph=True, scale_file="configs/relaxation/gemnet_oc/gemnet-oc.pt",
    output_init="HeOrthogonal", activation="silu", forces_coupled=False, enforce_max_neighbors_strictly=False))
# the conversions' overrides: phase 11's sampling setting for EquiformerV2 and PaiNN (bench.py's cell_reps and
# max_ads), the bench slabs' image counts for GemNet-OC
REF_OVERRIDES = {"equiformer_v2": ["cell_reps=(2, 2, 0)", "max_ads=8"], "painn": ["cell_reps=(2, 2, 0)", "max_ads=8"],
                 "gemnet_oc": ["cell_reps=(2, 2, 0)"]}
REF_BATCH = 16


def random_reference_state(name, attrs, gen):
    """A reference state dict for the embedded config (``name``, ``attrs``),
    random from ``gen``.  EquiformerV2: the port's table of the reference's
    names and shapes (which the CPU tests hold to the oracle's), matrices
    N(0, 1/fan_in) (fan_in the last axis), biases N(0, 0.02^2), layer-norm
    and affine weights 1 + N(0, 0.02^2).  PaiNN and GemNet-OC: their port's
    module names are the reference's, so the initial state dict of the
    port's model of that config, with fitted-looking scale factors,
    U(0.5, 1.5)."""
    cfg = torch_import.reference_model_config_to_ours(dict(attrs, name=name))
    family = cfg.pop("name")
    if family == "equiformer_v2":
        widths = ("lmax", "mmax", "num_layers", "sphere_channels", "attn_hidden_channels", "num_heads",
                  "attn_alpha_channels", "attn_value_channels", "ffn_hidden_channels", "edge_channels",
                  "max_num_elements", "energy_encoding")
        sd = {}
        for key, shape in torch_import.eqv2_reference_shapes(**{k: cfg[k] for k in widths if k in cfg}).items():
            noise = torch.randn(shape, generator=gen)
            if key.endswith("affine_weight") or (len(shape) == 1 and key.endswith("weight")):
                sd[key] = 1.0 + 0.02 * noise
            elif len(shape) == 1:
                sd[key] = 0.02 * noise
            else:
                sd[key] = noise / math.sqrt(shape[-1])
        return family, sd
    sd = {"painn": PaiNN, "gemnet_oc": GemNetOC}[family](**cfg, device="cpu", generator=gen).state_dict()
    for key in sd:
        if key.endswith(".scale_factor"):
            sd[key] = 0.5 + torch.rand((), generator=gen)
    return family, sd


def save_reference_pt(path, model_name, attrs, sd):
    """A checkpoint as the reference saves one: DDP ``module.`` prefixes, the
    config's model name and attributes, epoch and step."""
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "config": {"model": model_name, "model_attributes": attrs}, "epoch": 0, "step": 0}, path)


def run_commands(commands, timeout=600):
    """Run the command lines together (each a list; on the host: no card is
    visible to them); return their standard outputs.  Raise on a non-zero exit
    or a timeout, each process ended."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outs = []
    try:
        for cmd, proc in zip(commands, procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"{' '.join(cmd[2:4])} exited {proc.returncode}: {err[-3000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def reference_model(trainer_cls, path, root, device):
    """``trainer_cls`` built from a converted checkpoint's sidecar model
    section, the checkpoint loaded (``weights_only=True``)."""
    with open(path + ".config.yaml") as f:
        model_cfg = yaml.safe_load(f)["model"]
    trainer = trainer_cls(dict(model=model_cfg, optim=dict(lr_initial=1e-4), run_dir=root, is_debug=True, seed=0,
                               identifier="smoke_reference"), device=device)
    trainer.load_checkpoint(path)
    return trainer


def counted_forward(what, model, batch, want):
    """``model(batch)`` with the launch counts zeroed just before and read
    just after; raise unless they are ``want``."""
    torch.cuda.synchronize()
    kernels.launches.clear()
    with torch.no_grad():
        out = model(batch)
    torch.cuda.synchronize()
    launches = path_launches()
    if launches != want:
        raise AssertionError(f"{what}: one forward launched {launches}, want {want}")
    return out


def reference_checkpoint_path(device, systems, files, rows, root, smi):
    """Phase 31: reference-shaped ``.pt`` checkpoints of the three families at
    published widths, converted by the port's command line, then run from
    the converted files on the card.  Returns the launches of its runs."""
    gen = torch.Generator().manual_seed(31)
    pts = {}
    for name, attrs in (REF_EQV2, REF_PAINN, REF_GEMNET):
        family, sd = random_reference_state(name, attrs, gen)
        pts[family] = (os.path.join(root, f"{family}.pt"), sd)
        save_reference_pt(pts[family][0], name, attrs, sd)
    out_dir = os.path.join(root, "converted")
    t0 = time.perf_counter()
    commands = [[sys.executable, "-m", "adsorbdiff_tpu_torch.scripts.convert_checkpoint", pt, out_dir, "--name",
                 family, "--cpu"] + [a for o in REF_OVERRIDES[family] for a in ("--override", o)]
                for family, (pt, _) in pts.items()]
    commands.append([sys.executable, "-m", "adsorbdiff_tpu_torch.scripts.eval", "nsite", files["out_dir"],
                     "--targets", files["dft"]])
    outs = run_commands(commands)
    paths = {family: os.path.join(out_dir, family) for family in pts}
    print(f"[reference] {smi}; reference-shaped .pt files at published widths (EquiformerV2 eqv2_conditional.yml, "
          f"PaiNN painn_so3.yml, GemNet-OC gemnet_relax.yml; random weights from a seeded generator) converted by "
          f"`python -m adsorbdiff_tpu_torch.scripts.convert_checkpoint`, and the eval command, as four processes "
          f"together in {time.perf_counter() - t0:.2f} s: " + "; ".join(o.strip().splitlines()[-1] for o in outs[:3]),
          flush=True)

    # the eval command on phase 16's pipeline tree: phase 16's success rate and per-system results
    lines = outs[3].strip().splitlines()
    per_line = {sid: flag == "success" for sid, flag in (line.split(": ") for line in lines[:-1])}
    k, n = (int(x) for x in lines[-1].split("(")[1].rstrip(")").split("/"))
    want_per = {str(sid): bool(v) for sid, v in files["per_system"].items()}
    if per_line != want_per or k / n != files["rate"] or lines[-1] != (
            f"success rate: {files['rate'] * 100:.1f}%  ({sum(want_per.values())}/{len(want_per)})"):
        raise AssertionError(f"eval nsite on phase 16's tree printed {lines}; phase 16: rate {files['rate']}, "
                             f"{want_per}")
    print(f"[reference] `python -m adsorbdiff_tpu_torch.scripts.eval nsite` on phase 16's tree: '{lines[-1]}', "
          f"per system as phase 16's scorer (rate {files['rate']:.4f})", flush=True)

    launches = collections.Counter()
    small = collate(systems[:2], max_atoms=80, device=device)
    conditioned = small.replace(energy=torch.tensor([1.3, -0.7], device=device))

    # PaiNN and GemNet-OC: the converted files loaded by their trainers, B=2 card against CPU
    for family, trainer_cls, heads in (("painn", DenoisingTrainer, ("out_forces", "out_forces2")),
                                       ("gemnet_oc", S2EFTrainer, ("energy", "forces"))):
        trainer = reference_model(trainer_cls, paths[family], root, device)
        model = trainer.ema_module
        want = {"painn_message_fused": model.num_layers} if family == "painn" else gemnet_launches(model, 1)
        ref_sd = pts[family][1]
        factors = {n: b for n, b in model.named_buffers() if n.endswith(".scale_factor")}
        if family == "gemnet_oc" and not (trainer.scale_factors_fitted and factors and all(
                torch.equal(b.cpu(), ref_sd[n]) for n, b in factors.items())):
            raise AssertionError("GemNet-OC: the converted checkpoint's scale factors are not the reference's")
        card = counted_forward(f"converted {family}", model, small, want)
        launches.update(want)
        with torch.no_grad():
            host = copy.deepcopy(model).to("cpu")(small.to("cpu"))
        pairs = zip(heads, card.values(), host.values()) if isinstance(card, dict) else zip(heads, card, host)
        check_model(f"converted {family}", pairs)
        del trainer, model, card, host

    # EquiformerV2, e3nn grid: run-relaxations from the converted checkpoint through the trainer context
    write_shard(os.path.join(root, "reference_relax"), systems[:REF_BATCH])
    traj_dir = os.path.join(root, "reference_trajs")
    with open(paths["equiformer_v2"] + ".config.yaml") as f:
        eqv2_cfg = yaml.safe_load(f)["model"]
    cfg = dict(trainer="denoising", model=eqv2_cfg, optim=dict(TRAIN_CONFIG["optim"], eval_batch_size=REF_BATCH,
                                                                 denoising_pos_params=dict(EQV2_PARAMS)),
               task=dict(TRAIN_CONFIG["task"], relax_dataset={"src": os.path.join(root, "reference_relax.adshard.npz")},
                         relax_opt={"traj_dir": traj_dir}, write_pos=True),
               logger=None, is_debug=True, seed=0, identifier="smoke_reference_eqv2", run_dir=root, print_every=100,
               cpu=device.type == "cpu")  # the task context builds on the card unless told
    if eqv2_cfg.get("grid_mode") != "e3nn" or eqv2_cfg.get("energy_encoding") != "scalar":
        raise AssertionError(f"converted EquiformerV2 config {eqv2_cfg}")
    steps = EQV2_PARAMS["num_steps"]
    with new_trainer_context(dict(cfg, mode="run-relaxations", checkpoint=paths["equiformer_v2"])) as ctx:
        trainer = ctx.trainer
        model = trainer.ema_module
        per_step = model.num_layers + 2
        batch = collate(systems[:REF_BATCH], max_atoms=80, device=device)
        with torch.no_grad():
            static = trainer.sampling_static_fn()(batch)
            calls = capture_first_calls(equiformer_v2, ("s2_grid_silu",), lambda: trainer.score_fn(batch, static))
        h, to_m, from_m = calls["s2_grid_silu"][0]
        e3nn = [torch.from_numpy(t) for t in equiformer_v2.s2_act_matrices(model.lmax, model.mmax,
                                                                            eqv2_cfg["grid_resolution"], "e3nn")]
        if not (torch.equal(to_m.cpu(), e3nn[0]) and torch.equal(from_m.cpu(), e3nn[1])):
            raise AssertionError("the converted EquiformerV2 does not run the e3nn S^2 tables")
        # 31a. both S^2 kernels on the e3nn tables at the first attention block's input
        s2 = s2_kernel_checks(device, gen, h, to_m, from_m)
        s2b = s2_bwd_kernel_checks(device, gen, h, torch.randn(h.shape, generator=gen).to(device), to_m, from_m)
        # the gauss tables at the same input, in this call, and the earlier phases' rows
        to_g, from_g = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(
            model.lmax, model.mmax, eqv2_cfg["grid_resolution"]))
        dy = torch.randn(h.shape, generator=gen).to(device)
        g_ms = cuda_ms(lambda: kernels.s2_grid_silu(h, to_g, from_g), 20)
        gb_ms = cuda_ms(lambda: kernels.s2_grid_silu_bwd(h, dy, to_g, from_g), 20)
        gauss = {r["name"]: r for r in rows}
        print(f"[reference] e3nn tables at h{tuple(h.shape)}: s2_grid_silu {s2['ms']:.4f} ms against the gauss "
              f"tables' {g_ms:.4f} at the same input (phase 10a's: {gauss['s2_grid_silu']['ms']:.4f}), max_abs_err "
              f"over its checks {s2['max_abs_err']:.3e}; s2_grid_silu_bwd {s2b['ms']:.4f} ms against {gb_ms:.4f} "
              f"(phase 13b's at B={EQV2_TRAIN_BATCH}: {gauss['s2_grid_silu_bwd']['ms']:.4f}), max_abs_err "
              f"{s2b['max_abs_err']:.3e}; {smi}", flush=True)
        del calls, h, dy

        # 31b. 100-step sampling of 16 with the converted model's sampling model
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
        run = path_launches()
        trainer.score_fn = score_fn
        want = {"s2_grid_silu": per_step * forwards, "eqv2_attn_conv1": per_step * forwards,
                "eqv2_edge_rotate": (1 + 3 * per_step) * forwards}
        if forwards != steps or run != want:
            raise AssertionError(f"converted EquiformerV2 run-relaxations launched {run} in {forwards} score "
                                 f"forwards; want {want} and {steps} forwards")
        launches.update(run)
        relaxed = np.load(os.path.join(trainer.results_dir, "relaxed_positions.npz"))
        if sorted(relaxed["ids"].tolist()) != sorted(str(s.sid) for s in systems[:REF_BATCH]) or not np.isfinite(
                relaxed["pos"]).all():
            raise AssertionError(f"relaxed_positions.npz: ids {relaxed['ids'].tolist()} or non-finite positions")
        for s in systems[:REF_BATCH]:
            traj = Trajectory.load(os.path.join(traj_dir, f"{s.sid}{SUFFIX}"))
            slab = traj.tags != 2
            if len(traj) != steps + 1 or not np.isfinite(traj.positions).all() or not (
                    traj.positions[:, slab] == s.pos[slab]).all():
                raise AssertionError(f"trajectory {s.sid}: {len(traj)} frames, non-finite or moved slab positions")
        rate = steps * REF_BATCH / wall
        print(f"[reference] converted EquiformerV2 (e3nn grid, energy-conditional) run-relaxations from the "
              f"checkpoint: {steps} ODE steps, B={REF_BATCH}: {wall:.3f} s wall, {rate:.2f} system-steps/s (phase "
              f"11's gauss grid, DiffusionEngine alone: {RATES['eqv2_sample']:.2f}), peak "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB allocated, launches {run}", flush=True)

        # 31c. card vs CPU, B=2, non-zero energies
        want = {"s2_grid_silu": per_step, "eqv2_attn_conv1": per_step, "eqv2_edge_rotate": 1 + 3 * per_step}
        card = counted_forward("converted EquiformerV2", model, conditioned, want)
        launches.update(want)
        with torch.no_grad():
            host = copy.deepcopy(model).to("cpu")(conditioned.to("cpu"))
            unconditioned = model(small)
        check_model("converted EquiformerV2 (e3nn)", zip(("force_block", "force_block2"), card, host))
        moved = (card[0] - unconditioned[0]).abs().max().item()
        if not moved > 0:
            raise AssertionError("converted EquiformerV2: the energy does not change the output")
        del trainer, model, card, host, unconditioned

    # 31d. one f32 training step at B=2 from the converted checkpoint, card vs CPU
    step_cfg = dict(cfg, optim=dict(cfg["optim"], batch_size=2), task=TRAIN_CONFIG["task"])
    torch.cuda.synchronize()
    kernels.launches.clear()
    check_training_step(step_cfg, device, "converted EquiformerV2 (e3nn)", checkpoint=paths["equiformer_v2"])
    torch.cuda.synchronize()
    step = path_launches()
    want = {"s2_grid_silu": per_step, "eqv2_attn_conv1": per_step, "s2_grid_silu_bwd": per_step,
            "eqv2_edge_rotate": 2 * (1 + 3 * per_step)}
    if step != want:
        raise AssertionError(f"the converted EquiformerV2's training step launched {step}, want {want}")
    launches.update(step)
    print(f"[reference] phase 31's launches: {dict(launches)}", flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 32: the reference's LMDB data
# --------------------------------------------------------------------------
# 8192 bench systems (80 atoms, energies and forces as labelled_systems gives them) in the reference's LMDB format;
# 5000 systems a converted shard (two shards); 20 batches of an epoch plan at B=48 for the collators; neighbour
# counts of 256 systems at painn_so3.yml's cutoff 12 A and 50 neighbours; 4 PaiNN and 2 GemNet-OC training steps; a
# 16-system relax set (shard 0 of 512 of the converted set)
DATA_SYSTEMS, DATA_SHARD_SIZE, DATA_BATCHES = 8192, 5000, 20
DATA_NEIGHBOR_SYSTEMS, DATA_CUTOFF, DATA_MAX_NEIGHBORS = 256, 12.0, 50
DATA_TRAIN_STEPS, DATA_S2EF_STEPS, DATA_RELAX_BATCH = 4, 2, 16
DATA_LOSS_RTOL = 1e-6
SYSTEM_FIELDS = ("pos", "atomic_numbers", "tags", "fixed", "cell", "sid", "fid", "energy", "y_relaxed",
                 "pos_relaxed", "forces")


def same_system(a, b):
    """Every field equal bit for bit, with its dtype (or both None)."""
    for name in SYSTEM_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(y, np.ndarray):
            if not (isinstance(x, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y)):
                return False
        elif x != y or type(x) is not type(y):
            return False
    return True


def same_batch(a, b):
    """Every tensor of two batches equal bit for bit, with its dtype."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None) or (x is not None and not (x.dtype == y.dtype and torch.equal(x, y))):
            return False
    return True


def timed_items(reader):
    """All of a reader's (key, value) pairs and the seconds it took."""
    t0 = time.perf_counter()
    items = list(reader.items())
    return items, time.perf_counter() - t0


def first_batches(batcher, count):
    """The first ``count`` batches of an epoch and the seconds they took."""
    t0 = time.perf_counter()
    out = [b for _, b in zip(range(count), batcher)]
    return out, time.perf_counter() - t0


def counted_steps(trainer, batches, device, want):
    """train_step on each batch with the noise of step i; launches exactly
    ``want`` a step.  Returns the losses (on the host)."""
    losses = []
    for i, batch in enumerate(batches):
        before = dict(kernels.launches)
        aux = trainer.train_step(batch.to(device), generator=torch.Generator(device=device).manual_seed(i))
        got = launches_since(before)
        if got != want:
            raise AssertionError(f"a training step on the converted data launched {got}, want {want}")
        losses.append(aux["loss"])
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses.tolist()}")
    return losses


def reference_data_path(device, root, smi):
    """Phase 32: the reference's LMDB data through the port's data layer on
    the card's machine, then trained from and relaxed on the card.  Returns
    the phase's launches."""
    t_phase = time.perf_counter()
    print(f"[data] {smi}; {host_cpu()}; rates below are host work on the card's machine", flush=True)
    # 1. both host libraries from the checkout, no fallback
    t0 = time.perf_counter()
    libs = host_build.build()
    for name in host_build.LIBRARIES:
        host_build.load(name)
    print(f"[data] g++ built {sorted(host_build.build_logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.2f} s: {', '.join(os.path.basename(p) for p in libs.values())}", flush=True)

    # 2. export
    systems = labelled_systems(bench_systems(DATA_SYSTEMS), 32)
    lmdb_path = os.path.join(root, "oc20_like.lmdb")
    t0 = time.perf_counter()
    count = lmdb_compat.export_systems_to_lmdb(systems, lmdb_path)
    export_s = time.perf_counter() - t0
    with lmdb_native.NativeLmdbReader(lmdb_path) as nat, lmdbio.LmdbReader(lmdb_path) as py:
        native_items, native_s = timed_items(nat)
        python_items, python_s = timed_items(py)
        main = py.meta["main"]
        psize = py.psize
    size = os.path.getsize(lmdb_path)
    records = [v for k, v in python_items if k != b"length"]
    half_page = ((psize - 16) // 2) & ~1
    if count != DATA_SYSTEMS or main["entries"] != DATA_SYSTEMS + 1 or main["depth"] < 2:
        raise AssertionError(f"export: {count} records, meta {main}")
    if min(len(v) for v in records) <= half_page:
        raise AssertionError(f"a record of {min(len(v) for v in records)} bytes fits a node of {half_page}")
    print(f"[data] export_systems_to_lmdb: {count} records of {min(len(v) for v in records)}-"
          f"{max(len(v) for v in records)} bytes (every one an overflow chain past the {half_page}-byte node limit), "
          f"{size / 1e6:.2f} MB, {size // psize} pages of {psize} B, tree depth {main['depth']}, in {export_s:.3f} s "
          f"({count / export_s:.0f} records/s)", flush=True)

    # 3. read and convert
    if native_items != python_items:
        raise AssertionError("the C++ and Python LMDB readers disagree")
    n = len(python_items)
    print(f"[data] readers: C++ {n / native_s:.0f} records/s ({native_s:.3f} s), Python {n / python_s:.0f} "
          f"records/s ({python_s:.3f} s); all {n} keys and values equal byte for byte", flush=True)
    del native_items, python_items, records
    with lmdb_native.open_best_reader(lmdb_path) as best:
        if best.backend != "native":
            raise AssertionError(f"open_best_reader took the {best.backend} reader")
    conv_dir = os.path.join(root, "converted")
    os.makedirs(conv_dir)
    t0 = time.perf_counter()
    converted = lmdb_compat.convert_lmdb_to_shards(lmdb_path, os.path.join(conv_dir, "oc20_like"), DATA_SHARD_SIZE)
    convert_s = time.perf_counter() - t0
    shards = sorted(os.listdir(conv_dir))
    conv = ShardDataset({"src": conv_dir})
    back = [conv[i] for i in range(len(conv))]
    if converted != DATA_SYSTEMS or len(shards) != 2 or len(back) != DATA_SYSTEMS:
        raise AssertionError(f"convert_lmdb_to_shards: {converted} systems in {shards}")
    # the exported systems as the shard format holds them: written directly, without the LMDB
    direct = os.path.join(root, "direct")
    write_shard(direct, systems)
    direct_ds = ShardDataset({"src": direct})
    bad = [i for i, a in enumerate(back) if not same_system(a, direct_ds[i])]
    if bad:
        raise AssertionError(f"{len(bad)} converted systems differ from the exported ones, the first {bad[0]}")
    t0 = time.perf_counter()
    adbin = native.write_shard_bin(os.path.join(root, "oc20_like"), back)
    adbin_s = time.perf_counter() - t0
    print(f"[data] convert_lmdb_to_shards (the C++ reader, shard size {DATA_SHARD_SIZE}): {converted} systems into "
          f"{shards} in {convert_s:.3f} s ({converted / convert_s:.0f} systems/s); write_shard_bin "
          f"{os.path.getsize(adbin) / 1e6:.2f} MB in {adbin_s:.3f} s; every converted system equals its exported one "
          f"(written to a shard directly) bit for bit, field by field", flush=True)
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "oc20_2sys.lmdb")
    with lmdb_native.NativeLmdbReader(fixture) as nat, lmdbio.LmdbReader(fixture) as py:
        if list(nat.items()) != list(py.items()) or nat.psize != py.psize:
            raise AssertionError("the readers disagree on tests/fixtures/oc20_2sys.lmdb")
    fixture_systems = list(lmdb_compat.iter_lmdb_systems(fixture))
    print(f"[data] tests/fixtures/oc20_2sys.lmdb: both readers equal ({py.entries} entries); its systems have "
          f"{[s.natoms for s in fixture_systems]} atoms, sids {[s.sid for s in fixture_systems]}", flush=True)

    # 4. collate: the C++ collator against the Python one on the same epoch plan
    nat_ds = native.NativeShardDataset({"src": adbin})
    conv[0]  # columns decompressed before the clock starts
    nat_batches, nat_s = first_batches(BucketedBatcher(nat_ds, TRAIN_BATCH, seed=0), DATA_BATCHES)
    py_batches, py_s = first_batches(BucketedBatcher(conv, TRAIN_BATCH, seed=0), DATA_BATCHES)
    if len(nat_batches) != DATA_BATCHES or not all(same_batch(a, b) for a, b in zip(nat_batches, py_batches)):
        raise AssertionError("the C++ collator's batches differ from ShardDataset + collate's")
    print(f"[data] the first {DATA_BATCHES} batches of an epoch at B={TRAIN_BATCH}: NativeShardDataset "
          f"(collate_indices) {DATA_BATCHES / nat_s:.1f} batches/s, ShardDataset + collate {DATA_BATCHES / py_s:.1f} "
          f"batches/s; equal bit for bit", flush=True)
    del nat_batches, py_batches

    # 5. neighbour counts, card against CPU, and a plan balanced on them
    subset = ShardDataset({"src": conv_dir, "shard": 0, "total_shards": DATA_SYSTEMS // DATA_NEIGHBOR_SYSTEMS})
    t0 = time.perf_counter()
    card_counts = metadata.neighbor_counts(subset, DATA_CUTOFF, DATA_MAX_NEIGHBORS, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_counts = metadata.neighbor_counts(subset, DATA_CUTOFF, DATA_MAX_NEIGHBORS, device="cpu")
    cpu_s = time.perf_counter() - t0
    if len(card_counts) != DATA_NEIGHBOR_SYSTEMS or not np.array_equal(card_counts, cpu_counts):
        raise AssertionError(f"neighbor_counts: card and CPU differ in {(card_counts != cpu_counts).sum()} systems")
    plan = BucketedBatcher(subset, TRAIN_BATCH, seed=0, mode="neighbors", sizes=card_counts)
    print(f"[data] neighbor_counts of {len(subset)} systems at {DATA_CUTOFF} A, {DATA_MAX_NEIGHBORS} neighbours, "
          f"images (2, 2, 0): card {card_s:.3f} s, CPU {cpu_s:.3f} s, equal (counts {card_counts.min()}-"
          f"{card_counts.max()}); mode='neighbors' plan: {len(plan)} batches, atom edges {plan.bucket_edges}",
          flush=True)

    # 6. training on the converted shards, step 1 against the shards written directly from the same systems
    relax_set = {"src": conv_dir, "shard": 0, "total_shards": DATA_SYSTEMS // DATA_RELAX_BATCH}
    traj_dir = os.path.join(root, "trajs")
    base = copy.deepcopy(TRAIN_CONFIG)
    base["optim"].update(eval_batch_size=DATA_RELAX_BATCH,
                         denoising_pos_params=dict(base["optim"]["denoising_pos_params"], ode=True))
    base["task"].update(relax_dataset=relax_set, write_pos=True, relax_opt=dict(traj_dir=traj_dir))
    base.update(run_dir=root, is_debug=True)
    on_conv = DenoisingTrainer(dict(base, dataset=[{"src": conv_dir}], identifier="smoke_data"), device=device)
    on_direct = DenoisingTrainer(dict(base, dataset=[{"src": direct + ".adshard.npz"}],
                                      identifier="smoke_data_direct"), device=device)
    want = {"painn_message_fused": on_conv.model.num_layers, "painn_message_fused_bwd": on_conv.model.num_layers}
    batches = [b for _, b in zip(range(DATA_TRAIN_STEPS), on_conv.train_batcher)]
    first_direct = next(iter(on_direct.train_batcher))
    if not same_batch(batches[0], first_direct):
        raise AssertionError("step 1's batch from the converted shards differs from the directly written shards'")
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    losses = counted_steps(on_conv, batches, device, want)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    direct_loss = counted_steps(on_direct, [first_direct], device, want)[0].item()
    launches = collections.Counter(path_launches())
    rel = abs(losses[0].item() - direct_loss) / abs(direct_loss)
    if not rel <= DATA_LOSS_RTOL or launches != {k: (DATA_TRAIN_STEPS + 1) * v for k, v in want.items()}:
        raise AssertionError(f"step 1's loss {losses[0].item()} against {direct_loss} from the direct shards "
                             f"(relative {rel}); launches {dict(launches)}")
    del on_direct, first_direct
    print(f"[data] DenoisingTrainer (painn_so3.yml + base.yml, B={TRAIN_BATCH}) on the converted shards: "
          f"{DATA_TRAIN_STEPS} steps in {train_s:.3f} s, losses {', '.join(f'{x:.4f}' for x in losses.tolist())}; "
          f"step 1's batch equals the directly written shards' bit for bit, its loss {direct_loss:.6f} there "
          f"(relative {rel:.1e}, limit {DATA_LOSS_RTOL}); launches {dict(launches)} ({DATA_TRAIN_STEPS} + 1 steps)",
          flush=True)

    # 7. the relax set converted from the LMDB: run_relaxations, 100 ODE steps at B=16
    steps = base["optim"]["denoising_pos_params"]["num_steps"]
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    on_conv.run_relaxations()
    torch.cuda.synchronize()
    relax_s = time.perf_counter() - t0
    relax = path_launches()
    want_relax = {"painn_message_fused": on_conv.model.num_layers * steps}
    relaxed = np.load(os.path.join(on_conv.results_dir, "relaxed_positions.npz"))
    sids = sorted(s.sid for s in systems[:DATA_RELAX_BATCH])
    if relax != want_relax or sorted(int(i) for i in relaxed["ids"]) != sids or not np.isfinite(relaxed["pos"]).all():
        raise AssertionError(f"run_relaxations launched {relax} (want {want_relax}); ids {relaxed['ids'].tolist()}")
    launches.update(relax)
    print(f"[data] run_relaxations over shard 0 of {relax_set['total_shards']} of the converted set "
          f"({DATA_RELAX_BATCH} systems): {steps} ODE steps at B={DATA_RELAX_BATCH} in {relax_s:.3f} s "
          f"({steps * DATA_RELAX_BATCH / relax_s:.1f} system-steps/s), launches {relax}; relaxed_positions.npz holds "
          f"sids {sids[0]}..{sids[-1]}, finite", flush=True)
    del on_conv

    # S2EF: gemnet_relax.yml on the converted labelled records
    s2ef = S2EFTrainer(s2ef_train_config(root, {"train": conv_dir, "val": conv_dir}), device=device)
    want = gemnet_launches(s2ef.model, 1)
    batches = [b for _, b in zip(range(DATA_S2EF_STEPS), s2ef.train_batcher)]
    if any(b.forces is None for b in batches):
        raise AssertionError("an S2EF batch of the converted data has no forces")
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    losses = counted_steps(s2ef, batches, device, want)
    torch.cuda.synchronize()
    s2ef_s = time.perf_counter() - t0
    s2ef_launches = path_launches()
    if s2ef_launches != {k: DATA_S2EF_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"S2EF training launched {s2ef_launches}")
    launches.update(s2ef_launches)
    print(f"[data] S2EFTrainer (gemnet_relax.yml, B={s2ef.optim_cfg['batch_size']}) on the converted records with "
          f"their energies and forces: {DATA_S2EF_STEPS} steps in {s2ef_s:.3f} s, losses "
          f"{', '.join(f'{x:.4f}' for x in losses.tolist())}, launches {s2ef_launches}", flush=True)
    del s2ef
    nat_ds.close_db()
    print(f"[data] phase 32: {time.perf_counter() - t_phase:.1f} s wall, launches {dict(launches)}", flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 33: ROADMAP A items 1-4, the placement toolkit, AdsorbDiffCalculator and both examples
# --------------------------------------------------------------------------
# The score model is configs/denoising/painn_so3.yml's model section, the MLFF gemnet_relax.yml's (fused_quad:
# True), each cell_reps: auto resolved by auto_cell_reps over the phase's placed adslabs; random weights (seed 0)
# written by the port's make_demo_checkpoint.  100 diffusion steps as published; relaxation cut from 300
# (relaxation_steps) to 100 steps to fit the time limit, as phase 6 cuts it, with gemnet_relax.yml's relax_opt.
SCORE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "denoising", "painn_so3.yml")
A_RELAX_STEPS = 100
A_RELAX_OPT = dict(maxstep=0.04, memory=50, damping=1.0, alpha=70.0)
A_PLACEMENT_MODES = ("random", "heuristic", "random_site_heuristic_placement")
A_NRR_BULKS = 2


def model_section(path, adslabs):
    """A YAML config's model section, its ``cell_reps: auto`` resolved over
    ``adslabs`` by auto_cell_reps at the section's cutoff."""
    with open(path) as f:
        cfg = yaml.safe_load(f)["model"]
    reps = pbc.auto_cell_reps([a.positions for a in adslabs], [a.cell for a in adslabs], cfg["cutoff"])
    return dict(cfg, cell_reps=list(reps))


def placed_rigidly(what, before, after):
    """The slab of ``after`` is ``before``'s bit for bit (as f32) and the
    adsorbate's interatomic distances are kept within 1e-3 A; returns the
    largest change of such a distance."""
    slab, ads = before.tags < 2, before.tags == 2
    if not np.array_equal(after.positions[slab], before.positions[slab].astype(np.float32)):
        raise AssertionError(f"{what} moved slab atoms")
    d0 = np.linalg.norm(before.positions[ads][:, None] - before.positions[ads][None], axis=-1)
    d1 = np.linalg.norm(after.positions[ads][:, None] - after.positions[ads][None], axis=-1)
    worst = float(np.abs(d1 - d0).max())
    if not (np.isfinite(after.positions).all() and worst <= 1e-3):
        raise AssertionError(f"{what} deformed the adsorbate: a distance changed by {worst} A")
    return worst


def edges_by_row(nl):
    """{(source, cell offset): distance} of each row of a one-system
    neighbour table, over its valid slots."""
    src, off, mask, dist = (t[0].cpu().tolist() for t in (nl.src, nl.cell_offsets, nl.mask, nl.dist))
    return [{(s_, tuple(o)): d for s_, o, m, d in zip(*row) if m} for row in zip(src, off, mask, dist)]


def tied_rows(batch, model):
    """For each neighbour table GemNet-OC builds (main, aeaint, qint), the
    rows whose edge sets differ between the card and the CPU.  Raises unless
    every differing edge lies at its row's truncation boundary (within 1e-4 A
    of the row's largest kept distance): a tie that roundoff and sort order
    decide, as on a perfect lattice."""
    out = {}
    specs = {"main": (model.cutoff, model.max_neighbors), "aeaint": (model.cutoff_aeaint, model.max_neighbors_aeaint),
             "qint": (model.cutoff_qint, model.max_neighbors_qint)}
    for name, (cutoff, k) in specs.items():
        card, cpu = (edges_by_row(generate_graph(b, cutoff=cutoff, max_neighbors=k, cell_reps=model.cell_reps)[0])
                     for b in (batch, batch.to("cpu")))
        rows = 0
        for i, (c, h) in enumerate(zip(card, cpu)):
            if c.keys() == h.keys():
                continue
            rows += 1
            for edges, only in ((c, c.keys() - h.keys()), (h, h.keys() - c.keys())):
                edge = max(edges.values())
                if any(edge - edges[key] > 1e-4 for key in only):
                    raise AssertionError(f"{name} table, row {i}: card and CPU keep edges that are no tie")
        out[name] = rows
    return out


def counted_calls(what, fn, want):
    """``fn()`` with the launch counts zeroed just before and read just
    after; they must be ``want`` (a dict, or a function of the result and the
    counts).  Returns (result, wall seconds, launches)."""
    torch.cuda.synchronize()
    kernels.launches.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches()
    expected = want(out) if callable(want) else want
    if launches != expected:
        raise AssertionError(f"{what} launched {launches}, want {expected}")
    return out, wall, launches


def placement_calculator_path(device, root, smi):
    """Phase 33: the placement toolkit, AdsorbDiffCalculator and both worked
    examples through the port's public API at published widths.  Returns the
    phase's launches."""
    t_phase = time.perf_counter()
    launches = collections.Counter()
    # 1. placement: every slab of the Cu bulk up to Miller index 2, AdsorbateSlabConfig in its three modes
    t0 = time.perf_counter()
    slabs = val_sample.cu_bulk().get_slabs(max_miller=2)
    slabs_s = time.perf_counter() - t0
    if not (len(slabs) >= 3 and all(s.has_surface_tagged() for s in slabs)):
        raise AssertionError(f"get_slabs(max_miller=2) gave {len(slabs)} slabs, or one without surface atoms")
    cu100 = Slab.from_bulk_get_specific_millers((1, 0, 0), val_sample.cu_bulk())[0]
    nnh = Adsorbate(adsorbate_smiles_from_db="*N*NH")
    timings = []
    for mode in A_PLACEMENT_MODES:
        for ads in (val_sample.co_adsorbate(), nnh):
            t0 = time.perf_counter()
            config = AdsorbateSlabConfig(cu100, ads, num_sites=20, mode=mode, rng=np.random.default_rng(0))
            timings.append(f"{mode}/{ads.smiles} {len(config.atoms_list)} placements {time.perf_counter() - t0:.3f} s")
            if not config.atoms_list or any(there_is_overlap(a) for a in config.atoms_list):
                raise AssertionError(f"AdsorbateSlabConfig {mode} with {ads.smiles}: no placement, or an overlap")
    print(f"[placement] {smi}; Bulk.get_slabs(max_miller=2) on val_sample's Cu: {len(slabs)} slabs over "
          f"{len({s.millers for s in slabs})} Miller indices in {slabs_s:.3f} s; AdsorbateSlabConfig on Cu(100) "
          f"({len(cu100)} atoms): {'; '.join(timings)}; no covalent overlap", flush=True)

    # 2. checkpoints at full width, cell_reps from the adslabs the calculator and the examples place
    adslab = val_sample.cu100_co_adslab()
    ads_h = Adsorbate(adsorbate_smiles_from_db="*H")
    placed = [adslab] + [
        AdsorbateSlabConfig(Slab.from_bulk_get_specific_millers((1, 1, 1), nrr_screening.l12_bulk(*alloy[:3]))[0],
                            ads, mode="heuristic", num_sites=1, rng=np.random.default_rng(0)).atoms_list[0]
        for alloy in nrr_screening.ALLOYS[:A_NRR_BULKS] for ads in (ads_h, nnh)]
    score_cfg, mlff_cfg = (model_section(path, placed) for path in (SCORE_CONFIG, RELAX_CONFIG))
    t0 = time.perf_counter()
    diff_ckpt = val_sample.make_demo_checkpoint(root, score_cfg, name="painn_so3")
    mlff_ckpt = val_sample.make_demo_checkpoint(root, mlff_cfg, mode="s2ef", name="gemnet_relax")
    print(f"[calc] checkpoints by make_demo_checkpoint in {time.perf_counter() - t0:.3f} s: painn_so3.yml "
          f"(H={score_cfg['hidden_channels']}, {score_cfg['num_layers']} layers, cell_reps {score_cfg['cell_reps']}), "
          f"gemnet_relax.yml (fused_quad {mlff_cfg['fused_quad']}, cell_reps {mlff_cfg['cell_reps']}), "
          f"resolved over {len(placed)} adslabs of {sorted({len(a) for a in placed})} atoms", flush=True)

    # 3. the calculator: run_diffusion (exactly 600 launches), the engine called directly, calculate card vs CPU,
    # relax (1 + 4 launches a forward)
    calc = AdsorbDiffCalculator(checkpoint_path=diff_ckpt, mlff_checkpoint_path=mlff_ckpt, device=device)
    steps = calc.denoising_pos_params["num_steps"]
    want_sample = {"painn_message_fused": score_cfg["num_layers"] * steps}
    first, first_s, got = counted_calls("run_diffusion", lambda: calc.run_diffusion(adslab), want_sample)
    launches.update(got)
    gen_seed = 7
    out, sample_s, got = counted_calls(
        "run_diffusion", lambda: calc.run_diffusion(adslab, torch.Generator(device=device).manual_seed(gen_seed)),
        want_sample)
    launches.update(got)
    model = load_model(diff_ckpt, device, sampling=True)
    engine = DiffusionEngine(make_score_fn(model), calc.denoising_pos_params, static_fn=model.prepare_static,
                             device=device)
    batch = collate([atoms_to_system(adslab)], max_atoms=-(-len(adslab) // 8) * 8, device=device)
    res, _, got = counted_calls("DiffusionEngine.run", lambda: engine.run(
        batch, generator=torch.Generator(device=device).manual_seed(gen_seed)), want_sample)
    launches.update(got)
    del model, engine
    if not np.array_equal(out.positions, res.batch.pos[0, :len(adslab)].cpu().numpy()):
        raise AssertionError("run_diffusion differs from DiffusionEngine.run with the same generator")
    worst = max(placed_rigidly("run_diffusion", adslab, first), placed_rigidly("run_diffusion", adslab, out))
    print(f"[calc] run_diffusion of one adslab ({len(adslab)} atoms, B=1 x {batch.max_atoms}): {steps} steps in "
          f"{sample_s:.3f} s, {steps / sample_s:.1f} system-steps/s (first call, the checkpoint's load included: "
          f"{first_s:.3f} s); launches {want_sample} each; equal to DiffusionEngine.run with the same generator bit "
          f"for bit; slab unmoved, adsorbate rigid (largest distance change {worst:.2e} A)", flush=True)

    forwards = collections.Counter()
    mlff = calc._mlff_model()
    hook = mlff.register_forward_pre_hook(lambda module, args: forwards.update(["forward"]))
    try:
        # card against CPU: on the placed adslab the slab is a perfect fcc lattice, whose neighbour shells put
        # ties at the tables' truncation (K = 30, 20, 8), so roundoff and sort order pick different edges on
        # each device; the gate holds on a copy with every atom moved by N(0, 0.05 A), whose tables agree
        cpu_calc = AdsorbDiffCalculator(checkpoint_path=diff_ckpt, mlff_checkpoint_path=mlff_ckpt, device="cpu")
        jittered = out.copy()
        jittered.positions = out.positions + np.random.default_rng(33).normal(0.0, 0.05, out.positions.shape)
        results = {}
        for name, atoms in (("lattice", out), ("jittered", jittered)):
            card, _, got = counted_calls("calculate", lambda: calc.calculate(atoms), gemnet_launches(mlff, 1))
            launches.update(got)
            results[name] = (card, cpu_calc.calculate(atoms), tied_rows(calc._batch(atoms), mlff))
        card, cpu, ties = results["lattice"]
        placed_energy = card["energy"]
        print(f"[calc] calculate on the placed adslab: card {card['energy']:.4f} eV, CPU {cpu['energy']:.4f} eV "
              f"(|diff| {abs(card['energy'] - cpu['energy']):.4f}, forces "
              f"{np.abs(card['forces'] - cpu['forces']).max():.3e}); rows whose tables differ card against CPU "
              f"{ties}, every differing edge a tie at its row's truncation", flush=True)
        card, cpu, ties = results["jittered"]
        if any(ties.values()):
            raise AssertionError(f"the jittered adslab's tables differ card against CPU in rows {ties}")
        check_model("AdsorbDiffCalculator.calculate GemNet-OC (jittered adslab, equal tables)", (
            ("energy", torch.tensor([card["energy"]]), torch.tensor([cpu["energy"]])),
            ("forces", torch.from_numpy(card["forces"]), torch.from_numpy(cpu["forces"]))))
        del cpu_calc
        forwards.clear()
        relaxed, relax_s, got = counted_calls(
            "relax", lambda: calc.relax(out, steps=A_RELAX_STEPS, fmax=0.01, relax_opt=A_RELAX_OPT),
            lambda _: gemnet_launches(mlff, forwards["forward"]))
        launches.update(got)
    finally:
        hook.remove()
    fixed = adslab.fixed
    if not (fixed.any() and np.array_equal(relaxed.positions[fixed], out.positions[fixed])):
        raise AssertionError("relax moved fixed slab atoms")
    if not (np.isfinite(relaxed.positions).all() and np.isfinite(relaxed.energy) and np.isfinite(relaxed.forces).all()):
        raise AssertionError("relax gave non-finite positions, energy or forces")
    relax_steps = forwards["forward"] - 1  # the last forward is the final state's full build
    det = DetectTrajAnomaly(out, relaxed, out.tags)
    flags = dict(dissociated=det.is_adsorbate_dissociated(), desorbed=det.is_adsorbate_desorbed(),
                 surface_changed=det.has_surface_changed(), intercalated=det.is_adsorbate_intercalated())
    print(f"[calc] relax (gemnet_relax.yml's relax_opt, fmax 0.01, {A_RELAX_STEPS} steps of 300): "
          f"{forwards['forward']} forwards in {relax_s:.3f} s, {relax_steps / relax_s:.2f} relax system-steps/s; "
          f"launches {got}; energy {placed_energy:.4f} -> {relaxed.energy:.4f} eV; fixed atoms unmoved; anomaly "
          f"flags {flags}", flush=True)
    del calc, mlff

    # 4. both examples in-process through their main(argv), at full width
    gemnet_forwards = collections.Counter()
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, args: gemnet_forwards.update(["forward"]) if isinstance(module, GemNetOC) else None)
    ckpts = ["--diffusion-ckpt", diff_ckpt, "--mlff-ckpt", mlff_ckpt, "--num-steps", str(steps),
             "--relax-steps", str(A_RELAX_STEPS)]
    try:
        for name, example, argv, runs in (
                ("val_sample", val_sample, ckpts, lambda r: 1),
                ("nrr_screening", nrr_screening, ckpts + ["--bulks", str(A_NRR_BULKS)], lambda r: r["runs"])):
            gemnet_forwards.clear()
            result, wall, got = counted_calls(name, lambda: example.main(argv), lambda r: dict(
                painn_message_fused=want_sample["painn_message_fused"] * runs(r),
                gemnet_quad_chain=mlff_cfg["num_blocks"] * gemnet_forwards["forward"],
                masked_legendre_cos=gemnet_forwards["forward"]))
            launches.update(got)
            if name == "val_sample":
                placed_rigidly("val_sample's diffusion", result["adslab"], result["placed"])
                summary = (f"energy {result['energy']:.4f} -> {result['relaxed'].energy:.4f} eV, anomaly flags "
                           f"{result['anomalies']}")
            else:
                if result["runs"] != 2 * A_NRR_BULKS or len(result["rows"]) + result["anomalies"] != result["runs"]:
                    raise AssertionError(f"nrr_screening: {result}")
                summary = (f"{result['runs']} adslabs, {result['anomalies']} anomalous, rows "
                           f"{[(r['bulk'], r['adsorbate'], round(r['e_ml'], 4)) for r in result['rows']]}")
            print(f"[examples] {name} (--num-steps {steps} --relax-steps {A_RELAX_STEPS}, the phase's checkpoints): "
                  f"{wall:.3f} s, {gemnet_forwards['forward']} GemNet-OC forwards, launches {got}; {summary}",
                  flush=True)
    finally:
        hook.remove()
    print(f"[calc] phase 33: {time.perf_counter() - t_phase:.1f} s wall, launches {dict(launches)}", flush=True)
    return launches


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
    pipeline_dir = tempfile.TemporaryDirectory()  # phase 16's tree stays for phase 31's eval command
    files = pipeline_path(device, systems, pipeline_dir.name)
    so3_root = os.path.join(pipeline_dir.name, "so3")
    os.makedirs(so3_root)
    denoising_tasks_path(device, torch.Generator().manual_seed(17), systems[:SO3_RELAX_BATCH], so3_root)
    s2ef_launches = s2ef_tasks_path(device, systems, pipeline_dir.name, files, smi)
    # 20-22. S2EF training: the quad chain's VJP, gemnet_relax.yml's trainer, card vs CPU
    quad_vjp_path(device, torch.Generator().manual_seed(20))
    with tempfile.TemporaryDirectory() as root:
        s2ef_launches.update(s2ef_training_path(device, root, smi))
    # 23-24. the options of ROADMAP A.7: Langevin sampling, accumulated training and the plateau schedule
    s2ef_launches.update(langevin_path(device, systems))
    with tempfile.TemporaryDirectory() as root:
        s2ef_launches.update(options_training_path(device, root))
    # 25-28. ROADMAP A.8 step 1: the bf16 variants, then PaiNN and GemNet-OC in bf16 and both trainers with amp
    relax_kw = bf16_relax_kw(device, systems[:RELAX_BATCH])
    relax16 = GemNetOC(**relax_kw, compute_dtype="bfloat16", generator=torch.Generator().manual_seed(3))
    bf16_rows = bf16_kernel_checks(device, torch.Generator().manual_seed(25), systems, relax16)
    bf16_rows += bf16_eqv2_kernel_checks(device, torch.Generator().manual_seed(26), systems)
    bf16 = collections.Counter(bf16_sampling_path(device, systems))
    bf16.update(bf16_relax_path(device, systems[:RELAX_BATCH], relax16, relax_kw))
    del relax16
    with tempfile.TemporaryDirectory() as root:
        bf16.update(bf16_training_path(device, root))
    # 29-30. ROADMAP A.8 step 2: EquiformerV2 in bf16, sampling and amp training
    bf16.update(bf16_eqv2_sampling_path(device, systems))
    with tempfile.TemporaryDirectory() as root:
        bf16.update(bf16_eqv2_training_path(device, root))
    # 31. ROADMAP A.10 step 1: reference checkpoints converted by the port's command line and run on the card
    with tempfile.TemporaryDirectory() as root:
        s2ef_launches.update(reference_checkpoint_path(device, systems, files, rows, root, smi))
    # 32. ROADMAP A.10 step 2: the reference's LMDB data converted by the port, trained from and relaxed on the card
    with tempfile.TemporaryDirectory() as root:
        s2ef_launches.update(reference_data_path(device, root, smi))
    # 33. ROADMAP A items 1-4: the placement toolkit, AdsorbDiffCalculator and both examples at full width
    with tempfile.TemporaryDirectory() as root:
        s2ef_launches.update(placement_calculator_path(device, root, smi))
    pipeline_dir.cleanup()
    for r in bf16_rows:
        r["launches"] = bf16[r["name"]]
    rows += bf16_rows

    # 34. results
    for r in rows:
        if r["launches"] is None:  # a standalone kernel: what the path runs launched of it
            r["launches"] = PATH_LAUNCHES[r["name"]]
        elif r["name"] in s2ef_launches:  # the f32 paths' kernels: phases 19, 21, 23, 24 and 31-33 too
            r["launches"] += s2ef_launches[r["name"]]
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
