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
   times from CUDA events after warm-up.
4. sampling path: PaiNN at the painn_so3.yml widths (H=512, 6 layers, 128
   RBF, cutoff 12 A, K=50; random weights from a seeded generator) drives 100
   ODE reverse-diffusion steps through DiffusionEngine with the hoisted
   static graph, on bench.py's 16 synthetic 80-atom systems.  Launch counts
   are zeroed just before and read just after: 6 layers x 100 steps.
5. card vs CPU, PaiNN: one full-width forward at B=2 on the card against the
   same forward on the CPU (plain versions), |card - cpu| <= 1e-4 * max|cpu|
   (f32 matmuls and sums in another order, over 6 layers; tight enough that
   TF32 or bf16 products, ~1e-3 relative each, would fail it).
6. relaxation path: GemNet-OC at the gemnet_relax.yml widths (4 blocks, atom
   256, edge 512, 128 RBF, 7 spherical, cutoff 12 A, 30/8/20 neighbours, all
   interactions; random weights from a seeded generator; cell_reps from
   auto_cell_reps) relaxes 8 of the bench systems with RelaxationEngine at
   the published relax_opt and the Verlet graph on, for 100 L-BFGS steps
   (cut from 300).  Launch counts are zeroed just before and read just
   after: 4 quad-chain launches per model forward, forwards counted by a
   wrapper around the engine's energy/forces function.
7. card vs CPU, GemNet-OC: one full-width forward at B=2, energy and forces
   within 1e-4 * max|cpu|.
8. the kernels line, then the device line as the last line.

It imports nothing of JAX and nothing of the JAX package.
"""
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch.device import resolve_device
from adsorbdiff_tpu_torch.models.base import generate_graph
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC
from adsorbdiff_tpu_torch.models.painn import PaiNN
from adsorbdiff_tpu_torch.ops import build, kernels, pbc
from adsorbdiff_tpu_torch.relaxation.lbfgs import make_mlff_energy_forces
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, make_score_fn

# NVIDIA H100 SXM data sheet: dense f32 outside the tensor cores, HBM3 rate
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
MODEL_RTOL = 1e-4
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


def bound(flops, tensors):
    """Least time on this card: the f32 operations at the f32 peak against
    every given tensor moved once at the HBM rate.  Returns (ms, what sets
    it, bytes)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
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


def message_bound_ms(inputs, outputs):
    """The function's f32 operations on the valid edges (filter product 6RH,
    gather-multiply, reductions and directional terms ~20H, gaussian basis
    ~10R per edge) against its inputs and outputs moved once."""
    r, f3 = inputs["weight"].shape
    h = f3 // 3
    flops = int(inputs["mask"].sum()) * (6 * r * h + 20 * h + 10 * r)
    return (*bound(flops, list(inputs.values()) + list(outputs)), flops)


def check_message_kernel(device, gen, shape, cutoff, nl=None, unit=None):
    inputs = message_inputs(gen, device, *shape, cutoff, nl=nl, unit=unit)
    got = kernels.painn_message_fused(**inputs, cutoff=cutoff)
    torch.cuda.synchronize()
    want = kernels.painn_message_fused_reference(**inputs, cutoff=cutoff)
    err = check_close(f"painn_message_fused b,n,k,r,h={shape}", got, want)
    return inputs, got, err


# --------------------------------------------------------------------------
# gemnet_quad_chain
# --------------------------------------------------------------------------
def quad_inputs(gen, device, b, n, u, q, k2, s, e, f):
    """Chain inputs with keys from a small range (c == d collisions are
    frequent), -1 main-edge keys (never match) and zero n1/n2 rows (masked
    edges have unit = 0)."""
    n1 = torch.randn((b, n, u, q, 3), generator=gen)
    n2 = torch.randn((b, n, q, k2, 3), generator=gen)
    n1[:, :, -2:] = 0.0
    n2[:, :, :, -3:] = 0.0
    key1 = torch.randint(0, 50, (b, n, u), generator=gen, dtype=torch.int32)
    key1[..., -3:] = -1
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


def check_quad_kernel(device, gen, shape):
    s = shape[5]
    inputs = quad_inputs(gen, device, *shape)
    got = kernels.gemnet_quad_chain(**inputs, num_spherical=s)
    torch.cuda.synchronize()
    want = kernels.gemnet_quad_chain_reference(**inputs, num_spherical=s)
    err = check_close(f"gemnet_quad_chain b,n,u,q,k2,s,e,f={shape}", [got], [want])
    return inputs, got, err


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
    for ragged in ((2, 13, 10, 16, 64), (1, 37, 45, 128, 192)):
        check_message_kernel(device, gen, ragged, 6.0)
    ms = cuda_ms(lambda: kernels.painn_message_fused(**inputs, cutoff=model.cutoff), 20)
    plain_ms = cuda_ms(lambda: kernels.painn_message_fused_reference(**inputs, cutoff=model.cutoff), 5)
    bound_ms, bound_by, nbytes, flops = message_bound_ms(inputs, outputs)
    print(f"[kernel] painn_message_fused at {main_shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP f32, {nbytes / 1e6:.2f} MB)", flush=True)
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
    launches = dict(kernels.launches)
    want_launches = model.num_layers * PARAMS["num_steps"]
    if launches.get("painn_message_fused", 0) != want_launches:
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

    # 5. card vs CPU, whole model at B=2
    small = collate(systems[:2], max_atoms=80, device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        card = model(small)
        host = cpu_model(small.to("cpu"))
    check_model("PaiNN", zip(("out_forces", "out_forces2"), card, host))
    return dict(name="painn_message_fused", source="adsorbdiff_tpu_torch/csrc/painn_message_fused.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:336",
                launches=launches["painn_message_fused"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_model(model_name, pairs):
    """Card against CPU outputs: finite and within 1e-4 * max|cpu|."""
    for name, c, h in pairs:
        e = (c.cpu() - h).abs().max().item()
        limit = MODEL_RTOL * h.abs().max().item()
        if not (torch.isfinite(c).all() and e <= limit):
            raise AssertionError(f"card vs CPU {model_name} {name}: max |diff| {e} > {limit}")
        print(f"[check] card vs CPU {model_name} {name}: max |diff| {e:.3e} "
              f"(limit {MODEL_RTOL} * max|cpu| = {limit:.3e})", flush=True)


def relax_path(device, gen, systems):
    """Phases 3 (gemnet_quad_chain), 6 and 7."""
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], GEMNET_KW["cutoff"])
    batch = collate(systems, max_atoms=80, device=device)
    model = GemNetOC(**GEMNET_KW, cell_reps=cell_reps, device=device, generator=gen)
    b, n = batch.batch_size, batch.max_atoms
    s = model.num_spherical
    shape = (b, n, model.max_neighbors, model.max_neighbors_qint, model.max_neighbors, s, model.emb_size_quad_in,
             model.emb_size_sbf)
    inputs, out, err = check_quad_kernel(device, gen, shape)
    check_quad_kernel(device, gen, (2, 7, 12, 4, 13, 4, 8, 8))
    ms = cuda_ms(lambda: kernels.gemnet_quad_chain(**inputs, num_spherical=s), 20)
    plain_ms = cuda_ms(lambda: kernels.gemnet_quad_chain_reference(**inputs, num_spherical=s), 5)
    bound_ms, bound_by, nbytes, flops = quad_bound_ms(inputs, out, s)
    print(f"[kernel] gemnet_quad_chain at {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({flops / 1e9:.2f} GFLOP f32 = {flops / F32_FLOPS * 1e3:.4f} ms, {nbytes / 1e6:.2f} MB = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del inputs, out

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
    launches = dict(kernels.launches)
    want_launches = model.num_blocks * forwards
    if launches.get("gemnet_quad_chain", 0) != want_launches:
        raise AssertionError(f"relaxation path launched {launches}, want gemnet_quad_chain x{want_launches} "
                             f"({model.num_blocks} blocks x {forwards} forwards)")
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
    print(f"[relax] one model forward (Verlet refresh + 4 blocks + heads): {forward_ms:.3f} ms; "
          f"{model.num_blocks} kernel launches at {ms:.4f} ms = {100 * model.num_blocks * ms / forward_ms:.1f}% "
          f"of it", flush=True)

    # 7. card vs CPU, whole model at B=2
    small = collate(systems[:2], max_atoms=80, device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        card = model(small)
        host = cpu_model(small.to("cpu"))
    check_model("GemNet-OC", ((name, card[name], host[name]) for name in ("energy", "forces")))
    return dict(name="gemnet_quad_chain", source="adsorbdiff_tpu_torch/csrc/gemnet_quad_chain.cu",
                replaces="adsorbdiff_tpu/ops/pallas_kernels.py:1728",
                launches=launches["gemnet_quad_chain"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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

    # 3-7. each path: its kernel against the plain version, the path, card vs CPU
    systems = bench_systems()
    rows = [
        sampling_path(device, torch.Generator().manual_seed(0), systems),
        relax_path(device, torch.Generator().manual_seed(3), systems[:RELAX_BATCH]),
    ]

    # 8. results
    print(json.dumps({"kernels": [
        dict(name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"], launches=r["launches"],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=None)  # no single PyTorch call computes either function
        for r in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
