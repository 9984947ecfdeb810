"""The bf16 tensor-core forms of eqv2_attn_conv1 and s2_grid_silu against the kernels they replace, on one NVIDIA card.

At the inputs of one bf16 EquiformerV2 forward at the eqv2_so3.yml widths
(B=16 bench systems, random weights from a seeded generator, as
chip_smoke.py phase 25 takes them), times in turns with CUDA events (list
order, reversed, list order, ...):

- conv1.mma / s2.mma: this checkout's bf16 kernels (csrc/eqv2_attn_conv1_bf16.cu,
  csrc/s2_grid_silu_bf16.cu) through their wrappers, weight and table packing
  included;
- conv1.f32 / s2.f32: this checkout's f32 kernels on the same values widened;
- conv1.parent / s2.parent (with --parent DIR, a checkout of the commit
  before the tensor-core forms, unpacked with `git archive`; its csrc/ is
  enough): that checkout's bf16 entries (f32 shared memory and FMAs), built
  from its csrc/ with nvcc and launched as its wrappers launched them (the
  weights rounded to bf16 by pack_attn_conv1, the f32 plans), packing
  included; conv1.parent-f32 / s2.parent-f32: its f32 entries on the f32
  values, beside this checkout's.

Each kernel is first held against its bf16 plain version (one bf16 ulp of
the largest element + 1e-5, chip_smoke.py's gate). For each library it
prints ptxas's register and spill lines and the SASS opcode counts of its
bf16 kernels (cuobjdump: HMMA, the tensor-core products; FFMA, f32 FMAs;
MUFU; LDSM, ldmatrix), then every time, the share of the bound, the SiLU's
SFU floor (two SFU operations a sigmoid, 16 a clock per SM, at the SM
clock nvidia-smi read meanwhile) and the card's name and power limit.

    python scripts/variants_eqv2_bf16_mma.py [--rounds 3] [--parent DIR]

The last line is one JSON object with every time.
"""
import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPCODES = ("HMMA", "FFMA", "MUFU", "LDSM")
PARENT_BF16 = "13__nv_bfloat16"  # the parent's bf16 template instances' mangled names hold it


def sass_counts(cuobjdump, so, keep=lambda function: True):
    """{opcode: count} over the kernels of library ``so`` whose SASS function
    line ``keep`` accepts."""
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
    counts, function = collections.Counter(), ""
    for line in sass.splitlines():
        if "Function :" in line:
            function = line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and keep(function):
            counts[m.group(1)] += 1
    return counts


def ptxas_of(log, keep=lambda function: True):
    lines, function = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            function = line
        elif ("registers" in line or "spill" in line) and keep(function):
            lines.append(line.strip())
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", help="a checkout whose bf16 conv1 and S^2 entries are timed beside these")
    args = ap.parse_args()

    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.data.schema import collate
    from adsorbdiff_tpu_torch.models import equiformer_v2
    from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2
    from adsorbdiff_tpu_torch.ops import build, kernels

    if not torch.cuda.is_available():
        raise SystemExit("variants_eqv2_bf16_mma: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = smoke.resolve_device(None)  # also switches TF32 off
    sms = kernels._sm_count(device)
    bf16 = torch.bfloat16

    names = ("s2_grid_silu", "s2_grid_silu_bf16", "eqv2_attn_conv1", "eqv2_attn_conv1_bf16")
    paths = build.build(names)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = {}
    for name in ("s2_grid_silu_bf16", "eqv2_attn_conv1_bf16"):
        sass[name] = sass_counts(cuobjdump, paths[name])
        print(f"[build] {name}: ptxas {' | '.join(ptxas_of(build.build_logs.get(name, ''))) or 'built earlier'}",
              flush=True)
    parent = {}
    if args.parent:
        out_dir = os.path.join(build.BUILD_DIR, "parent")
        os.makedirs(out_dir, exist_ok=True)
        csrc = os.path.join(args.parent, "adsorbdiff_tpu_torch", "csrc")
        procs = {}
        for name in ("s2_grid_silu", "eqv2_attn_conv1"):
            so = os.path.join(out_dir, f"lib{name}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc, "-o", so, os.path.join(csrc, name + ".cu")]
            procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
            keep = lambda function: PARENT_BF16 in function  # noqa: E731
            sass["parent " + name] = sass_counts(cuobjdump, so, keep)
            print(f"[build] parent {name} (bf16 instances): ptxas {' | '.join(ptxas_of(log, keep))}", flush=True)
            lib = ctypes.CDLL(so)
            for variant in ("bf16", "f32"):
                fn = getattr(lib, f"{name}_{variant}")
                if name == "s2_grid_silu":
                    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
                else:
                    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float, ctypes.c_float]
                                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
                fn.restype = ctypes.c_int
                parent[name, variant] = fn
    for name, counts in sass.items():
        print(f"[sass] {name}: " + ", ".join(f"{op} {counts[op]}" for op in OPCODES), flush=True)

    # the inputs of one bf16 forward (chip_smoke.py phase 25)
    model = EquiformerV2(**smoke.EQV2_KW, compute_dtype="bfloat16", device=device,
                         generator=torch.Generator().manual_seed(7))
    batch = collate(smoke.bench_systems(), max_atoms=80, device=device)
    static = model.prepare_static(batch)
    with torch.no_grad():
        calls = smoke.capture_first_calls(equiformer_v2, ("eqv2_attn_conv1", "s2_grid_silu"),
                                          lambda: model(batch, static))
    h, to_m, from_m = calls["s2_grid_silu"][0]
    c_args, c_kw = calls["eqv2_attn_conv1"]
    c_args = list(c_args)
    c32 = [t if t.dtype == torch.bool else t.float() for t in c_args[:6]] + c_args[6:]
    h32 = h.float()
    nc, c = h.shape[-2:]
    m = h.numel() // (nc * c)

    def s2_parent(variant="bf16"):
        x = h if variant == "bf16" else h32
        out = torch.empty_like(x)
        plan = kernels.s2_grid_silu_plan(m, nc, c, to_m.shape[0])
        err = parent["s2_grid_silu", variant](x.data_ptr(), to_m.data_ptr(), from_m.data_ptr(), out.data_ptr(), m,
                                              nc, c, to_m.shape[0], plan.blocks, plan.smem_bytes,
                                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's s2_grid_silu_{variant} failed (cudaError {err})")
        return out

    def conv1_parent(variant="bf16"):
        dist, mask, emb_s, emb_t, msg_s, msg_t, rad, conv = c_args if variant == "bf16" else c32
        dt = bf16 if variant == "bf16" else torch.float32
        packed = kernels.pack_attn_conv1(rad, conv, lmax=c_kw["lmax"], mmax=c_kw["mmax"],
                                         num_gauss=c_kw["num_gauss"], c_in=msg_s.shape[-1], dtype=dt)
        nb = packed.n_blocks
        e_dim, hidden = emb_s.shape[-1], packed.trunk[6].shape[0]
        lead = tuple(dist.shape)
        e = dist.numel()
        extra_out = torch.empty(lead + (c_kw["extra"],), dtype=dt, device=device)
        hh = torch.empty(lead + (msg_s.shape[-2], c_kw["c_out"]), dtype=dt, device=device)
        plan = kernels.attn_conv1_plan(e, c_kw["num_gauss"], e_dim, hidden, msg_s.shape[-1], c_kw["c_out"],
                                       c_kw["extra"], nb, sms)
        err = parent["eqv2_attn_conv1", variant](
            *(t.data_ptr() for t in (dist, mask, emb_s, emb_t, msg_s, msg_t)), *(t.data_ptr() for t in packed.trunk),
            packed.flat_conv.data_ptr(), extra_out.data_ptr(), hh.data_ptr(), e, c_kw["num_gauss"], e_dim, hidden,
            msg_s.shape[-1], c_kw["c_out"], c_kw["extra"], (ctypes.c_int * len(nb))(*nb), len(nb),
            float(c_kw["cutoff"]), float(c_kw.get("width_scalar", 2.0)), plan.blocks, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's eqv2_attn_conv1_{variant} failed (cudaError {err})")
        return hh, extra_out

    fns = {"s2.mma": lambda: kernels.s2_grid_silu(h, to_m, from_m),
           "s2.f32": lambda: kernels.s2_grid_silu(h32, to_m, from_m),
           "conv1.mma": lambda: kernels.eqv2_attn_conv1(*c_args, **c_kw),
           "conv1.f32": lambda: kernels.eqv2_attn_conv1(*c32, **c_kw)}
    if parent:
        fns["s2.parent"] = s2_parent
        fns["s2.parent-f32"] = lambda: s2_parent("f32")
        fns["conv1.parent"] = conv1_parent
        fns["conv1.parent-f32"] = lambda: conv1_parent("f32")
    want = {"s2": [kernels.s2_grid_silu_reference(h, to_m, from_m)],
            "conv1": list(kernels.eqv2_attn_conv1_reference(*c_args, **c_kw))}
    for name, fn in fns.items():
        if name.endswith("f32"):
            continue
        got = fn()
        torch.cuda.synchronize()
        smoke.check_eqv2(name, list(got) if isinstance(got, tuple) else [got], want[name.split(".")[0]], True)

    order = []
    for r in range(args.rounds):
        order += list(fns) if r % 2 == 0 else list(fns)[::-1]
    clock = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
                             stdout=subprocess.PIPE, text=True)
    times = collections.defaultdict(list)
    for name in order:
        times[name].append(smoke.cuda_ms(fns[name], 20 if name.startswith("s2") else 10))
    clock.terminate()
    samples = sorted(int(x) for x in clock.communicate()[0].split())
    median = samples[len(samples) // 2] if samples else None
    bounds = {"s2": smoke.s2_bound_ms(h, to_m, from_m, want["s2"][0])[0],
              "conv1": smoke.conv1_bound_ms(c_args, c_kw, want["conv1"])[0]}
    for name in fns:
        t = times[name]
        print(f"[time] {name}: {', '.join(f'{x:.4f}' for x in t)} ms; {100 * bounds[name.split('.')[0]] / min(t):.1f}% "
              f"of the {bounds[name.split('.')[0]]:.4f} ms bound (bf16 products at the bf16 tensor rate) at the best",
              flush=True)
    sigmoids = h.numel() // nc * to_m.shape[0]
    floor = 2 * sigmoids / (16 * sms * median * 1e6) * 1e3 if median else None
    print(f"[clock] SM clock median {median} MHz over {len(samples)} samples; the S^2 SiLU's SFU floor "
          f"{floor if floor is None else round(floor, 4)} ms ({sigmoids} sigmoids, two SFU operations each)",
          flush=True)
    print(json.dumps({"device": smi, "sm_clock_mhz": median, "bound_ms": bounds, "sfu_floor_ms": floor,
                      "sass": {k: {op: v[op] for op in OPCODES} for k, v in sass.items()}, "ms": dict(times)}),
          flush=True)


if __name__ == "__main__":
    main()
