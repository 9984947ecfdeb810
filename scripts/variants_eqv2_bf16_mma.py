"""The bf16 tensor-core forms of EquiformerV2's kernels against the kernels they replace, on one NVIDIA card.

At the inputs of one bf16 EquiformerV2 forward at the eqv2_so3.yml widths
(B=16 bench systems, random weights from a seeded generator, as
chip_smoke.py phase 25 takes them; the S^2 backward at a B=12 forward's
input, the training shape, with a bf16 cotangent), times in turns with CUDA
events (list order, reversed, list order, ...):

- rot.mma / bwd.mma / s2.mma / conv1.mma: this checkout's bf16 kernels
  (csrc/eqv2_edge_rotate_bf16.cu, the backward entry of
  csrc/s2_grid_silu_bf16.cu and its forward, csrc/eqv2_attn_conv1_bf16.cu)
  through their wrappers;
- rot.f32 / bwd.f32 / s2.f32 / conv1.f32: this checkout's f32 kernels on the
  same values widened;
- bwd.ex2: this checkout's S^2 backward with the forward's sigmoid (ex2
  and rcp, two SFU operations, in place of one tanh.approx.f32), built
  from a text-edited copy of csrc/s2_grid_silu_bf16.cu and launched as the
  wrapper launches the backward;
- rot.parent / bwd.parent (with --parent DIR, a checkout of the commit
  before the tensor-core rotation and S^2 backward, unpacked with `git
  archive`; its csrc/ is enough): that checkout's `eqv2_edge_rotate_bf16`
  and `s2_grid_silu_bwd_bf16` entries (f32 FMAs), built from its csrc/ with
  nvcc and launched as its wrappers launched them; rot.parent-f32 /
  bwd.parent-f32: its f32 entries on the f32 values, beside this
  checkout's.

rot.* runs the three bf16 forms one forward launches in equal numbers (the
gathered source half, the node-level target half, the value rotation back)
and its times are per launch (a third of the three); rot.mma:gather,
rot.mma:node and rot.mma:from time each form alone.  Each bf16 kernel is
first held against its bf16 plain version (one bf16 ulp of the largest
element + 1e-5, chip_smoke.py's gate); ex2 and rcp are held to the same
gate at the path's input, at max |g| 100 and on random NC = 32 tables, and
its result printed (a miss is reported, not raised).  For each library it
prints ptxas's register and spill lines and the SASS opcode counts of its
kernels (cuobjdump: HMMA, the tensor-core products; FFMA, f32 FMAs; MUFU;
LDSM, ldmatrix), then every time, the share of the bound, the S^2
backward's SFU floor (two SFU operations a sigmoid with ex2 and rcp, one
with tanh, 16 a clock per SM, at the SM clock nvidia-smi read meanwhile)
and the card's name and power limit.

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
# the backward's sigmoid in csrc/s2_grid_silu_bf16.cu, and the forward's ex2 and rcp put in its place
TANH_SIGMOID = re.compile(r"  float th;\n  asm\(\"tanh\.approx\.f32 [^\n]*\n  const float s = fmaf\(0\.5f, th, 0\.5f\);\n")
EX2_SIGMOID = ('  float e, s;\n  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(e) : "f"(g * -1.4426950408889634f));\n'
               '  asm("rcp.approx.ftz.f32 %0, %1;\\n" : "=f"(s) : "f"(1.f + e));\n')


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


def nvcc(build, src, so, csrc, extra=()):
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-I", csrc, "-o", so, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", help="a checkout whose bf16 rotation and S^2 backward entries are timed beside these")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.data.schema import collate
    from adsorbdiff_tpu_torch.models import equiformer_v2, so3
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
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    names = ("s2_grid_silu", "s2_grid_silu_bf16", "s2_grid_silu_bwd", "eqv2_attn_conv1", "eqv2_attn_conv1_bf16",
             "eqv2_edge_rotate", "eqv2_edge_rotate_bf16")
    paths = build.build(names)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "s2_grid_silu_bf16.cu")) as f:
        ex2_source, n_subs = TANH_SIGMOID.subn(lambda m: EX2_SIGMOID, f.read())
    if n_subs != 1:
        raise RuntimeError("variants_eqv2_bf16_mma: the backward's tanh sigmoid was not found in s2_grid_silu_bf16.cu")
    ex2_cu = os.path.join(out_dir, "s2_grid_silu_bf16_ex2.cu")
    with open(ex2_cu, "w") as f:
        f.write(ex2_source)
    procs = {"ex2": (os.path.join(out_dir, "libs2_grid_silu_bf16_ex2.so"),
                     nvcc(build, ex2_cu, os.path.join(out_dir, "libs2_grid_silu_bf16_ex2.so"), build.CSRC_DIR))}
    if args.parent:
        csrc = os.path.join(args.parent, "adsorbdiff_tpu_torch", "csrc")
        for name in ("eqv2_edge_rotate", "s2_grid_silu_bwd"):
            so = os.path.join(out_dir, f"libparent_{name}.so")
            procs["parent " + name] = (so, nvcc(build, os.path.join(csrc, name + ".cu"), so, csrc))
    libs, logs = {}, {}
    for key, (so, proc) in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
        libs[key] = ctypes.CDLL(so)

    is_bwd = lambda function: "bwd_kernel" in function  # noqa: E731
    parent_bf16 = lambda function: PARENT_BF16 in function  # noqa: E731
    sass = {"eqv2_edge_rotate_bf16": sass_counts(cuobjdump, paths["eqv2_edge_rotate_bf16"]),
            "s2_grid_silu_bf16 bwd": sass_counts(cuobjdump, paths["s2_grid_silu_bf16"], is_bwd),
            "s2_grid_silu_bf16 bwd ex2": sass_counts(cuobjdump, procs["ex2"][0], is_bwd),
            "eqv2_edge_rotate f32": sass_counts(cuobjdump, paths["eqv2_edge_rotate"]),
            "s2_grid_silu_bwd f32": sass_counts(cuobjdump, paths["s2_grid_silu_bwd"])}
    for name in ("eqv2_edge_rotate_bf16", "s2_grid_silu_bf16"):
        keep = is_bwd if name == "s2_grid_silu_bf16" else (lambda function: True)
        print(f"[build] {name}: ptxas {' | '.join(ptxas_of(build.build_logs.get(name, ''), keep)) or 'built earlier'}",
              flush=True)
    print(f"[build] s2_grid_silu_bf16 ex2: ptxas {' | '.join(ptxas_of(logs['ex2'], is_bwd))}", flush=True)
    for name in ("eqv2_edge_rotate", "s2_grid_silu_bwd"):
        if "parent " + name in libs:
            sass["parent " + name] = sass_counts(cuobjdump, procs["parent " + name][0], parent_bf16)
            print(f"[build] parent {name} (bf16 instances): ptxas "
                  f"{' | '.join(ptxas_of(logs['parent ' + name], parent_bf16))}", flush=True)
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
    big = collate(smoke.bench_systems(smoke.EQV2_TRAIN_BATCH), max_atoms=80, device=device)
    with torch.no_grad():
        hb, _, _ = smoke.capture_first_calls(equiformer_v2, ("s2_grid_silu",), lambda: model(big))["s2_grid_silu"][0]
    gen = torch.Generator().manual_seed(26)
    dy = torch.randn(hb.shape, generator=gen).to(device).to(bf16)
    hb32, dy32 = hb.float(), dy.float()
    nc, cb = hb.shape[-2:]
    mb, g = hb.numel() // (nc * cb), to_m.shape[0]

    # the rotation's three bf16 forms at the batch's graph (chip_smoke.py check_rotations)
    nl, _, unit = smoke.generate_graph(batch, cutoff=model.cutoff, max_neighbors=model.max_neighbors,
                                       cell_reps=model.cell_reps)
    gamma, beta = so3.edge_euler_angles(unit)
    lmax, mmax, c = model.lmax, model.mmax, model.sphere_channels
    b, n, k = nl.src.shape
    dim, n_act = (lmax + 1) ** 2, so3.n_act_rows(lmax, mmax)
    x = torch.randn((b, n, dim, c), generator=gen).to(device).to(bf16)
    v = torch.randn((b, n, k, n_act, c), generator=gen).to(device).to(bf16)
    forms = [  # (x, src, direction, n_in, n_out, kdiv, nk, n_nodes)
        (x, nl.src, "to", dim, n_act, 1, n * k, n),
        (x[:, :, None], None, "to", dim, n_act, k, 1, 1),
        (v, None, "from", n_act, dim, 1, 1, 1)]

    def rot(dtype):
        xs = [f[0] if dtype == bf16 else f[0].float() for f in forms]
        return lambda: [kernels.eqv2_gather_rotate_to(xs[0], nl.src, gamma, beta, lmax, mmax),
                        kernels.eqv2_edge_rotate(xs[1], gamma, beta, lmax, mmax, direction="to"),
                        kernels.eqv2_edge_rotate(xs[2], gamma, beta, lmax, mmax, direction="from", n_sel=n_act)]

    def rot_parent(variant):
        fn = getattr(libs["parent eqv2_edge_rotate"], f"eqv2_edge_rotate_{variant}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        dt = bf16 if variant == "bf16" else torch.float32
        consts = {}
        for direction, n_sel in (("to", n_act), ("from", n_act)):
            j_blocks, sign, row = so3.edge_rot_consts(lmax, mmax, n_sel)
            if variant == "bf16":
                j_blocks = np.ascontiguousarray(torch.from_numpy(j_blocks).to(bf16).float().numpy())
            consts[direction] = (j_blocks, sign, row)
        xs = [f[0].to(dt).contiguous() for f in forms]

        def run():
            outs = []
            for xi, (_, src, direction, n_in, n_out, kdiv, nk, n_nodes) in zip(xs, forms):
                out = torch.empty((b, n, k, n_out, c), dtype=dt, device=device)
                j_blocks, sign, row = consts[direction]
                err = fn(xi.data_ptr(), None if src is None else src.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                         out.data_ptr(), b * n * k, c, n_in, n_out, kdiv, nk, n_nodes, lmax, int(direction == "to"),
                         j_blocks.ctypes.data, sign.ctypes.data, row.ctypes.data, stream())
                if err != 0:
                    raise RuntimeError(f"the parent's eqv2_edge_rotate_{variant} failed (cudaError {err})")
                outs.append(out)
            return outs
        return run

    def bwd_parent(variant):
        fn = getattr(libs["parent s2_grid_silu_bwd"], f"s2_grid_silu_bwd_{variant}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        hh, dd = (hb, dy) if variant == "bf16" else (hb32, dy32)
        plan = kernels.s2_grid_silu_bwd_plan(mb, nc, cb, g, sms)

        def run():
            dh = torch.empty_like(hh)
            err = fn(hh.data_ptr(), dd.data_ptr(), to_m.data_ptr(), from_m.data_ptr(), dh.data_ptr(), mb, nc, cb, g,
                     plan.blocks, plan.smem_bytes, stream())
            if err != 0:
                raise RuntimeError(f"the parent's s2_grid_silu_bwd_{variant} failed (cudaError {err})")
            return dh
        return run

    ex2_fn = libs["ex2"].s2_grid_silu_bf16_bwd_mma
    ex2_fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    ex2_fn.restype = ctypes.c_int

    def bwd_ex2(hh, dd, tm, fm):
        n_c, ch = hh.shape[-2:]
        m_ = hh.numel() // (n_c * ch)
        plan = kernels.s2_grid_silu_bf16_plan(m_, n_c, ch, tm.shape[0], sms, tiles=2)
        tables = kernels.s2_bf16_tables(tm, fm)
        dh = torch.empty_like(hh)
        err = ex2_fn(hh.data_ptr(), dd.data_ptr(), tables.data_ptr(), dh.data_ptr(), m_, n_c, ch,
                     kernels.s2_bf16_layout(n_c, tm.shape[0])[2], plan.blocks, plan.smem_bytes, stream())
        if err != 0:
            raise RuntimeError(f"the ex2 variant failed (cudaError {err})")
        return dh

    fns = {"rot.mma": rot(bf16), "rot.f32": rot(torch.float32),
           "rot.mma:gather": lambda: kernels.eqv2_gather_rotate_to(x, nl.src, gamma, beta, lmax, mmax),
           "rot.mma:node": lambda: kernels.eqv2_edge_rotate(x[:, :, None], gamma, beta, lmax, mmax, direction="to"),
           "rot.mma:from": lambda: kernels.eqv2_edge_rotate(v, gamma, beta, lmax, mmax, direction="from", n_sel=n_act),
           "bwd.mma": lambda: kernels.s2_grid_silu_bwd(hb, dy, to_m, from_m),
           "bwd.f32": lambda: kernels.s2_grid_silu_bwd(hb32, dy32, to_m, from_m),
           "bwd.ex2": lambda: bwd_ex2(hb, dy, to_m, from_m),
           "s2.mma": lambda: kernels.s2_grid_silu(h, to_m, from_m),
           "s2.f32": lambda: kernels.s2_grid_silu(h32, to_m, from_m),
           "conv1.mma": lambda: kernels.eqv2_attn_conv1(*c_args, **c_kw),
           "conv1.f32": lambda: kernels.eqv2_attn_conv1(*c32, **c_kw)}
    if args.parent:
        fns.update({"rot.parent": rot_parent("bf16"), "rot.parent-f32": rot_parent("f32"),
                    "bwd.parent": bwd_parent("bf16"), "bwd.parent-f32": bwd_parent("f32")})
    want = {"rot": [kernels.eqv2_gather_rotate_to_reference(x, nl.src, gamma, beta, lmax, mmax),
                    kernels.eqv2_edge_rotate_reference(x[:, :, None], gamma, beta, lmax, mmax, direction="to"),
                    kernels.eqv2_edge_rotate_reference(v, gamma, beta, lmax, mmax, direction="from", n_sel=n_act)],
            "bwd": [kernels.s2_grid_silu_bwd_reference(hb, dy, to_m, from_m)],
            "s2": [kernels.s2_grid_silu_reference(h, to_m, from_m)],
            "conv1": list(kernels.eqv2_attn_conv1_reference(*c_args, **c_kw))}
    gates = {}
    for name, fn in fns.items():
        if name.endswith("f32") or ":" in name:
            continue
        got = fn()
        torch.cuda.synchronize()
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        try:
            smoke.check_eqv2(name, got, want[name.split(".")[0]], True)
            gates[name] = "holds"
        except AssertionError as exc:  # a variant's miss is reported; the kernels of the checkouts raise
            if name != "bwd.ex2":
                raise
            gates[name] = f"misses: {exc}"
            print(f"[gate] {name} misses: {exc}", flush=True)
    # the other sigmoid at the S^2 backward's other gated inputs (chip_smoke.py phase 25)
    h_large = torch.randn((2, 40, nc, cb), generator=gen).to(device)
    h_large = (h_large * (100.0 / (to_m @ h_large).abs().max())).to(bf16)
    d_large = torch.randn(h_large.shape, generator=gen).to(device).to(bf16)
    r32 = [torch.randn(s, generator=gen).to(device) / 32 ** 0.5 for s in ((324, 32), (32, 324))]
    h32r, d32r = (torch.randn((3, 37, 32, 16), generator=gen).to(device).to(bf16) for _ in range(2))
    for what, a in (("max |g| 100", (h_large, d_large, to_m, from_m)), ("random NC=32 tables", (h32r, d32r, *r32))):
        try:
            smoke.check_eqv2(f"bwd.ex2 {what}", [bwd_ex2(*a)], [kernels.s2_grid_silu_bwd_reference(*a)], True)
        except AssertionError as exc:
            gates["bwd.ex2"] = f"misses ({what}): {exc}"
    print(f"[gate] the ex2 sigmoid: {gates['bwd.ex2']}", flush=True)

    order = []
    for r in range(args.rounds):
        order += list(fns) if r % 2 == 0 else list(fns)[::-1]
    clock = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
                             stdout=subprocess.PIPE, text=True)
    times = collections.defaultdict(list)
    for name in order:
        per = 3 if name.startswith("rot") and ":" not in name else 1  # rot.*: three launches a call
        times[name].append(smoke.cuda_ms(fns[name], 10 if name.startswith("conv1") else 20) / per)
    clock.terminate()
    samples = sorted(int(s) for s in clock.communicate()[0].split())
    median = samples[len(samples) // 2] if samples else None
    outs = fns["rot.mma"]()
    rot_bounds = [smoke.rotate_bound_ms(lmax, mmax, n_act, [f[0], gamma, beta] + ([] if f[1] is None else [f[1]]),
                                        o)[0] for f, o in zip(forms, outs)]
    bounds = {"rot": sum(rot_bounds) / 3,
              "bwd": smoke.s2_bwd_bound_ms(hb, dy, to_m, from_m, want["bwd"][0])[0],
              "s2": smoke.s2_bound_ms(h, to_m, from_m, want["s2"][0])[0],
              "conv1": smoke.conv1_bound_ms(c_args, c_kw, want["conv1"])[0]}
    for name in fns:
        t, bd = times[name], bounds[name.split(".")[0]]
        print(f"[time] {name}: {', '.join(f'{x:.4f}' for x in t)} ms; {100 * bd / min(t):.1f}% of the {bd:.4f} ms "
              f"bound (bf16 products at the bf16 tensor rate) at the best", flush=True)
    sigmoids = mb * cb * g
    floor = 2 * sigmoids / (16 * sms * median * 1e6) * 1e3 if median else None
    print(f"[clock] SM clock median {median} MHz over {len(samples)} samples; the S^2 backward's SFU floor at "
          f"h{tuple(hb.shape)}: {floor if floor is None else round(floor, 4)} ms ({sigmoids} sigmoids, two SFU "
          f"operations each; {floor if floor is None else round(floor / 2, 4)} ms with one tanh)", flush=True)
    print(json.dumps({"device": smi, "sm_clock_mhz": median, "bound_ms": bounds, "sfu_floor_ms": floor,
                      "ex2_gate": gates["bwd.ex2"],
                      "sass": {k: {op: v[op] for op in OPCODES} for k, v in sass.items()}, "ms": dict(times)}),
          flush=True)


if __name__ == "__main__":
    main()
