"""PaiNN's bf16 message kernel on the tensor cores against the kernels it replaces, on one NVIDIA card.

At the bf16 PaiNN sample's message inputs (painn_so3.yml widths, B=16 bench
systems on their graph, K=50, R=128, H=512, inputs from a seeded generator,
as chip_smoke.py phase 25 takes them), times in turns (list order, reversed,
list order, ...) the device time of each, by CUDA events around 50 calls
enqueued behind a sleep (chip_smoke.device_ms), then the wrapper's wall
back to back:

- mma / mma.vf32: this checkout's bf16 kernel (csrc/painn_message_fused_bf16.cu)
  through the wrapper, vec bf16 (PaiNN's layers 1-2) and f32 (layers 3-6),
  W's pack included; mma.kernel: its launch alone on a packed W;
- mma.dense: the same kernel built from a copy of the source in which every
  tile multiplies every 16-row chunk (the dense product; the rows outside a
  tile's windows are 0, so its result is the same), launched alone;
- mma.no-gather / mma.no-products / mma.pre-pass: ablations, each built from
  a copy of the source without the gather-multiply, without the products
  (so without the fragment loads), or without the main kernel (the pre-pass
  alone); their results are wrong by design, so they are timed and not held
  against the plain version;
- f32: this checkout's f32 kernel (csrc/painn_message_fused.cu) on the same
  values widened, timed next to the parent's f32 entry;
- parent / parent.vf32 / parent.f32 (with --parent DIR, a checkout of the
  commit before this kernel, unpacked with `git archive`; its csrc/ is
  enough): that checkout's painn_message_fused_bf16, _bf16_vf32 (the f32 plan
  with bf16 rows widened into f32 shared memory, f32 FMAs) and f32 entries,
  built from its csrc/ with nvcc and launched as its wrapper launched them
  (W cast to bf16 on each call for the bf16 entries).

Each but the ablations is first held against the plain version (1e-3 *
max|plain| + 1e-5, chip_smoke.py's gate; 1e-4 for the f32 kernels).  For each library it prints ptxas's register and
spill lines and the SASS opcode counts of its kernels (cuobjdump: HMMA, the
tensor-core products; FFMA, f32 FMAs; MUFU; LDSM, ldmatrix; the parent's
bf16 instances only), then every time, the share of the bound and the
card's name and power limit.

    python scripts/variants_painn_bf16_mma.py [--rounds 3] [--parent DIR]

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
# edits of csrc/painn_message_fused_bf16.cu, each (what it finds, what it puts in its place): the dense product
# (every chunk in each tile's range), and three ablations (no gather-multiply, no products, the pre-pass alone)
EDITS = {
    "dense": [(re.compile(r"  const int cl = [^\n]*\n  const int ch = [^\n]*\n"),
               "  const int cl = 0, ch = (R - 1) / 16;\n")],
    "no-gather": [(re.compile(r"if \(srow >= 0 && cols\) \{"), "if (srow >= 0 && cols && a.tpb < 0) {")],
    "no-products": [(re.compile(r"            if \(in0\) mma::mma_bf16[^\n]*\n"
                                r"            if \(in1\) mma::mma_bf16[^\n]*\n"), "")],
    "pre-pass": [(re.compile(r"  painn_fwd_bf16_kernel<TV><<<[^\n]*\n"), "")],
}


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


def nvcc(build, src, so, csrc):
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc, "-o", so, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", help="a checkout whose painn_message_fused entries are timed beside these")
    args = ap.parse_args()

    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.data.schema import collate
    from adsorbdiff_tpu_torch.models.painn import PaiNN
    from adsorbdiff_tpu_torch.ops import build, kernels

    if not torch.cuda.is_available():
        raise SystemExit("variants_painn_bf16_mma: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = smoke.resolve_device(None)  # also switches TF32 off
    sms = kernels._sm_count(device)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    paths = build.build(["painn_message_fused", "painn_message_fused_bf16"])
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "painn_message_fused_bf16.cu")) as f:
        source = f.read()
    procs = {}
    for key, edits in EDITS.items():
        edited = source
        for pattern, text in edits:
            edited, n_subs = pattern.subn(lambda m: text, edited)
            if n_subs != 1:
                raise RuntimeError(f"variants_painn_bf16_mma: the {key} edit found {n_subs} places, not one")
        cu = os.path.join(out_dir, f"painn_message_fused_bf16_{key}.cu")
        with open(cu, "w") as f:
            f.write(edited)
        so = os.path.join(out_dir, f"libpainn_bf16_{key}.so")
        procs[key] = (so, nvcc(build, cu, so, build.CSRC_DIR))
    if args.parent:
        csrc = os.path.join(args.parent, "adsorbdiff_tpu_torch", "csrc")
        so = os.path.join(out_dir, "libparent_painn_message_fused.so")
        procs["parent"] = (so, nvcc(build, os.path.join(csrc, "painn_message_fused.cu"), so, csrc))
    libs, logs = {}, {}
    for key, (so, proc) in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
        libs[key] = ctypes.CDLL(so)

    main_kernel = lambda function: "painn_fwd_bf16_kernel" in function  # noqa: E731
    sass = {"painn_message_fused_bf16": sass_counts(cuobjdump, paths["painn_message_fused_bf16"]),
            "painn_message_fused_bf16 main kernel": sass_counts(cuobjdump, paths["painn_message_fused_bf16"],
                                                                main_kernel),
            "painn_message_fused_bf16 dense": sass_counts(cuobjdump, procs["dense"][0]),
            "painn_message_fused f32": sass_counts(cuobjdump, paths["painn_message_fused"])}
    for name in ("painn_message_fused_bf16", "painn_message_fused"):
        print(f"[build] {name}: ptxas {' | '.join(ptxas_of(build.build_logs.get(name, ''))) or 'built earlier'}",
              flush=True)
    for key in EDITS:
        print(f"[build] painn_message_fused_bf16 {key}: ptxas {' | '.join(ptxas_of(logs[key]))}", flush=True)
    if "parent" in libs:
        parent_bf16 = lambda function: PARENT_BF16 in function  # noqa: E731
        sass["parent painn_message_fused (bf16 instances)"] = sass_counts(cuobjdump, procs["parent"][0], parent_bf16)
        sass["parent painn_message_fused (f32 instances)"] = sass_counts(
            cuobjdump, procs["parent"][0], lambda function: "painn_fwd_kernel" in function and not parent_bf16(function))
        print(f"[build] parent painn_message_fused: ptxas {' | '.join(ptxas_of(logs['parent']))}", flush=True)
    for name, counts in sass.items():
        print(f"[sass] {name}: " + ", ".join(f"{op} {counts[op]}" for op in OPCODES), flush=True)

    # the bf16 sample's message inputs (chip_smoke.py phase 25)
    painn = PaiNN(**smoke.MODEL_KW, device=device)  # painn_so3.yml's widths
    k, r = painn.max_neighbors, painn.message_layers[0].rbf_proj.in_features
    h, cutoff = painn.hidden_channels, painn.cutoff
    del painn
    batch = collate(smoke.bench_systems(), max_atoms=80, device=device)
    nl, _, unit = smoke.generate_graph(batch, cutoff=cutoff, max_neighbors=k, cell_reps=smoke.MODEL_KW["cell_reps"])
    shape = (batch.batch_size, batch.max_atoms, k, r, h)
    gen = torch.Generator().manual_seed(25)
    x16 = smoke.bf16_message_inputs(gen, device, shape, cutoff, nl, unit)
    x16v = dict(x16, vec=x16["vec"].float())
    x32 = dict(x16, xh=x16["xh"].float(), vec=x16["vec"].float())
    b, n = shape[:2]
    plan16 = kernels.painn_bf16_plan(*shape, sms)
    plan32 = kernels.painn_fwd_plan(*shape, sms)
    wt = kernels.pack_painn_message_bf16(x16["weight"])

    def launch_bf16(fn, inputs, w):
        dx = torch.empty((b, n, h), dtype=torch.float32, device=device)
        dvec = torch.empty((b, n, 3, h), dtype=torch.float32, device=device)
        scratch = torch.empty(plan16.scratch_bytes, dtype=torch.uint8, device=device)
        err = fn(inputs["xh"].data_ptr(), inputs["vec"].data_ptr(), inputs["src"].data_ptr(),
                 inputs["dist"].data_ptr(), inputs["mask"].data_ptr(), inputs["unit"].data_ptr(), w.data_ptr(),
                 inputs["bias"].data_ptr(), dx.data_ptr(), dvec.data_ptr(), scratch.data_ptr(), *shape, 1.0 / cutoff,
                 5, plan16.tpb, plan16.w_stride, plan16.smem_bytes, plan16.range_off, plan16.record_off,
                 plan16.scratch_bytes, stream())
        if err != 0:
            raise RuntimeError(f"painn_message_fused_bf16 failed (cudaError {err})")
        return dx, dvec

    lib16 = build.load("painn_message_fused_bf16")
    argtypes16 = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    entries = {"mma.kernel": lib16.painn_message_fused_bf16_mma}
    entries.update({f"mma.{key}": libs[key].painn_message_fused_bf16_mma for key in EDITS})
    for fn in entries.values():
        fn.argtypes, fn.restype = argtypes16, ctypes.c_int

    def parent(variant, inputs):
        fn = getattr(libs["parent"], f"painn_message_fused_{variant}")
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            w = inputs["weight"] if variant == "f32" else inputs["weight"].to(torch.bfloat16)
            dx = torch.empty((b, n, h), dtype=torch.float32, device=device)
            dvec = torch.empty((b, n, 3, h), dtype=torch.float32, device=device)
            err = fn(inputs["xh"].data_ptr(), inputs["vec"].data_ptr(), inputs["src"].data_ptr(),
                     inputs["dist"].data_ptr(), inputs["mask"].data_ptr(), inputs["unit"].data_ptr(), w.data_ptr(),
                     inputs["bias"].data_ptr(), dx.data_ptr(), dvec.data_ptr(), *shape, 1.0 / cutoff, 5, plan32.tpb,
                     int(plan32.stage_w), int(plan32.stage_rows), plan32.rows, plan32.smem_bytes, stream())
            if err != 0:
                raise RuntimeError(f"the parent's painn_message_fused_{variant} failed (cudaError {err})")
            return dx, dvec
        return run

    fns = {"mma": lambda: kernels.painn_message_fused(**x16, cutoff=cutoff),
           "mma.vf32": lambda: kernels.painn_message_fused(**x16v, cutoff=cutoff)}
    fns.update({name: (lambda fn=fn: launch_bf16(fn, x16, wt)) for name, fn in entries.items()})
    if args.parent:
        fns.update({"parent": parent("bf16", x16), "parent.vf32": parent("bf16_vf32", x16v)})
    fns["f32"] = lambda: kernels.painn_message_fused(**x32, cutoff=cutoff)
    if args.parent:  # beside this checkout's f32 kernel, in either order
        fns["parent.f32"] = parent("f32", x32)
    ablations = ("mma.no-gather", "mma.no-products", "mma.pre-pass")  # wrong by design: timed, not held
    want16 = kernels.painn_message_fused_reference(**x16, cutoff=cutoff)
    want = {"mma": want16, "mma.vf32": kernels.painn_message_fused_reference(**x16v, cutoff=cutoff),
            "f32": kernels.painn_message_fused_reference(**x32, cutoff=cutoff)}
    for name, fn in fns.items():
        if name in ablations:
            continue
        got = fn()
        torch.cuda.synchronize()
        ref = "mma.vf32" if name.endswith("vf32") else "f32" if name.endswith("f32") else "mma"
        smoke.check_close(name, got, want[ref], smoke.KERNEL_RTOL if ref == "f32" else 1e-3)

    order = []
    for rnd in range(args.rounds):
        order += list(fns) if rnd % 2 == 0 else list(fns)[::-1]
    times = collections.defaultdict(list)
    for name in order:  # device time: the calls enqueued behind a sleep, so the host's cost of a call hides
        times[name].append(smoke.device_ms(fns[name], 50))
    walls = [smoke.cuda_ms(fns["mma"], 200) for _ in range(args.rounds)]  # the wrapper back to back
    bound_ms, bound_by, nbytes, flops = smoke.message_bound_ms(x16, want16, cutoff)
    print(f"[inputs] {shape} (bench graph, vec bf16): bound {bound_ms:.4f} ms by {bound_by} "
          f"({smoke.flops_text(flops, True)}, {nbytes / 1e6:.2f} MB); {smoke.bf16_plan_line(plan16)}", flush=True)
    for name, ts in times.items():
        best = min(ts)
        print(f"[time] {name}: {' '.join(f'{t:.4f}' for t in ts)} ms (best {best:.4f}, "
              f"{100 * bound_ms / best:.1f}% of the bf16 bound)", flush=True)
    print(f"[time] mma, the wrapper's wall back to back (host included): {' '.join(f'{t:.4f}' for t in walls)} ms",
          flush=True)
    print(f"[card] {smi}", flush=True)
    print(json.dumps({"card": smi, "shape": shape, "bound_ms": bound_ms, "times_ms": times, "mma_wall_ms": walls,
                      "sass": {k: {op: v[op] for op in OPCODES} for k, v in sass.items()}}), flush=True)


if __name__ == "__main__":
    main()
