"""Design choices of the S^2 activation backward kernel, each undone in turn and timed on one NVIDIA card.

Builds variants of csrc/s2_grid_silu_bwd.cu (only its NC = 19 instance),
each the committed source with one design choice undone, checks each against
the plain version at phase 13b's shape, and times them in turns with CUDA
events (list order, reversed, list order, ...):

- final: the committed kernel, launched from s2_grid_silu_bwd_plan;
- block-per-group: the same binary with one block per 256-column group (not
  persistent: every block stages the tables);
- one-chain: each dot as one FMA chain in place of an even and an odd one;
- two-blocks: the launch bound and the plan at 2 blocks (8 warps) an SM;
- fast-intrinsics: the sigmoid from __expf and __fdividef in place of the
  flush-to-zero exp2 and reciprocal;
- ieee-division: the sigmoid from __expf and an IEEE division;
- device-function: a column group's body moved into a __device__
  __forceinline__ function called from the kernel's loop;
- parent (with --parent DIR): the kernel of another checkout, with its own
  launch (a commit before the redesign is launched as it was then).

For each it prints ptxas's register and spill line, the grid-point loop's
instructions by opcode from the SASS (cuobjdump) and how its shared-memory loads
are addressed (LDS [UR]: one uniform register for the warp; LDS [R]: a
register a thread), then every time and the SM clock nvidia-smi read
meanwhile.  h and dy [12, 80, 20, 19, 64], random from a seeded generator;
the eqv2_so3.yml tables (lmax 4, mmax 2, grid 18).

    python scripts/variants_s2_grid_silu_bwd.py [--rounds 3] [--parent DIR]

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

SHAPE = (12, 80, 20, 19, 64)  # h at phase 13b: [B, N, K, NC, C]
INSTANCE = re.compile(r"ILi(19|20)E")  # NC = 19's instance (a kernel templated on NC rounded up to 4: 20)
ONE_INSTANCE = "    S2B_CASE(19)\n"
SIGMOID_FTZ = '''  float e, s;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(g * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(1.f + e));'''
LOOP_HEAD = "  for (long long group = blockIdx.x; group * (kThreads * kCols) < ncols; group += gridDim.x) {\n"


def _replace(text, old, new):
    if old not in text:
        raise SystemExit(f"variants_s2_grid_silu_bwd: the source no longer holds {old!r}")
    return text.replace(old, new)


def _device_function(text):
    """The column group's body moved out of the kernel into a device function."""
    start = text.index(LOOP_HEAD) + len(LOOP_HEAD)
    end = text.index("\n  }\n}\n", start)
    body = "\n".join(line[2:] if line.startswith("    ") else line for line in text[start:end].splitlines())
    helper = ("template <int NC>\n__device__ __forceinline__ void column_group(const float* __restrict__ h, "
              "const float* __restrict__ dy, const float* to_s, const float* from_s, float* __restrict__ dh, "
              "long long group, long long ncols, int C, int G) {\n"
              "  constexpr int NCP = (NC + 3) & ~3;\n  constexpr int NQ = NCP / 4;\n" + body + "\n}\n\n")
    text = text[:start] + "    column_group<NC>(h, dy, to_s, from_s, dh, group, ncols, C, G);" + text[end:]
    kernel = text.index("template <int NC>\n__global__")
    return text[:kernel] + helper + text[kernel:]


def variant_sources(src):
    """{name: (source, blocks per SM or "groups")} of the committed source."""
    src = re.sub(r"    S2B_CASE\(1\).*?S2B_CASE\(32\)\n", ONE_INSTANCE, src, flags=re.S)
    return {
        "final": (src, 3),
        "block-per-group": (src, "groups"),
        "one-chain": (_replace(src, "if (r % 2 == 0) {", "if (true) {"), 3),
        "two-blocks": (_replace(src, "__launch_bounds__(kThreads, NC <= 19 ? 3 : 2)",
                                "__launch_bounds__(kThreads, 2)"), 2),
        "fast-intrinsics": (_replace(src, SIGMOID_FTZ, "  const float s = __fdividef(1.f, 1.f + __expf(-g));"), 3),
        "ieee-division": (_replace(src, SIGMOID_FTZ, "  const float s = 1.f / (1.f + __expf(-g));"), 3),
        "device-function": (_device_function(src), 3),
    }


def sass_summary(cuobjdump, so):
    """(instructions of the grid-point loop, its opcodes by count, LDS with a
    uniform address, LDS with a per-thread address) of the NC = 19
    instance."""
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    instrs, function = [], ""
    for line in sass.splitlines():
        if "Function :" in line:
            function = line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;)", line)
        if m and INSTANCE.search(function):
            instrs.append((int(m.group(1), 16), m.group(3), m.group(2)))
    loops = []
    for addr, op, text in instrs:
        target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", text)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            ffma = sum(1 for a, o, _ in instrs if lo <= a <= addr and o == "FFMA")
            loops.append((addr - lo, lo, addr, ffma))
    inner = [(lo, hi) for _, lo, hi, ffma in sorted(loops) if ffma >= 100]
    if not inner:
        return None, None, None, None
    lo, hi = inner[0]
    body = [text for a, _, text in instrs if lo <= a <= hi]
    ops = collections.Counter(op for a, op, _ in instrs if lo <= a <= hi)
    lds = [t for t in body if re.match(r"(?:@!?U?P\w+\s+)?LDS", t)]
    return len(body), ops, sum("[UR" in t for t in lds), sum("[R" in t for t in lds)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", help="another checkout whose csrc/s2_grid_silu_bwd.cu is timed beside these")
    args = ap.parse_args()

    import torch

    import chip_smoke as smoke
    from adsorbdiff_tpu_torch.models import equiformer_v2
    from adsorbdiff_tpu_torch.ops import build, kernels

    if not torch.cuda.is_available():
        raise SystemExit("variants_s2_grid_silu_bwd: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = smoke.resolve_device(None)  # also switches TF32 off
    sms = kernels._sm_count(device)

    with open(os.path.join(build.CSRC_DIR, "s2_grid_silu_bwd.cu")) as f:
        sources = variant_sources(f.read())
    if args.parent:
        with open(os.path.join(args.parent, "adsorbdiff_tpu_torch", "csrc", "s2_grid_silu_bwd.cu")) as f:
            sources["parent"] = (f.read(), None)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (text, _) in sources.items():
        path = os.path.join(out_dir, f"s2_grid_silu_bwd_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        so = os.path.join(out_dir, f"s2_grid_silu_bwd_{name}.so")
        function, ptxas = "", []
        for line in log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                function = line
            elif ("registers" in line or "spill" in line) and INSTANCE.search(function):
                ptxas.append(line.strip())
        loop, ops, uniform, per_thread = sass_summary(cuobjdump, so)
        mix = ", ".join(f"{op} {n}" for op, n in ops.most_common()) if ops else ""
        print(f"[variant] {name}: ptxas {' | '.join(ptxas)}; grid-point loop {loop} instructions ({mix}), LDS [UR] "
              f"{uniform}, LDS [R] {per_thread}", flush=True)
        fn = ctypes.CDLL(so).s2_grid_silu_bwd_f32
        planned = "int G, long long blocks, int smem" in sources[name][0]  # the C entry takes a plan
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + ([ctypes.c_longlong, ctypes.c_int] if planned else []) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (fn, planned, sources[name][1])

    gen = torch.Generator().manual_seed(0)
    to_m, from_m = (torch.from_numpy(t).to(device) for t in equiformer_v2.s2_act_matrices(4, 2, 18))
    h, dy = (torch.randn(SHAPE, generator=gen).to(device) for _ in range(2))
    nc, c = SHAPE[-2:]
    m = h.numel() // (nc * c)
    plan = kernels.s2_grid_silu_bwd_plan(m, nc, c, to_m.shape[0], sms)
    groups = -(-m * c // plan.tile)

    def call(name):
        fn, planned, per_sm = libs[name]
        dh = torch.empty_like(h)
        ptrs = (h.data_ptr(), dy.data_ptr(), to_m.data_ptr(), from_m.data_ptr(), dh.data_ptr(), m, nc, c,
                to_m.shape[0])
        launch = ()
        if planned:
            launch = (groups if per_sm == "groups" else min(groups, per_sm * sms), plan.smem_bytes)
        err = fn(*ptrs, *launch, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant {name}: launch failed (cudaError {err})")
        return dh

    want = kernels.s2_grid_silu_bwd_reference(h, dy, to_m, from_m)
    for name in libs:
        got = call(name)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        limit = 1e-4 * want.abs().max().item() + 1e-5
        if not err <= limit:
            raise AssertionError(f"variant {name}: max |kernel - plain| {err} > {limit}")

    order = []
    for r in range(args.rounds):
        order += list(libs) if r % 2 == 0 else list(libs)[::-1]
    clock = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
                             stdout=subprocess.PIPE, text=True)
    times = collections.defaultdict(list)
    for name in order:
        times[name].append(smoke.cuda_ms(lambda: call(name), 50))
    clock.terminate()
    samples = sorted(int(x) for x in clock.communicate()[0].split())
    bound = smoke.s2_bwd_bound_ms(h, dy, to_m, from_m, want)[0]
    for name in libs:
        t = times[name]
        print(f"[time] {name}: {', '.join(f'{x:.4f}' for x in t)} ms; {100 * bound / min(t):.1f}% of the "
              f"{bound:.4f} ms bound at the best", flush=True)
    median = samples[len(samples) // 2] if samples else None
    print(f"[clock] SM clock median {median} MHz over {len(samples)} samples", flush=True)
    print(json.dumps({"device": smi, "sm_clock_mhz": median, "bound_ms": bound, "ms": dict(times)}), flush=True)


if __name__ == "__main__":
    main()
