"""Design choices of the fused_rbf_filter and grouped masked_legendre_cos kernels, undone one at a time, on one card.

fused_rbf_filter: every variant is csrc/fused_rbf_filter.cu with one text
substitution (the same launch plan and layout), built with the port's nvcc
flags, held against the plain version within chip_smoke.py's gate and timed
with CUDA events at the bench layer (the second PaiNN message layer of the
B=16 sampling batch: E = 64,000 edges, R = 128, F = 1536), the variants in
turns, ``--readings`` readings each.  ``--parent DIR`` adds the kernel of
another checkout (an older commit unpacked with ``git archive``), launched
through its own C interface.

masked_legendre_cos: the grouped call of one B=8 GemNet-OC forward (e2e, a2e
and e2a) with the plan's most columns a block (ops/kernels.py::_LG_COLUMNS)
set to 512 .. 4096, held against the plain versions, its device time from
20 calls behind a torch.cuda._sleep, in turns.

    python scripts/variants_rbf_legendre.py [--readings 3] [--parent DIR]

The last line is one JSON object with every reading.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from adsorbdiff_tpu_torch.data.schema import collate  # noqa: E402
from adsorbdiff_tpu_torch.models import gemnet_oc, painn  # noqa: E402
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC  # noqa: E402
from adsorbdiff_tpu_torch.models.painn import PaiNN  # noqa: E402
from adsorbdiff_tpu_torch.ops import build, kernels, pbc  # noqa: E402

# name -> (old text, new text) in csrc/fused_rbf_filter.cu
RBF_VARIANTS = {
    "final": None,
    "consecutive edges (no sort)": ("const int pos = cnt_s[key] + rank;", "const int pos = tid;"),
    "expf": ("buf[idx] = __expf(", "buf[idx] = expf("),
    "plain stores": ("if (col0 < F) __stcs(reinterpret_cast<float4*>(row + col0), v);",
                     "if (col0 < F) *reinterpret_cast<float4*>(row + col0) = v;"),
    "row loop unrolled by 2": ("constexpr int kUnroll = STAGE_W ? 4 : 2;", "constexpr int kUnroll = 2;"),
    "row loop not unrolled": ("constexpr int kUnroll = STAGE_W ? 4 : 2;", "constexpr int kUnroll = 1;"),
}
RBF_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]
PARENT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                                                                  ctypes.c_void_p]


def build_sources(sources, out_dir):
    """Compile ``{name: source text}`` with the port's nvcc flags, one
    process each, all started together; returns ``{name: CDLL}`` and the
    ptxas lines of each."""
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libv{i}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
        logs[name] = [line.strip() for line in out.splitlines() if "registers" in line or "spill" in line]
    return libs, logs


def bench_layer(device):
    """The second PaiNN message layer's distances, mask and filter weights
    of the B=16 sampling batch (chip_smoke.py phase 3e's inputs)."""
    gen = torch.Generator().manual_seed(15)
    batch = collate(smoke.bench_systems(), max_atoms=80, device=device)
    model = PaiNN(**smoke.MODEL_KW, device=device, generator=gen)
    with torch.no_grad():
        calls = smoke.capture_calls(painn, "painn_message_fused", lambda: model(batch))
    _, _, src, dist, mask, _, weight, bias = calls[1]
    b, n, k = src.shape
    return dict(dist=dist.reshape(b * n, k).contiguous(), mask=mask.reshape(b * n, k).contiguous(), weights=weight,
                bias=bias), model.cutoff


def rbf_variants(device, readings, parent):
    filt, cutoff = bench_layer(device)
    want = kernels.fused_rbf_filter_reference(**filt, cutoff=cutoff)
    limit = smoke.KERNEL_RTOL * want.abs().max().item() + smoke.KERNEL_ATOL
    with open(os.path.join(build.CSRC_DIR, "fused_rbf_filter.cu")) as f:
        final = f.read()
    sources = {}
    for name, sub in RBF_VARIANTS.items():
        if sub is not None and sub[0] not in final:
            raise RuntimeError(f"variant {name!r}: {sub[0]!r} is not in csrc/fused_rbf_filter.cu")
        sources[name] = final if sub is None else final.replace(sub[0], sub[1])
    if parent:
        with open(os.path.join(parent, "adsorbdiff_tpu_torch", "csrc", "fused_rbf_filter.cu")) as f:
            sources["parent"] = f.read()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR if os.path.isdir(build.BUILD_DIR) else None) as tmp:
        libs, logs = build_sources(sources, tmp)
        e, (r, f) = filt["dist"].numel(), filt["weights"].shape
        plan = kernels.rbf_filter_plan(e, r, f, kernels._sm_count(device))
        ptrs = [filt[k].data_ptr() for k in ("dist", "mask", "weights", "bias")]
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(name):
            out = torch.empty_like(want)
            fn = libs[name].fused_rbf_filter_f32
            if name == "parent":
                fn.argtypes = PARENT_ARGS
                args = (*ptrs, out.data_ptr(), e, r, f, 1.0 / cutoff, 5, stream)
            else:
                fn.argtypes = RBF_ARGS
                args = (*ptrs, out.data_ptr(), e, r, f, 1.0 / cutoff, 5, plan.blocks, int(plan.stage_w),
                        int(plan.vec), plan.smem_bytes, stream)

            def run():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            return run, out

        runs = {}
        for name in sources:
            run, out = launcher(name)
            run()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if not err <= limit:
                raise AssertionError(f"fused_rbf_filter variant {name}: max |kernel - plain| {err} > {limit}")
            runs[name] = run
            print(f"[rbf] {name}: max_abs_err {err:.3e} (limit {limit:.3e}); ptxas: {' | '.join(logs[name][-4:])}",
                  flush=True)
        times = {name: [] for name in runs}
        for _ in range(readings):
            for name, run in runs.items():
                times[name].append(smoke.cuda_ms(run, 20))
        for name, ts in times.items():
            print(f"[rbf] {name}: {', '.join(f'{t:.4f}' for t in ts)} ms (best {min(ts):.4f})", flush=True)
    return times


def legendre_columns(device, readings):
    gen = torch.Generator().manual_seed(3)
    systems = smoke.bench_systems(smoke.RELAX_BATCH)
    cell_reps = pbc.auto_cell_reps([s.pos for s in systems], [s.cell for s in systems], smoke.GEMNET_KW["cutoff"])
    batch = collate(systems, max_atoms=80, device=device)
    model = GemNetOC(**smoke.GEMNET_KW, cell_reps=cell_reps, device=device, generator=gen)
    with torch.no_grad():
        calls = smoke.capture_calls(gemnet_oc, "gemnet_cbf_bases", lambda: model(batch))
    problems, s = [tuple(p) for p in calls[0][0]], model.num_spherical
    want = [kernels.gemnet_cbf_basis_reference(*p, s) for p in problems]
    default, times = kernels._LG_COLUMNS, {}

    def use(columns):
        kernels._LG_COLUMNS = columns
        for fn in (kernels.legendre_group_plan, kernels._legendre_table):
            fn.cache_clear()

    try:
        for _ in range(readings):
            for columns in (512, 1024, 2048, 4096):
                use(columns)
                for g, w in zip(kernels.gemnet_cbf_bases(problems, s), want):
                    err = (g - w).abs().max().item()
                    if not err <= smoke.KERNEL_RTOL * w.abs().max().item() + smoke.KERNEL_ATOL:
                        raise AssertionError(f"masked_legendre_cos at {columns} columns a block: max |kernel - plain| "
                                             f"{err}")
                times.setdefault(columns, []).append(smoke.device_ms(lambda: kernels.gemnet_cbf_bases(problems, s), 20))
    finally:
        use(default)
    for columns, ts in times.items():
        print(f"[legendre] {columns} columns a block: device {', '.join(f'{t:.4f}' for t in ts)} ms a forward "
              f"(best {min(ts):.4f})", flush=True)
    return {str(c): ts for c, ts in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--readings", type=int, default=3)
    ap.add_argument("--parent", default=None, help="a checkout whose fused_rbf_filter.cu is timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variants_rbf_legendre: torch.cuda.is_available() is False; this run needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = smoke.resolve_device(None)
    build.build(["fused_rbf_filter", "masked_legendre_cos", "painn_message_fused", "gemnet_quad_chain"])
    rbf = rbf_variants(device, args.readings, args.parent)
    legendre = legendre_columns(device, args.readings)
    print(json.dumps({"device": smi, "fused_rbf_filter_ms": rbf, "masked_legendre_cos_device_ms": legendre}))


if __name__ == "__main__":
    main()
