"""Design choices of the painn_message_consumer kernel, undone one at a time, on one card.

Every variant is csrc/painn_message_consumer.cu with one text substitution
(launched with the chunks and shared bytes of its own exported layout), or
the final source launched with another plan (W read through L1/L2),
built with the port's nvcc flags, held against the plain version within
chip_smoke.py's gate and timed with CUDA events at the
bench layer (the second PaiNN message layer of the B=16 sampling batch,
features gathered in torch: M = 1280 targets, K = 50, R = 128, H = 512), the
variants in turns, ``--readings`` readings each.  ``--parent DIR`` adds the
kernel of another checkout (an older commit unpacked with ``git archive``),
launched through its own C interface at ti = 1 and ti = 8.  Two diagnostic
variants, timed but not checked (their output is wrong on purpose), leave
out the reading of the rows or the basis and filter: what is left of the
time when one side is gone.

    python scripts/variants_painn_message_consumer.py [--readings 3] [--parent DIR]

The last line is one JSON object with every reading.
"""
import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from adsorbdiff_tpu_torch.data.schema import collate  # noqa: E402
from adsorbdiff_tpu_torch.models import painn  # noqa: E402
from adsorbdiff_tpu_torch.models.painn import PaiNN  # noqa: E402
from adsorbdiff_tpu_torch.ops import build, kernels  # noqa: E402

SOURCE = "painn_message_consumer.cu"
LOAD = "        load_rows<V2>(xr, vr, a, row, vm, hA, F);"
CONSUME = "        // ---- gather-multiply and directional term"
# name -> [(old text, new text), ..] in csrc/painn_message_consumer.cu
VARIANTS = {
    "final": [],
    "no sort (a batch of one target: 8 consecutive slots a group)": [
        ("constexpr int kBatch = 4;", "constexpr int kBatch = 1;")],
    "batches of 5 targets": [("constexpr int kBatch = 4;", "constexpr int kBatch = 5;")],
    "batches of 10 targets, runs of 512 slots": [("constexpr int kBatch = 4;", "constexpr int kBatch = 10;"),
                                                 ("constexpr int kSlotCap = 256;", "constexpr int kSlotCap = 512;")],
    "distances read from device memory at a group's start": [("          d = dsc[i];",
                                                              "          d = __ldg(a.dist + row) * a.inv_cutoff;")],
    "rows loaded after the filter loop": [(LOAD + "  // in flight while the basis and the filter run\n", ""),
                                          (CONSUME, LOAD + "\n" + CONSUME)],
    "rows through __ldg (not streaming)": [("return __ldcs(reinterpret_cast<const float2*>(p));",
                                            "return __ldg(reinterpret_cast<const float2*>(p));")],
    "row loop unrolled by 2": [("constexpr int kUnrollSW = 4;", "constexpr int kUnrollSW = 2;")],
    "row loop not unrolled": [("constexpr int kUnrollSW = 4;", "constexpr int kUnrollSW = 1;")],
}
# name -> substitutions whose output is wrong on purpose: timed, not checked
DIAGNOSTICS = {
    "diagnostic: rows not read": [("const bool okA = (vm >> i & 1u) && hA < H;", "const bool okA = false;")],
    "diagnostic: no basis, no filter": [("for (int plo = lo; plo <= hi; plo += kWin) {",
                                         "for (int plo = lo; plo <= hi && false; plo += kWin) {")],
}
PLAN_VARIANTS = {"W through L1/L2": "final"}  # name -> the source it launches, with stage_w off
ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
PARENT_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def layout(lib, r, h, stage_w, sms):
    """``(chunks, shared bytes)`` of a built variant: its exported layout
    (painn_message_consumer_layout: bytes a block, columns a block) and
    kernels.consumer_plan's rule for the chunks."""
    fn = lib.painn_message_consumer_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    cols = ctypes.c_int()
    smem = fn(r, int(stage_w), ctypes.byref(cols))
    return max(1, sms // -(-h // cols.value)), smem


def build_sources(sources, out_dir):
    """Compile ``{name: (source text, include dir)}`` with the port's nvcc
    flags, one process each, all started together; returns ``{name: CDLL}``
    and the ptxas lines of each."""
    procs = {}
    for i, (name, (text, include)) in enumerate(sources.items()):
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libv{i}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", include, "-o", lib, src]
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
    """The second PaiNN message layer of the B=16 sampling batch with its
    features gathered (chip_smoke.py phase 3d's inputs)."""
    gen = torch.Generator().manual_seed(15)
    batch = collate(smoke.bench_systems(), max_atoms=80, device=device)
    model = PaiNN(**smoke.MODEL_KW, device=device, generator=gen)
    with torch.no_grad():
        calls = smoke.capture_calls(painn, "painn_message_fused", lambda: model(batch))
    xh, vec, src, dist, mask, unit, weight, bias = calls[1]
    b, n, k = src.shape
    m, f3 = b * n, weight.shape[1]
    idx = src.reshape(b, n * k, 1).long().expand(-1, -1, f3)
    return dict(dist=dist.reshape(m, k).contiguous(), mask=mask.reshape(m, k).contiguous(),
                unit=unit.reshape(m, k, 3).contiguous(), xh_gathered=torch.gather(xh, 1, idx).reshape(m, k, f3),
                vec_gathered=torch.gather(vec, 1, idx).reshape(m, k, f3), weights=weight, bias=bias), model.cutoff


@torch.no_grad()
def variants(device, readings, parent):
    layer, cutoff = bench_layer(device)
    want = kernels.painn_message_consumer_reference(**layer, cutoff=cutoff)
    limits = [smoke.KERNEL_RTOL * w.abs().max().item() + smoke.KERNEL_ATOL for w in want]
    with open(os.path.join(build.CSRC_DIR, SOURCE)) as f:
        final = f.read()
    sources = {}
    for name, subs in {**VARIANTS, **DIAGNOSTICS}.items():
        text = final
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in csrc/{SOURCE}")
            text = text.replace(old, new)
        sources[name] = (text, build.CSRC_DIR)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR if os.path.isdir(build.BUILD_DIR) else None) as tmp:
        if parent:
            parent_csrc = os.path.join(tmp, "parent_csrc")
            os.makedirs(parent_csrc)
            for path in glob.glob(os.path.join(parent, "adsorbdiff_tpu_torch", "csrc", "*.cuh")):
                shutil.copy(path, parent_csrc)
            with open(os.path.join(parent, "adsorbdiff_tpu_torch", "csrc", SOURCE)) as f:
                sources["parent"] = (f.read(), parent_csrc)
        libs, logs = build_sources(sources, tmp)
        m, k = layer["dist"].shape
        r, f3 = layer["weights"].shape
        h = f3 // 3
        plan = kernels.consumer_plan(m, k, r, h, kernels._sm_count(device))
        ptrs = [layer[name].data_ptr() for name in ("dist", "mask", "unit", "xh_gathered", "vec_gathered", "weights",
                                                    "bias")]
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(name, source, stage_w=plan.stage_w, ti=None):
            out = (torch.empty_like(want[0]), torch.empty_like(want[1]))
            fn = libs[source].painn_message_consumer_f32
            if ti is not None:  # the parent's interface: ti targets a block
                fn.argtypes = PARENT_ARGS
                args = (*ptrs, out[0].data_ptr(), out[1].data_ptr(), m, k, r, h, ti, 1.0 / cutoff, 5, stream)
            else:
                fn.argtypes = ARGS
                chunks, smem = layout(libs[source], r, h, stage_w, kernels._sm_count(device))
                args = (*ptrs, out[0].data_ptr(), out[1].data_ptr(), m, k, r, h, 1.0 / cutoff, 5, min(chunks, m),
                        int(stage_w), int(plan.vec), smem, stream)

            def run():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            return run, out

        launches = {name: launcher(name, name) for name in {**VARIANTS, **DIAGNOSTICS}}
        launches.update({name: launcher(name, source, stage_w=False) for name, source in PLAN_VARIANTS.items()})
        if parent:
            launches.update({f"parent ti={ti}": launcher(f"parent ti={ti}", "parent", ti=ti) for ti in (1, 8)})
        runs = {}
        for name, (run, out) in launches.items():
            run()
            torch.cuda.synchronize()
            errs = [(g - w).abs().max().item() for g, w in zip(out, want)]
            if name not in DIAGNOSTICS and not all(e <= lim for e, lim in zip(errs, limits)):
                raise AssertionError(f"painn_message_consumer variant {name}: max |kernel - plain| {errs} > {limits}")
            runs[name] = run
            source = name if name in logs else PLAN_VARIANTS.get(name, "parent")
            print(f"[consumer] {name}: max_abs_err {max(errs):.3e} (limits {limits[0]:.3e}, {limits[1]:.3e}); "
                  f"ptxas: {' | '.join(logs[source][-8:])}", flush=True)
        times = {name: [] for name in runs}
        for _ in range(readings):
            for name, run in runs.items():
                times[name].append(smoke.cuda_ms(run, 20))
        bound_ms, by, nbytes, _ = smoke.consumer_bound_ms(layer, want, cutoff)
        for name, ts in times.items():
            print(f"[consumer] {name}: {', '.join(f'{t:.4f}' for t in ts)} ms (best {min(ts):.4f}, "
                  f"{100 * bound_ms / min(ts):.1f}% of the {bound_ms:.4f} ms bound by {by}, {nbytes / 1e6:.2f} MB)",
                  flush=True)
    return times


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--readings", type=int, default=3)
    ap.add_argument("--parent", default=None, help="a checkout whose painn_message_consumer.cu is timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variants_painn_message_consumer: torch.cuda.is_available() is False; this run needs an "
                         "NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    device = smoke.resolve_device(None)
    build.build(["painn_message_fused", "painn_message_consumer"])
    print(json.dumps({"device": smi, "painn_message_consumer_ms": variants(device, args.readings, args.parent)}))


if __name__ == "__main__":
    main()
