"""How often ``ops/pbc.py::_decode`` alone gives another result in a fresh
process (ROADMAP C.1: a process's first CPU forward of chip_smoke.py's
phase 5 now and then parted at ``graph.dist`` while the neighbours' d^2 were
equal).

The parent makes ``_decode``'s inputs once, on the CPU, as phase 5's B=2
PaiNN forward makes them (``radius_graph_pbc`` on the first two bench
systems at painn_so3.yml's cutoff and neighbour count, cell_reps (2, 2, 0)),
and saves them.  Then ``--runs`` fresh processes, one after another, each
load them and call ``_decode`` twice on the CPU; each call's outputs are
hashed, and every tensor each call makes is recorded op by op (a
``TorchFunctionMode``), so that a process names the first op whose output
differs between its two calls, with the largest difference and how many
elements differ.  A process whose first (or second) call hashes otherwise
than the most common result parts.

    python scripts/repeat_torch_decode.py [--runs 100] [--budget 480]

It stops early once ``--budget`` seconds have passed.  The last line is one
JSON object: the runs made, the distinct results of first and second calls
with their counts, and the runs that parted with their first differing op.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = """
import hashlib, sys, torch
from torch.overrides import TorchFunctionMode
sys.path.insert(0, {root!r})
from adsorbdiff_tpu_torch.ops import pbc


class Record(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {{}}))
        for t in (out if isinstance(out, tuple) else (out,)):
            if isinstance(t, torch.Tensor):
                self.outs.append((getattr(func, "__name__", str(func)), t.detach().clone()))
        return out


args = torch.load({path!r})
calls = []
for _ in range(2):
    with Record() as rec:
        nl = pbc._decode(*args)
    calls.append((hashlib.sha256(b"".join(t.contiguous().numpy().tobytes() for t in nl)).hexdigest()[:16], rec.outs))
where = "none"
for i, ((name, a), (_, b)) in enumerate(zip(calls[0][1], calls[1][1])):
    if not torch.equal(a, b):
        d = (a.double() - b.double()).abs()
        where = f"op{{i}}:{{name}}:max_diff={{d.max().item():.3e}}:n_diff={{int((d > 0).sum())}}/{{d.numel()}}"
        break
print(calls[0][0], calls[1][0], torch.get_num_threads(), torch.backends.cpu.get_cpu_capability(), where)
"""


def decode_inputs():
    """_decode's arguments for phase 5's B=2 PaiNN graph."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from adsorbdiff_tpu_torch.data.schema import collate
    from adsorbdiff_tpu_torch.models.painn import PaiNN
    from adsorbdiff_tpu_torch.ops import pbc

    model = PaiNN(**cs.MODEL_KW, device="cpu")
    batch = collate(cs.bench_systems()[:2], max_atoms=80, device="cpu")
    pos, cell = batch.pos, batch.cell
    b, n = pos.shape[:2]
    offsets_int, offsets_cart = pbc._offsets(model.cell_reps, cell)
    c = offsets_int.shape[0]
    d2 = pbc._pair_d2(pos, pos, offsets_cart)
    valid = batch.atom_mask[:, :, None, None] & batch.atom_mask[:, None, :, None]
    valid = valid & (d2 > 1.0e-4) & (d2 <= model.cutoff ** 2)
    big = torch.finfo(d2.dtype).max
    d2_top, fidx = pbc._smallest_k(torch.where(valid, d2, big).reshape(b, n, n * c), model.max_neighbors)
    return pos, cell, offsets_int, d2_top, fidx


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--budget", type=float, default=480.0, help="stop after this many seconds")
    args = ap.parse_args()
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decode_inputs.pt")
        torch.save(decode_inputs(), path)
        code = CHILD.format(root=ROOT, path=path)
        results, failed = [], 0
        for i in range(args.runs):
            if time.perf_counter() - t0 > args.budget:
                break
            r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
            if r.returncode:
                failed += 1
                print(f"run {i}: exit {r.returncode}\n{r.stderr[-2000:]}", flush=True)
                continue
            first, second, threads, capability, where = r.stdout.split()
            results.append((i, first, second, where))
            print(f"run {i}: first {first}, second {second} ({threads} threads, {capability}) {where}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts = collections.Counter(h for _, first, second, _ in results for h in (first, second))
    common = counts.most_common(1)[0][0] if counts else None
    parted = [dict(run=i, first=first, second=second, where=where) for i, first, second, where in results
              if first != common or second != common]
    print(json.dumps(dict(runs=len(results), failed=failed, results=dict(counts), parted=parted)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
