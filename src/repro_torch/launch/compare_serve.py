"""Compare two checkouts' Yi-9B serving on one card, in turns.

Runs ``chip_smoke.py``'s serve phase (``ServeEngine``, 4 slots, 8 requests,
Yi-9B at full width, bf16, sparsity 0.8) once for each checkout root given,
in the order A, B, B, A, each in a process of its own that imports that
root's ``chip_smoke.py`` and ``src/``, and before it the host time of one
4-row ``bsr_matmul`` call on wq's shape (2000 calls, no synchronisation in
between: the launcher's time, not the card's)::

    python -m repro_torch.launch.compare_serve PARENT_ROOT CHANGE_ROOT

A run on one card compares the two trees under the same host and power
limit; the host clock of a tick varies between runs, so read the pairs
against each other.  Prints one JSON line per run (its root's label, ms per
tick, the profiled step's device time) and the card's name and power limit.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_one(root: str, label: str) -> None:
    """The serve phase of the checkout at ``root``, in this process (run as
    a script, so that nothing of either tree's ``repro_torch`` is imported
    before ``root``'s)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root, os.path.join(root, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    import chip_smoke as cs

    mods = cs.load_modules()
    dev = torch.device("cuda")
    bk = mods["kernels"]["bsr_matmul"]
    gen = torch.Generator(device=dev).manual_seed(0)
    w = mods["block_prune"](torch.randn((4096, 4096), generator=gen,
                                        device=dev), 0.8, (16, 16))
    bc = mods["bcsr_matrix"](w.to(torch.bfloat16), (16, 16))
    x = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    args = (x, bc.blocks, bc.blockcol, bc.nblocks)
    for _ in range(50):
        bk(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        bk(*args, out_dtype=torch.bfloat16)
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    del w, bc, x, args
    lines = []
    cs.print = lambda *a, **k: lines.append(a[0] if a else "")
    cs.llm_serve_phase(torch, mods, dev, 0)
    row = json.loads(lines[-1])
    print(json.dumps({"label": label, "root": root,
                      "bsr_matmul_host_us": host_us,
                      **{k: v for k, v in row.items()
                         if k not in ("top_kernels", "launches")}}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs=2, help="checkout roots A and B")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)  # a single run, in this process
    args = ap.parse_args()
    if args.one:
        run_one(os.path.abspath(args.one[0]), args.one[1])
        return 0
    a, b = (os.path.abspath(r) for r in args.roots)
    for root, label in ((a, "A"), (b, "B"), (b, "B"), (a, "A")):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), a, b, "--one", root,
             label], check=False)
        if done.returncode:
            return done.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
