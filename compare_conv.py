"""Compare two checkouts' conv kernels on one card, in turns.

Runs ``chip_smoke.py``'s kernel phase (the two conv kernels on f32
activations, and their quantised and tall-block variants: PERF.md rows 1,
1a, 1b, 2, 2a-2d) and its bf16 phase (rows 1c and 2e, and ResNet-50's 39
sparse convs through both ops, each held to its plain version) once for
each checkout root given, in the order given and then backwards (A, B, B,
A; or A, B, C, C, B, A), each in a process of its own that imports that
root's ``chip_smoke.py`` and ``src/`` (and so builds that root's
kernels)::

    python compare_conv.py PARENT_ROOT CHANGE_ROOT [THIRD_ROOT ...]

Prints one JSON line per run: its root's label and, for each kernel row,
the sums over ``chip_smoke.KERNEL_LAYERS`` of ``kernel_ms`` (CUDA events
over back-to-back launches) and ``kernel_device_ms`` (the profiler's device
time); then the card's name and power limit.  A run on one card compares
the trees under the same host and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def run_one(root: str, label: str, seed: int) -> None:
    """The two phases of the checkout at ``root``, in this process (run as
    a script, so that nothing of either tree's ``repro_torch`` is imported
    before ``root``'s)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root, os.path.join(root, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.engine.lower import lower

    mods = cs.load_modules()
    dev = torch.device("cuda")
    nets = {}
    for i, name in enumerate(("resnet50", "googlenet", "alexnet")):
        if name == "googlenet":
            continue
        net = mods["cnn"].NETWORKS[name]()
        params = mods["cnn"].init_cnn(net, 3, np.random.default_rng(seed + i),
                                      cs.IMAGE)
        nets[name] = (lower(net, (3, cs.IMAGE, cs.IMAGE)), params)
    lines = []
    cs.print = lambda *a, **k: lines.append(a[0] if a else "")
    rows = cs.kernel_phase(torch, mods, nets, dev, cs.BATCH, seed)
    bf16_rows, _ = cs.bf16_phase(torch, mods, nets, dev, cs.BATCH, seed, rows)
    rows.update(bf16_rows)
    sums = {name: {"ms": sum(r["kernel_ms"] for r in rs),
                   "device_ms": sum(r["kernel_device_ms"] for r in rs),
                   "layers": {r["layer"]: [r["kernel_ms"],
                                           r["kernel_device_ms"]]
                              for r in rs}}
            for name, rs in rows.items() if rs}
    phase = next((json.loads(x) for x in lines
                  if x.startswith('{"phase": "bf16"')), {})
    print(json.dumps({"label": label, "root": root, "sums": sums,
                      "bf16_worst": phase.get("worst")}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", help="checkout roots A, B, ...")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)  # a single run, in this process
    args = ap.parse_args()
    if args.one:
        run_one(os.path.abspath(args.one[0]), args.one[1], args.seed)
        return 0
    roots = [(os.path.abspath(r), chr(ord("A") + i))
             for i, r in enumerate(args.roots)]
    for root, label in roots + roots[::-1]:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--seed",
             str(args.seed), "--one", root, label],
            cwd=root, env={**os.environ, "PYTHONPATH": ""})
        if done.returncode != 0:
            return done.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
