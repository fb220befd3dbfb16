"""Run cells of the benchmark one after another, as the check runs them,
and summarise: each run in its own process, its output kept under
``--out``, one summary line a run, and each metric's spread over the
runs of a cell (the distance between the first and third quartiles,
``statistics.quantiles(n=4)``, as a share of the median).

    python3 escoin_bench/runs.py --out <dir> \
        --run resnet50-tuned-b64:101:10:0 --run ...   # cell:seed:seconds:trace
    python3 escoin_bench/runs.py --out ... --cell resnet50-tuned-b64 \
        --seeds 101-106 --seconds 10 [--trace 1] [--repeat 2]
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--run", action="append", default=[])
    p.add_argument("--cell", action="append", default=[])
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args(argv)
    runs = [tuple(r.split(":")) for r in args.run]
    if args.seeds:
        lo, _, hi = args.seeds.partition("-")
        seeds = range(int(lo), int(hi or lo) + 1)
        for _ in range(args.repeat):
            runs += [(c, str(s), str(args.seconds), str(args.trace))
                     for c in args.cell for s in seeds]
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    values = collections.defaultdict(list)
    for i, (cell, seed, seconds, trace) in enumerate(runs):
        tag = f"{i:02d}_{cell}_{seed}_t{trace}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "escoin_bench/run.py", "--workload", cell,
             "--seed", seed, "--seconds", seconds, "--trace", trace],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        (out / f"{tag}.out").write_text(proc.stdout)
        (out / f"{tag}.err").write_text(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        if res is None:
            print(f"{tag} rc={proc.returncode} wall={wall:.1f}s NO RESULT\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            continue
        m = {k: v["value"] for k, v in res["metrics"].items()}
        for k, v in m.items():
            values[(cell, trace, k)].append(v)
        notes = [l for l in proc.stderr.splitlines()
                 if l.startswith(("escoin_bench:", "check "))]
        print(json.dumps({"run": tag, "rc": proc.returncode,
                          "wall_s": round(wall, 1),
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"], "metrics": m,
                          "device": res["device"],
                          "breakdown": res.get("breakdown"),
                          "notes": notes}), flush=True)
    for (cell, trace, k), vs in sorted(values.items()):
        if len(vs) > 1:
            s = spread(vs)
            print(f"SPREAD {cell} t{trace} {k}: median "
                  f"{statistics.median(vs)!r} spread "
                  f"{s if s is None else round(s, 5)} n {len(vs)} "
                  f"values {vs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
