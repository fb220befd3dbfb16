"""The knee of a serving cell, found once by a sweep on the card: the
cell's driver at each offered rate in turn, on each seed (one process, a
fresh server a run), one JSON line a run with what the knee is judged by:
requests shed, ladder step-downs for overload, and the median latency in
each quarter of the schedule (a backlog that grows shows as rising
quarters), with the share of requests answered within a few latencies.
A run passes with none shed, no step-down and a last quarter under twice
the first; the knee is the highest rate up to which every rate passed on
every seed.

    python3 escoin_bench/sweep.py --workload <cell> --rates 300,400,500 \
        [--seconds 10] [--seeds 1-3]
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")

WITHIN_MS = (50, 100, 150, 200)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", default="1")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from escoin_bench import harness, metric_math

    lo, _, hi = args.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    knee = None
    for rate in sorted(float(r) for r in args.rates.split(",")):
        passed = True
        for seed in seeds:
            cell = harness.cell_file(args.workload)
            cell["traffic"]["rate"] = rate
            ctx = harness.Ctx(name=args.workload, cell=cell,
                              config=harness.config_file(cell["config"]),
                              seed=seed, seconds=args.seconds, trace=False,
                              device=torch.device("cuda", 0),
                              t_process=time.perf_counter())
            run = harness.driver(cell["driver"]).run(ctx)
            lat = np.asarray(run.spans["latency"])
            q = [float(np.median(part)) for part in np.array_split(lat, 4)]
            ok = (run.failed == 0 and run.counts["step_downs"] == 0
                  and q[-1] < 2 * q[0])
            passed = passed and ok
            print(json.dumps({
                "rate": rate, "seed": seed, "passed": ok, "e2e": run.e2e,
                "p95_ms": metric_math.p95(lat.tolist()) * 1e3,
                "within_ms": {ms: float((lat <= ms / 1e3).mean())
                              for ms in WITHIN_MS},
                "failed": run.failed, "correct": run.correct,
                "checks": run.checks, "counts": run.counts,
                "notes": run.notes}), flush=True)
        if not passed:
            break
        knee = rate
    print(json.dumps({"knee": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
