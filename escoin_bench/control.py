"""The readings that a cell's limits are set from, on the card.

For each seed: the program's number (the cell's driver over a short
window, at the cell's own sizes and load, compared as a run compares);
for the first ``CONTROL_SEEDS`` seeds also the control's: the same run
with the reference itself in the program's place
(``judge.tf32_control``, through ``Ctx.engine_hook``), in the nearest
precision below the configuration's f32 with TF32 off, which has to come
out not correct.  One process, one JSON line a seed, then the largest
program reading, the smallest control reading and whether every control
run came out not correct.

    python3 escoin_bench/control.py --workload <cell> --seeds 1-12 \
        [--seconds 2]
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

CONTROL_SEEDS = 4


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from escoin_bench import harness, judge

    cell = harness.cell_file(args.workload)
    config = harness.config_file(cell["config"])
    lo, _, hi = args.seeds.partition("-")
    seeds = list(range(int(lo), int(hi or lo) + 1))
    device = torch.device("cuda", 0)

    def one(seed, hook=None):
        ctx = harness.Ctx(name=args.workload, cell=cell, config=config,
                          seed=seed, seconds=args.seconds, trace=False,
                          device=device, t_process=time.perf_counter(),
                          engine_hook=hook)
        return harness.driver(cell["driver"]).run(ctx)

    program, control, control_correct = [], [], []
    for i, seed in enumerate(seeds):
        run = one(seed)
        row = {"seed": seed, "program": run.checks["logit_err"][0],
               "correct": run.correct, "notes": run.notes}
        program.append(row["program"])
        if i < CONTROL_SEEDS:
            run = one(seed, judge.tf32_control(cell, config, seed, device))
            row["control"] = run.checks["logit_err"][0]
            row["control_correct"] = run.correct
            control.append(row["control"])
            control_correct.append(run.correct)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "program_max": max(program),
                      "control_min": min(control) if control else None,
                      "control_ever_correct": any(control_correct),
                      "limit": cell["limits"]["logit_err"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
