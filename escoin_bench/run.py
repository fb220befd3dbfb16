"""The benchmark's one command: run one cell of ``BENCHMARK.json``.

    python3 escoin_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the checkout's root, on a machine with the card(s) the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (a profiled slice after the window).  The last line
of standard output is the result object; the numbers compared with the
reference, each beside its limit, end standard error and the result.
The kernels build into ``build/kernels/`` inside the checkout.
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
# The package is imported from the checkout's root, never from this
# directory (its module names could shadow the standard library's).
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from escoin_bench import harness

    bench = harness.benchmark(ROOT)
    entry = harness.cell_entry(bench, args.workload)
    if not torch.cuda.is_available():
        print("escoin_bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"escoin_bench: {args.workload} needs {entry['chips']} "
              f"card(s), {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    cell = harness.cell_file(args.workload)
    ctx = harness.Ctx(name=args.workload, cell=cell,
                      config=harness.config_file(cell["config"]),
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t_process=T_PROCESS)
    run = harness.driver(cell["driver"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"escoin_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"]}
    line = harness.result_line(bench, args.workload, run, ctx.trace, device)
    for note in run.notes:
        print(f"escoin_bench: {note}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
