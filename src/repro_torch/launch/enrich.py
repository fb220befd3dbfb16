"""Probe-enrichment pass: re-run the single-pod cells whose JSON lacks the
probe counts (``probe_info`` null), in priority order (train, prefill,
decode; small archs first so the table fills fastest).

Port of ``repro/launch/enrich.py``.

  PYTHONPATH=src python -m repro_torch.launch.enrich [--max-cells N]
"""
from __future__ import annotations

import argparse
import json
import traceback

from repro_torch import configs as cfgs
from repro_torch.launch import dryrun

KIND_PRIORITY = {"train": 0, "prefill": 1, "decode": 2}


def pending():
    cells = []
    for arch, shape in cfgs.all_cells():
        path = dryrun.RESULTS_DIR / f"{arch}__{shape.name}__16x16.json"
        if path.exists() and json.loads(path.read_text()).get("probe_info"):
            continue
        cells.append((arch, shape))
    cells.sort(key=lambda c: (KIND_PRIORITY[c[1].kind],
                              cfgs.get_config(c[0]).num_params()))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-cells", type=int, default=1000)
    args = ap.parse_args(argv)
    todo = pending()
    print(f"{len(todo)} cells pending probe enrichment")
    for arch, shape in todo[: args.max_cells]:
        remat = "full" if cfgs.get_config(arch).num_params() > 5e10 else "dots"
        try:
            dryrun.lower_cell(arch, shape.name, multi_pod=False, remat=remat,
                              probes=True)
        except Exception:
            traceback.print_exc()


if __name__ == "__main__":
    main()
