"""Where the BCSR matmul's two schedules spend their time, on the card.

Builds variants of ``csrc/bsr_matmul.cu`` with one part of a schedule cut
out (their results are wrong; only their times count), and times each
against the kernel as built, in turns (as built, variants, variants
reversed, as built)::

    PYTHONPATH=src python -m repro_torch.kernels.bsr_matmul.ablate \\
        [--schedule wgmma|rows] [--proj wq gate down] [--reps 10] \\
        [--variants no_wgmma no_loads]
    PYTHONPATH=src python -m repro_torch.kernels.bsr_matmul.ablate \\
        --crossover

Yi-9B projections, bf16, weights block-pruned to 0.8 with (16, 16) tiles
(``--block BM BN``: other tiles, e.g. the reference's default 128 128)
from seed 0, bf16 output.  ``--schedule wgmma`` (the default): 8192 rows
(a B 4 x T 2048 prefill), CUDA events after a warm-up.  Its variants:

* ``r64_cw64_2blocks``: blocks of one warpgroup (64 rows) and 64-column
  chunks, small enough that an SM holds two; ``cw64``: 64-column chunks;
* ``no_wgmma``: no wgmma issued (staging only);
* ``no_loads``: no copy issued (the walk and its masks still run);
* ``no_x``: x not copied;
* ``no_tiles``: the kept tiles not copied.

``--schedule rows``: ``--rows`` (default 4, a decode step) rows on all
four projections, each time the profiler's device time of the kernel,
L2 warm (the same bank every call) and cold (a 128 MB buffer written and
another read between calls), each with CUDA events just around the call,
which the stream reaches once the flush (or a spin) before it has ended.
Its variants:

* ``rows_no_copies``: no bulk copy (the stages' barriers complete on the
  producer's arrival alone; the warps multiply what the ring holds);
* ``rows_no_x``: no x fragment loaded (zeros; staged x still copied);
* ``rows_empty``: every block reads its first unit and returns (the
  floor);
* ``rows_x_l1``: x read through L1 at every row count (never staged);
  ``rows_x_max48k``: staged only where its rows take 48 KB or less;
* ``rows_no_mma``: no product (the loads the compiler keeps);
* ``rows_no_split``: no sums across a block-row's cluster (every unit
  writes y);
* ``rows_one_stage`` / ``rows_eight_stages``: a ring of 1 / 8 stages;
* ``cfg_*``: the kernel as built with other sizes of its stages or units
  (``ROWS_CONFIGS``: the ``budget`` constants each overrides).

``--crossover`` times both schedules (the same warm timing) on the four
projections at 8, 16, 32, 48, 64, 96, 128, 256, 512, 1024 and 2048 bf16
rows: the row count up to which ``rows`` is faster sets
``budget.BSR_MATMUL_ROWS_MAX``.

``--against SOURCE`` builds another tree's ``bsr_matmul.cu`` (with the same
C interface) and holds the kernel as built to it bit for bit on the four
projections' (16, 16) banks: both schedules in bf16 (4 and 8192 rows, f32
and bf16 outputs) and the rows schedule in f32 (4 rows)::

    PYTHONPATH=src python -m repro_torch.kernels.bsr_matmul.ablate \
        --against build/parent/src/repro_torch/kernels/bsr_matmul/csrc/bsr_matmul.cu

Prints one JSON line per (variant or schedule, projection, rows), with its
largest difference from the plain version, and the card's name and power
limit.  Needs a card and ``nvcc``; builds into ``build/kernels/ablate_bsr``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build, budget
from repro_torch.kernels.bsr_matmul import kernel as bk

PROJECTIONS = {"wq": (4096, 4096), "wk": (4096, 512), "gate": (4096, 11008),
               "down": (11008, 4096)}
ROWS = 8192
CROSSOVER_ROWS = (8, 16, 32, 48, 64, 96, 128, 256, 512, 1024, 2048)
# rows: the kernel as built under other budget constants (the work list is
# cached per bank and sizing, so each config builds its own)
ROWS_CONFIGS = {
    "cfg_units2": {"BSR_MATMUL_ROWS_UNITS_PER_SM": 2},
    "cfg_units4": {"BSR_MATMUL_ROWS_UNITS_PER_SM": 4},
    "cfg_cluster1": {"BSR_MATMUL_ROWS_CLUSTER_MAX": 1},
    "cfg_cluster2": {"BSR_MATMUL_ROWS_CLUSTER_MAX": 2},
    "cfg_cluster4": {"BSR_MATMUL_ROWS_CLUSTER_MAX": 4},
    "cfg_min1k": {"BSR_MATMUL_ROWS_UNIT_MIN_BYTES": 1024},
    "cfg_min8k": {"BSR_MATMUL_ROWS_UNIT_MIN_BYTES": 8192},
    "cfg_per_sm1": {"BSR_MATMUL_ROWS_BLOCKS_PER_SM": 1},
    "cfg_per_sm2": {"BSR_MATMUL_ROWS_BLOCKS_PER_SM": 2},
    "cfg_per_sm_fit": {"BSR_MATMUL_ROWS_BLOCKS_PER_SM": 0},
}


def _cut(src: str, old: str, new: str = "") -> str:
    if old not in src:
        raise ValueError(f"ablate: the source no longer holds {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """Variant name -> source text."""
    def no_x(text):
        return _cut(text, "        cp_async16(sbase + (r / 64) * XTILE",
                    "        if (0) cp_async16(sbase + (r / 64) * XTILE")

    def no_tiles(text):
        return _cut(text, "              cp_async16(sbase + (g * CSUB + tc",
                    "              if (0) cp_async16(sbase + (g * CSUB + tc")

    def consts(text, **values):
        for name, value in values.items():
            text = _cut(text, f"constexpr int {name} = ",
                        f"constexpr int {name} = {value}; //")
        return text

    return {
        # a warpgroup of 64 rows a block, 64-column chunks, two blocks an SM
        "r64_cw64_2blocks": consts(src, GW=1, CW=64, MIN_BLOCKS=2),
        "cw64": consts(src, CW=64),
        "no_wgmma": _cut(src, "          wgmma_n16(acc[g][h],",
                         "          if (0) wgmma_n16(acc[g][h],"),
        "no_loads": no_x(no_tiles(src)),
        "no_x": no_x(src),
        "no_tiles": no_tiles(src),
    }


def rows_variants(src: str) -> dict:
    """``rows`` variant name -> source text."""
    def consts(text, **values):
        for name, value in values.items():
            text = _cut(text, f"constexpr int {name} = ",
                        f"constexpr int {name} = {value}; //")
        return text

    # every block of a cluster writes y (no sums across the cluster)
    no_split = _cut(
        _cut(src, "        if (cluster > 1)\n          part[o] = v;\n"
                  "        else if (row < B)", "        if (row < B)"),
        "  if (cluster == 1) return;", "  return;")
    return {
        "rows_no_copies": _cut(
            src, "          load_pieces(bars + 8 * slot,",
            "          mbar_arrive(bars + 8 * slot);\n"
            "          if (0) load_pieces(bars + 8 * slot,"),
        "rows_no_x": _cut(src, "      const bool in = live && r0 + row < B;",
                          "      const bool in = false;"),
        # the floor: every block reads its unit and returns
        "rows_empty": _cut(src, "  const int r0 = blockIdx.y * R;\n",
                           "  const int r0 = blockIdx.y * R;\n"
                           "  if (units[blockIdx.x].x >= 0) return;\n"),
        "rows_no_mma": _cut(src, "      mma16816(acc[g], lo.x,",
                            "      if (0) mma16816(acc[g], lo.x,"),
        "rows_no_split": no_split,
        "rows_x_l1": _cut(src, "  const bool xs = rows_x_bytes<T>(min(R, B), "
                               "N) <= RX_MAX;", "  const bool xs = false;"),
        "rows_x_max48k": consts(src, RX_MAX="48 * 1024"),
        "rows_one_stage": consts(src, RSTAGES=1),
        "rows_eight_stages": consts(src, RSTAGES=8),
    }


def build(sources: dict) -> dict:
    """Compile each variant (all at once) -> name -> loaded library."""
    out = _build.build_dir() / "ablate_bsr"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.nvcc_path(), {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        if (out / f"{name}.so").exists() and cu.exists() \
                and cu.read_text() == text:
            continue  # built by an earlier run
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate: {name} failed to build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7520" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in sources}


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class L2Flush:
    """Evicts the weights from the 50 MB L2 between calls: writes a 128 MB
    buffer, then reads another (so no dirty line of the flush is written
    back during the timed call)."""

    def __init__(self, device):
        self.w = torch.empty(32 * 2**20, device=device)
        self.r = torch.ones(32 * 2**20, device=device)

    def __call__(self):
        self.w.fill_(1.0)
        self.r.sum()


def device_ms(fn, reps: int, flush=None) -> float:
    """Device ms a call of ``fn``: CUDA events recorded just before and
    after each call, which the stream reaches only when the kernel before
    them ends (``flush()``, else a spin of ~0.1 ms), so the host's launch
    time falls outside them; the L2 stays warm across a spin."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        if flush is not None:
            flush()
        else:
            torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _bank(name: str, rows: int, gen, dev, block=(16, 16)):
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense

    bf16 = torch.bfloat16
    d_in, d_out = PROJECTIONS[name]
    w = torch.randn((d_out, d_in), generator=gen, device=dev)
    bc = bcsr_from_dense(block_prune(w, 0.8, block).to(bf16), block)
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(bf16)
    return x, bc.blocks, bc.blockcol, bc.nblocks


def crossover(projs, reps: int) -> None:
    """Both schedules at CROSSOVER_ROWS bf16 rows on ``projs``."""
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    banks = {p: _bank(p, max(CROSSOVER_ROWS), gen, dev) for p in projs}
    sums = {}
    for rows in CROSSOVER_ROWS:
        for proj, (x, *bank) in banks.items():
            args = (x[:rows].contiguous(), *bank)
            want = bsr_matmul_plain(*args)
            for sched in ("rows", "wgmma"):
                def call(s=sched, out=bf16):
                    return bk._launch(*args, out, sched=s)
                err = float((call(out=torch.float32) - want).abs().max())
                ms = device_ms(call, reps)
                sums[(rows, sched)] = sums.get((rows, sched), 0.0) + ms
                print(json.dumps({"crossover": sched, "proj": proj,
                                  "rows": rows, "device_ms": ms,
                                  "max_abs_err": err}), flush=True)
    faster = [r for r in CROSSOVER_ROWS
              if sums[(r, "rows")] <= sums[(r, "wgmma")]]
    print(json.dumps({"crossover_sums": {
        f"{r}": {"rows": sums[(r, "rows")], "wgmma": sums[(r, "wgmma")]}
        for r in CROSSOVER_ROWS},
        "rows_faster_at": faster}), flush=True)


def against(source: str, projs) -> None:
    """The kernel as built and ``source``'s on the same (16, 16) banks and
    inputs, in each schedule, dtype and output dtype: one JSON line each
    with ``bit_identical``; raises if any differs."""
    libs = {"as_built": _build.load("bsr_matmul"), **build(
        {"against": source})}
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    differ = []
    for proj in projs:
        x, *bank = _bank(proj, ROWS, gen, dev)
        for dtype, rows, sched in ((bf16, 4, "rows"), (bf16, ROWS, "wgmma"),
                                   (torch.float32, 4, "rows")):
            args = (x[:rows].to(dtype).contiguous(), bank[0].to(dtype),
                    *bank[1:])
            for out in (torch.float32, bf16):
                got = {}
                for name, lib in libs.items():
                    _build._LOADED["bsr_matmul"] = lib
                    got[name] = bk._launch(*args, out, sched=sched)
                torch.cuda.synchronize()
                same = torch.equal(got["as_built"], got["against"])
                print(json.dumps({"against": proj, "rows": rows,
                                  "schedule": sched, "dtype": str(dtype),
                                  "out_dtype": str(out),
                                  "bit_identical": same}), flush=True)
                if not same:
                    differ.append((proj, rows, sched, str(dtype), str(out)))
    _build._LOADED["bsr_matmul"] = libs["as_built"]
    if differ:
        raise SystemExit(f"ablate: outputs differ from the other source: "
                         f"{differ}")


def main() -> int:
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", choices=("wgmma", "rows"),
                    default="wgmma")
    ap.add_argument("--proj", nargs="+", choices=sorted(PROJECTIONS),
                    default=None,
                    help="default: wq gate down (wgmma), all four (rows)")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows of x (default: 8192 wgmma, 4 rows)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="variant names (default: all of the schedule's)")
    ap.add_argument("--build-only", action="store_true",
                    help="build the variants (all at once) and stop; a "
                         "later run reuses them")
    ap.add_argument("--crossover", action="store_true",
                    help="time both schedules from 8 to 128 rows instead")
    ap.add_argument("--block", nargs=2, type=int, default=(16, 16),
                    metavar=("BM", "BN"), help="the banks' tiles")
    ap.add_argument("--against", default=None,
                    help="another tree's bsr_matmul.cu: hold the kernel as "
                         "built to it bit for bit instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    if args.against:
        from pathlib import Path
        against(Path(args.against).read_text(), args.proj or
                sorted(PROJECTIONS))
        _print_card()
        return 0
    rows_mode = args.schedule == "rows"
    projs = args.proj or (sorted(PROJECTIONS) if rows_mode or args.crossover
                          else ["wq", "gate", "down"])
    if args.crossover:
        _build.load("bsr_matmul")
        crossover(projs, args.reps)
        _print_card()
        return 0
    src = _build.SOURCES["bsr_matmul"].read_text()
    chosen = rows_variants(src) if rows_mode else variants(src)
    configs = ROWS_CONFIGS if rows_mode else {}
    if args.variants is not None:
        configs = {k: configs[k] for k in args.variants if k in configs}
        chosen = {k: chosen[k] for k in args.variants if k not in configs}
    libs = {"as_built": _build.load("bsr_matmul")}
    libs.update(build(chosen))
    libs.update({name: libs["as_built"] for name in configs})
    if args.build_only:
        return 0
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    nrows = args.rows or (4 if rows_mode else ROWS)
    gen = torch.Generator(device=dev).manual_seed(0)
    calls, operands = {}, {}
    for name in projs:
        operands[name] = _bank(name, nrows, gen, dev, tuple(args.block))
        calls[name] = (lambda a=operands[name]: bk.bsr_matmul_kernel(
            *a, out_dtype=bf16))
    flush = L2Flush(dev) if rows_mode else None
    times, diffs = {}, {}
    want = {proj: bsr_matmul_plain(*a) for proj, a in operands.items()}
    order = list(libs) + list(reversed(list(libs)))
    defaults = {k: getattr(budget, k) for c in configs.values() for k in c}
    for name in order:
        _build._LOADED["bsr_matmul"] = libs[name]
        for key, value in {**defaults, **configs.get(name, {})}.items():
            setattr(budget, key, value)
        for proj, fn in calls.items():
            if rows_mode:
                ms = {"warm_ms": device_ms(fn, args.reps * 5),
                      "cold_ms": device_ms(fn, args.reps, flush)}
            else:
                ms = {"ms": event_ms(fn, args.reps)}
            for key, value in ms.items():
                times.setdefault((name, proj, key), []).append(value)
            diffs[(name, proj)] = float(
                (fn().float() - want[proj]).abs().max())
    _build._LOADED["bsr_matmul"] = libs["as_built"]
    for key, value in defaults.items():
        setattr(budget, key, value)
    keys = ("warm_ms", "cold_ms") if rows_mode else ("ms",)
    for (name, proj), err in diffs.items():
        print(json.dumps({"variant": name, "proj": proj, "rows": nrows,
                          "block": list(args.block),
                          **{k: times[(name, proj, k)] for k in keys},
                          "max_abs_err": err}), flush=True)
    # each variant's best time summed over the projections
    print(json.dumps({"sums": {name: {k: sum(min(times[(name, p, k)])
                                            for p in projs) for k in keys}
                               for name in libs}}), flush=True)
    _print_card()
    return 0


def _print_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    raise SystemExit(main())
