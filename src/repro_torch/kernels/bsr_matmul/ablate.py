"""Where the ``wgmma`` schedule of the BCSR matmul spends its time, on the card.

Builds variants of ``csrc/bsr_matmul.cu`` with one part of the ``wgmma``
schedule cut out (their results are wrong; only their times count), and
times each against the kernel as built, in turns (as built, variants,
variants reversed, as built), with CUDA events after a warm-up::

    PYTHONPATH=src python -m repro_torch.kernels.bsr_matmul.ablate \\
        [--proj wq gate down] [--reps 10] [--variants no_wgmma no_loads]

Yi-9B projections at 8192 rows (a B 4 x T 2048 prefill), bf16, weights
block-pruned to 0.8 with (16, 16) tiles from seed 0, f32 output.  Variants:

* ``r64_cw64_2blocks``: blocks of one warpgroup (64 rows) and 64-column
  chunks, small enough that an SM holds two; ``cw64``: 64-column chunks;
* ``no_wgmma``: no wgmma issued (staging only);
* ``no_loads``: no copy issued (the walk and its masks still run);
* ``no_x``: x not copied;
* ``no_tiles``: the kept tiles not copied.

Prints one JSON line per (variant, projection), with its largest
difference from the plain version, and the card's name and power limit.
Needs a card and ``nvcc``; builds into ``build/kernels/ablate_bsr``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_matmul import kernel as bk

PROJECTIONS = {"wq": (4096, 4096), "wk": (4096, 512), "gate": (4096, 11008),
               "down": (11008, 4096)}
ROWS = 8192


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
        return _cut(text, "              cp_async16(sbase + (g * CSUB + jj0",
                    "              if (0) cp_async16(sbase + (g * CSUB + jj0")

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


def main() -> int:
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--proj", nargs="+", choices=sorted(PROJECTIONS),
                    default=["wq", "gate", "down"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="variant names (default: all)")
    ap.add_argument("--build-only", action="store_true",
                    help="build the variants (all at once) and stop; a "
                         "later run reuses them")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    src = _build.SOURCES["bsr_matmul"].read_text()
    chosen = variants(src)
    if args.variants is not None:
        chosen = {k: chosen[k] for k in args.variants}
    libs = {"as_built": _build.load("bsr_matmul")}
    libs.update(build(chosen))
    if args.build_only:
        return 0
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    calls, operands = {}, {}
    for name in args.proj:
        d_in, d_out = PROJECTIONS[name]
        w = torch.randn((d_out, d_in), generator=gen, device=dev)
        bc = bcsr_from_dense(block_prune(w, 0.8, (16, 16)).to(bf16),
                             (16, 16))
        x = torch.randn((ROWS, d_in), generator=gen, device=dev).to(bf16)
        operands[name] = (x, bc.blocks, bc.blockcol, bc.nblocks)
        calls[name] = (lambda a=operands[name]: bk.bsr_matmul_kernel(*a))
    times, diffs = {}, {}
    want = {proj: bsr_matmul_plain(*args) for proj, args in operands.items()}
    order = list(libs) + list(reversed(list(libs)))
    for name in order:
        _build._LOADED["bsr_matmul"] = libs[name]
        for proj, fn in calls.items():
            times.setdefault((name, proj), []).append(event_ms(fn, args.reps))
            diffs[(name, proj)] = float((fn() - want[proj]).abs().max())
    _build._LOADED["bsr_matmul"] = libs["as_built"]
    for (name, proj), ms in times.items():
        print(json.dumps({"variant": name, "proj": proj, "rows": ROWS,
                          "ms": ms, "max_abs_err": diffs[(name, proj)]}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
