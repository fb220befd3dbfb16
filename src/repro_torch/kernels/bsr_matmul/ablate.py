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
four projections, L2 warm (the same bank every call) and cold (a 128 MB
buffer written and another read between calls), each timed two ways:
``warm_device_ms`` / ``cold_device_ms``, the profiler's device time of
the kernel alone (``profiled_ms``); ``warm_ms`` / ``cold_ms``, CUDA events
just around the call, which the stream reaches once the flush (or a spin)
before it has ended (they add the events' own time to a kernel of a few
microseconds).  Its variants:

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

``--stress`` launches the ``rows`` schedule many times at every shape a
path of ``chip_smoke.py`` gives it (``stress_shapes()``: Jamba-1.5-Large's
five projections at its prefill's 1,024 rows, Yi-9B's four at 4 rows in
(16, 16) and (128, 128) tiles, Phi-3-Vision's wq at 2,048 rows, Mamba2's
in_proj at 4 rows; each at the cluster and pass ``budget`` gives it), each
launch under a deadline polled with ``torch.cuda.Event.query()`` (never a
blocking synchronise), each output held bit for bit to the shape's first
launch and the first to the plain version; then loops Jamba's sparse
prefill (2 layers, sparsity 0.8, (16, 16) tiles, B 1 x T 1024, as
``chip_smoke.py``'s families phase builds it) under the same deadline::

    PYTHONPATH=src python -m repro_torch.kernels.bsr_matmul.ablate \\
        --stress [--launches 20000 4000] [--prefills 2000] \\
        [--variants as_built early_release ...]

Each source runs in a process of its own (``STRESS_ORDER``: the kernel
as built; ``early_release``, the last-stage release of an older source,
which arrived on a stage's "empty" barrier without waiting for the stage;
``*_skew``, warp 0 of every block paused before it waits for the stage
``RSTAGES`` before its unit's last, which forces the interleaving that
release loses; ``*_skew_late``, paused after that wait, before it reads
the stage).  A launch past its deadline (``STRESS_DEADLINE_S``) prints a
``stall`` line (source, shape, launch index) and every thread's stack, and
ends that process; the run goes on with the next source.  Each source has
a verdict (``stress_expect``): an ``as_built*`` source must run clean, an
``early_release_skew*`` control must stall or differ (the check must catch
what it is there to catch), the unskewed ``early_release`` may do either
(it hangs only when the warps happen to drift apart).  Exits 1 if any
source went against its verdict.

Prints one JSON line per (variant or schedule, projection, rows), with its
largest difference from the plain version, and the card's name and power
limit.  Needs a card and ``nvcc``; builds into ``build/kernels/ablate_bsr``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import faulthandler
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build, budget
from repro_torch.kernels.bsr_matmul import kernel as bk

PROJECTIONS = {"wq": (4096, 4096), "wk": (4096, 512), "gate": (4096, 11008),
               "down": (11008, 4096)}
ROWS = 8192
PROFILE_TRIES = 3
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


def profiled_ms(fn, reps: int, flush=None, kernel: str = "bsr_matmul_rows"):
    """Device ms a call of ``fn`` by ``torch.profiler``: the device time of
    the kernels whose names hold ``kernel`` summed over ``reps`` calls (each
    after ``flush()`` where one is given, which the sum leaves out), after
    one warm-up call; host launch time and event overheads fall outside it.
    None where the profiler recorded fewer such kernels than calls in
    PROFILE_TRIES tries (it drops kernels at times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        if sum(e.count for e in hits) >= reps:
            return sum(e.self_device_time_total for e in hits) / 1e3 / reps
    return None


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


# --stress: launches queued ahead of the oldest one polled; a launch's
# deadline runs from when the host starts polling it
STRESS_AHEAD = 32
STRESS_DEADLINE_S = 20   # a launch or a prefill, once polled
STRESS_CHILD_S = 1800    # a source's process, start to end
STRESS_TOL = 1e-4        # x max(1, max |y|): chip_smoke.py's BSR_MATMUL_TOL
JAMBA_LAYERS, JAMBA_SHAPE, JAMBA_SEED = 2, (1, 1024), 57
# the sources in the order they run (the one expected to hang last); a
# skewed source takes a tenth of the launches
STRESS_ORDER = ("as_built", "early_release", "as_built_skew",
                "as_built_skew_late", "early_release_skew_late",
                "early_release_skew")


def stress_shapes() -> list:
    """(name, rows, d_in, d_out, block) of each ``rows`` launch shape on
    ``chip_smoke.py``'s paths (a weight is (d_out, d_in))."""
    from repro_torch import configs

    jamba = configs.get_config("jamba-1.5-large-398b")
    mamba = configs.get_config("mamba2-2.7b")
    phi = configs.get_config("phi-3-vision-4.2b")

    def in_proj(cfg):   # z, x, B, C and dt
        return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads

    rows = JAMBA_SHAPE[0] * JAMBA_SHAPE[1]
    shapes = [("jamba.in_proj", rows, jamba.d_model, in_proj(jamba)),
              ("jamba.out_proj", rows, jamba.d_inner, jamba.d_model),
              ("jamba.gate", rows, jamba.d_model, jamba.d_ff),
              ("jamba.up", rows, jamba.d_model, jamba.d_ff),
              ("jamba.down", rows, jamba.d_ff, jamba.d_model)]
    shapes = [s + ((16, 16),) for s in shapes]
    for block in ((16, 16), (128, 128)):
        shapes += [(f"yi-9b.{p}", 4, d_in, d_out, block)
                   for p, (d_in, d_out) in sorted(PROJECTIONS.items())]
    return shapes + [
        ("phi-3-vision.wq", 2048, phi.d_model, phi.n_heads * phi.head_dim,
         (16, 16)),
        ("mamba2.in_proj", 4, mamba.d_model, in_proj(mamba), (16, 16))]


def stress_source(src: str, name: str) -> str:
    """The text of ``--stress`` source ``name`` (one of STRESS_ORDER): the
    kernel as built, ``early_release`` (the last-stage release that arrived
    without waiting for its stage), and each of the two with warp 0 paused
    (~200 us) at the stage RSTAGES before its unit's last: before it waits
    for that stage (``_skew``) or after (``_skew_late``).  Only the patches
    ``name`` needs are applied."""
    if name not in STRESS_ORDER:
        raise ValueError(f"ablate: no stress source {name!r}")
    base, skewed, late = name.partition("_skew")
    text = src
    if base == "early_release":
        text = _cut(text, (
            "        const int gs = gbase + (total - 1) / stage_pieces;\n"
            "        mbar_wait_warp(bars + 8 * (gs % RSTAGES), (gs / RSTAGES) "
            "& 1);\n"
            "        if (lane == 0) mbar_arrive(bars + 8 * (RSTAGES + gs % "
            "RSTAGES));\n"), (
            "        const int gs = gbase + (total - 1) / stage_pieces;\n"
            "        __syncwarp();\n"
            "        if (lane == 0) mbar_arrive(bars + 8 * (RSTAGES + gs % "
            "RSTAGES));\n"))
    if skewed:
        wait = ("            if (KS != 1 || k % PJ1 == 0)\n"
                "              mbar_wait_warp(bars + 8 * slot, (gs / RSTAGES) "
                "& 1);\n")
        pause = ("            if (warp == 0 && s + RSTAGES == (total - 1) / "
                 "stage_pieces)\n"
                 "              for (int i = 0; i < 200; ++i) "
                 "__nanosleep(1000);\n")
        text = _cut(text, wait, wait + pause if late else pause + wait)
    return text


def stress_expect(name: str) -> str:
    """A source's verdict under ``--stress``: ``clean`` (the kernel as
    built, skewed or not), ``caught`` (a skewed control: the interleaving
    its release loses is forced, so it must stall or differ) or ``either``
    (the unskewed control, which loses it only by chance)."""
    if name.startswith("as_built"):
        return "clean"
    return "caught" if "_skew" in name else "either"


def _poll(event, deadline_s: float) -> bool:
    """Whether the stream reaches ``event`` within ``deadline_s``, asked
    with ``query()`` (a blocking synchronise would wait with a hung
    kernel for ever)."""
    t0 = time.monotonic()
    while not event.query():
        if time.monotonic() - t0 > deadline_s:
            return False
        time.sleep(2e-4)
    return True


def _stalled(**where) -> None:
    """Report a launch past its deadline, dump every thread's stack and end
    the process at once (no CUDA call: it would wait on the hung kernel)."""
    print(json.dumps({"stall": where}), flush=True)
    faulthandler.dump_traceback(all_threads=True)
    os._exit(3)


def _stress_shape(variant, shape, launches, gen, dev) -> bool:
    """``launches`` launches of one shape's bank, each held bit for bit to
    the first, the first to the plain version; one JSON line."""
    from repro_torch.core.pruning import block_prune
    from repro_torch.core.sparse_format import bcsr_from_dense
    from repro_torch.kernels.bsr_matmul.ref import bsr_matmul_plain

    name, rows, d_in, d_out, block = shape
    bf16 = torch.bfloat16
    w = torch.randn((d_out, d_in), generator=gen, device=dev)
    bank = bcsr_from_dense(block_prune(w, 0.8, block).to(bf16), block)
    del w
    x = torch.randn((rows, d_in), generator=gen, device=dev).to(bf16)
    args = (x, bank.blocks, bank.blockcol, bank.nblocks)
    cluster = bk.rows_work(bank.blockcol, bank.nblocks, *block, 2)[2]

    def launch():
        return bk.bsr_matmul_kernel(*args, out_dtype=torch.float32)

    where = dict(source=variant, shape=name, rows=rows, block=list(block))
    first = launch()
    ev = torch.cuda.Event()
    ev.record()
    if not _poll(ev, STRESS_DEADLINE_S):
        _stalled(launch=0, **where)
    want = bsr_matmul_plain(*args)
    err = float((first - want).abs().max())
    tol = STRESS_TOL * max(1.0, float(want.abs().max()))
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    pending = collections.deque()
    t0 = time.perf_counter()
    for i in range(1, launches):
        differ += (launch() != first).sum()
        ev = torch.cuda.Event()
        ev.record()
        pending.append((i, ev))
        while len(pending) > STRESS_AHEAD or (pending and i == launches - 1):
            j, e = pending.popleft()
            if not _poll(e, STRESS_DEADLINE_S):
                _stalled(launch=j, **where)
    n_differ = int(differ)   # every launch has ended
    ok = err <= tol and n_differ == 0
    print(json.dumps({"stress": variant, "shape": name, "rows": rows,
                      "block": list(block), "out": d_out, "in": d_in,
                      "cluster": cluster,
                      "rows_pass": budget.bsr_matmul_rows_pass(rows, 2),
                      "kept_tiles": int(bank.nblocks.sum()),
                      "launches": launches, "stalls": 0,
                      "max_abs_err_first": err, "tolerance": tol,
                      "elements_differing_from_first": n_differ,
                      "seconds": time.perf_counter() - t0, "ok": ok}),
          flush=True)
    return ok


def _stress_prefills(variant, n, dev) -> bool:
    """``n`` sparse prefills of Jamba-1.5-Large cut to 2 layers (Mamba2 +
    MoE, Mamba2 + MLP; 7 ``rows`` launches each), each under the deadline;
    every logit row finite."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import sparsify_params
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get_config("jamba-1.5-large-398b"),
                              n_layers=JAMBA_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(JAMBA_SEED)
    params = sparsify_params(T.init_params(cfg, gen, dev), cfg, 0.8,
                             (16, 16))
    tokens = np.random.default_rng(JAMBA_SEED).integers(
        0, cfg.vocab, JAMBA_SHAPE)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    step = make_prefill_step(cfg)
    before = bk.bsr_matmul_kernel.launches
    finite = torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for i in range(n):
        logits, _ = step(params, batch)
        finite &= torch.isfinite(logits).all()
        ev = torch.cuda.Event()
        ev.record()
        if not _poll(ev, STRESS_DEADLINE_S):
            _stalled(source=variant, shape="jamba prefill", prefill=i,
                     rows_launches=bk.bsr_matmul_kernel.launches - before)
    ok = bool(finite)
    print(json.dumps({"stress": variant, "shape": "jamba prefill",
                      "layers": cfg.n_layers, "batch": JAMBA_SHAPE[0],
                      "seq": JAMBA_SHAPE[1], "prefills": n,
                      "rows_launches": bk.bsr_matmul_kernel.launches - before,
                      "stalls": 0, "finite": ok,
                      "seconds": time.perf_counter() - t0, "ok": ok}),
          flush=True)
    return ok


def stress_child(variant, launches, prefills) -> int:
    """One source's stress, in this process (``--stress-child``)."""
    lib = build({variant: stress_source(
        _build.SOURCES["bsr_matmul"].read_text(), variant)})[variant]
    fn = getattr(lib, bk._SYMBOL)
    fn.argtypes, fn.restype = bk.ARGTYPES, ctypes.c_int
    _build._LOADED["bsr_matmul"] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    few, many = launches
    ok = all([_stress_shape(variant, shape, many if shape[1] > 64 else few,
                            gen, dev)
              for shape in stress_shapes()])
    if prefills:
        ok = _stress_prefills(variant, prefills, dev) and ok
    return 0 if ok else 1


def stress(variants, launches, prefills) -> int:
    """Each source's stress in a child process, one after another (a hung
    kernel ends its process, not the run), each held to its verdict
    (``stress_expect``); 1 if any source went against it."""
    src = _build.SOURCES["bsr_matmul"].read_text()
    build({v: stress_source(src, v) for v in variants})
    unexpected = []
    for variant in variants:
        skew = "skew" in variant
        cmd = [sys.executable, "-m", "repro_torch.kernels.bsr_matmul.ablate",
               "--stress-child", variant, "--launches",
               *(str(max(1, n // 10) if skew else n) for n in launches),
               "--prefills", "0" if skew else str(prefills)]
        t0 = time.perf_counter()
        try:
            rc = subprocess.run(cmd, timeout=STRESS_CHILD_S).returncode
        except subprocess.TimeoutExpired:   # killed: a process that never
            rc = "killed"                   # ended after a stall
        expect = stress_expect(variant)
        kept = (expect == "either" or (expect == "clean") == (rc == 0))
        print(json.dumps({"stress_source": variant, "exit": rc,
                          "expect": expect, "as_expected": kept,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if not kept:
            unexpected.append(variant)
    print(json.dumps({"stress_unexpected": unexpected}), flush=True)
    return 1 if unexpected else 0


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
    ap.add_argument("--stress", action="store_true",
                    help="launch the rows schedule under deadlines at the "
                         "smoke's shapes, then loop Jamba's prefill")
    ap.add_argument("--stress-child", default=None, metavar="SOURCE",
                    help=argparse.SUPPRESS)
    ap.add_argument("--launches", nargs=2, type=int, default=(20000, 4000),
                    metavar=("FEW", "MANY"),
                    help="--stress: launches a shape of at most 64 rows, "
                         "and of more")
    ap.add_argument("--prefills", type=int, default=2000,
                    help="--stress: Jamba prefills a source (not skewed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    if args.stress_child:
        return stress_child(args.stress_child, args.launches, args.prefills)
    if args.stress:
        rc = stress(args.variants or STRESS_ORDER, args.launches,
                    args.prefills)
        _print_card()
        return rc
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
                      "cold_ms": device_ms(fn, args.reps, flush),
                      "warm_device_ms": profiled_ms(fn, args.reps * 5),
                      "cold_device_ms": profiled_ms(fn, args.reps, flush)}
            else:
                ms = {"ms": event_ms(fn, args.reps)}
            for key, value in ms.items():
                times.setdefault((name, proj, key), []).append(value)
            diffs[(name, proj)] = float(
                (fn().float() - want[proj]).abs().max())
    _build._LOADED["bsr_matmul"] = libs["as_built"]
    for key, value in defaults.items():
        setattr(budget, key, value)
    keys = (("warm_ms", "cold_ms", "warm_device_ms", "cold_device_ms")
            if rows_mode else ("ms",))
    for (name, proj), err in diffs.items():
        print(json.dumps({"variant": name, "proj": proj, "rows": nrows,
                          "block": list(args.block),
                          **{k: times[(name, proj, k)] for k in keys},
                          "max_abs_err": err}), flush=True)
    # each variant's best time summed over the projections (None where the
    # profiler dropped kernels in every try)
    def best(name, p, k):
        got = [t for t in times[(name, p, k)] if t is not None]
        return min(got) if got else None

    def total(name, k):
        parts = [best(name, p, k) for p in projs]
        return None if None in parts else sum(parts)

    print(json.dumps({"sums": {name: {k: total(name, k) for k in keys}
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
