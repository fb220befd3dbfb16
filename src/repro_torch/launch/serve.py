"""Serving CLI: batched prefill + decode with KV cache (+ Escoin sparsity).

Port of the LLM branch of ``repro/launch/serve.py``.  With --sparsity > 0,
every large linear weight is block-pruned and served through the Escoin
BCSR path, whose products run the ``bsr_matmul`` CUDA kernel on the card::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --sparsity 0.8

With --autotune, the kernel-customization autotuner (repro_torch.tuning)
plans a CNN instead: per-layer method, tiles and value storage, persisted to
a JSON plan cache (default under the checkout's git-ignored ``build/``),
checked by a reload round trip and an auto-vs-dense check on a reduced
layer slice; --trace writes the run's Chrome trace::

  PYTHONPATH=src python -m repro_torch.launch.serve --autotune \
      --cnn alexnet [--tune-mode roofline|wall] [--plan-cache PATH] \
      [--trace out.json] [--device cpu]

With --cnn-serve, the fault-tolerant bucketed CNN serving tier
(``repro_torch.serving.robust``) serves a seeded arrival trace over a
reduced slice of the net (12 px, two buckets) on a virtual clock; --chaos
injects seeded faults (step faults, plan corruption, stragglers), and the
run must still lose no request and leave degradation evidence::

  PYTHONPATH=src python -m repro_torch.launch.serve --cnn-serve \
      --cnn resnet50 [--chaos] [--chaos-seed 0] [--requests 40] \
      [--device cpu]

It runs on the card; ``--device cpu`` runs the plain PyTorch versions on
the CPU (a smoke config is the size for that; with --autotune, ``--smoke``
tunes at a reduced image size).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs as cfgs
from repro_torch import resolve_device, telemetry
from repro_torch.core.pruning import block_prune
from repro_torch.core.sparse_format import BcsrMatrix, bcsr_from_dense
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T

SKIP = frozenset({"embed", "lm_head", "router", "conv_w"})
# the checkout's git-ignored build directory
DEFAULT_PLAN_CACHE = str(Path(__file__).resolve().parents[3] / "build"
                         / "plans" / "autotune_cache.json")


def prune_to_bcsr(w: torch.Tensor, sparsity: float, block,
                  whole_tiles: bool = False) -> BcsrMatrix:
    """The BCSR of W^T, in ``block`` tiles of ``w``'s dtype, for a dense
    (in, out) weight ``w`` block-pruned in f32 (``block_prune``).

    The one place that decides how a weight is pruned into a bank.  The
    reference's ``sparsify_params`` prunes the (in, out) weight itself in
    ``block`` (``whole_tiles=False``), so a pruned tile is a whole tile of
    the bank only for a square block; ``whole_tiles`` prunes W^T in
    ``block``, so that every pruned tile is a whole tile of the bank at any
    block (a meshed shard in the reference's tall (M / tp, 128) blocks,
    ``sparse_weights.sparsify_shards``).  The two agree at a square block.
    """
    wf = w.float()
    pruned = (block_prune(wf.T, sparsity, block) if whole_tiles
              else block_prune(wf, sparsity, block).T)
    b = bcsr_from_dense(pruned, block)
    return dataclasses.replace(b, blocks=b.blocks.to(w.dtype))


def sparsify_params(params, cfg, sparsity: float, block=(16, 16),
                    min_dim: int = 64):
    """Prune and convert every large 2-D linear weight to Escoin BCSR, in
    place, one matrix at a time.

    A 2-D weight named outside ``SKIP`` (the router, Mamba2's conv and the
    embeddings stay dense) with both dims >= ``min_dim`` is
    block-pruned in f32 and stored as the BCSR of its transpose
    (``prune_to_bcsr``: dense weights are (in, out); BCSR computes x @ W.T
    for (out, in)), with tiles in the weight's dtype (exact: the f32 copy
    holds the same values).  The work happens on the weight's device, and each
    dense leaf is replaced as soon as its bank is built, so the dense model
    never sits beside its banks.  A MoE layer's stacked (E, in, out)
    experts stay dense, as the reference's 4-D stacked experts do.  Leaves
    in dicts and lists are converted in place; a weight at the root is
    returned converted.
    """
    def conv(name, w):
        if name in SKIP or not isinstance(w, torch.Tensor):
            return w
        if w.ndim == 2 and min(w.shape) >= min_dim:
            return prune_to_bcsr(w, sparsity, block)
        return w

    def visit(p, name=""):
        if isinstance(p, dict):
            for k in list(p):
                p[k] = visit(p[k], k)
            return p
        if isinstance(p, list):
            for i in range(len(p)):
                p[i] = visit(p[i], name)
            return p
        return conv(name, p)

    return visit(params)


def autotune_main(args) -> None:
    """CNN autotune flow: lower -> plan -> persist -> reload round trip ->
    auto-vs-dense check on a reduced slice, on ``args.device``."""
    from repro_torch.engine import CnnEngine, lower
    from repro_torch.models import cnn
    from repro_torch.tuning import (PlanCache, apply_plan_to_params,
                                    format_plan, plan_program)

    dev = resolve_device(args.device)
    name = args.cnn
    net = cnn.NETWORKS[name]()
    image = ({"alexnet": 99, "googlenet": 96, "resnet50": 96}[name]
             if args.smoke else 224)
    mode = args.tune_mode
    params = None
    rng = np.random.default_rng(args.seed)
    if mode == "wall":
        params = cnn.init_cnn(net, 3, rng, image, device=dev)

    program = lower(net, (3, image, image))
    cache = PlanCache(args.plan_cache)
    t0 = time.perf_counter()
    plan = plan_program(program, batch=1, mode=mode, cache=cache,
                        params=params, device=dev)
    fused = sum(pe.method in ("pallas", "bsr") and pe.fuse
                for pe in plan.values())
    print(f"tuned {name} @ {image}px on {dev} "
          f"({mode}, {time.perf_counter() - t0:.2f}s): {program.summary()}; "
          f"{len(plan)} conv layers ({fused} fused-epilogue kernels), "
          f"{len(cache)} cache entries -> {args.plan_cache}")
    print(format_plan(plan))

    # a fresh cache loaded from disk reproduces the plan, every layer a hit
    replan = plan_program(program, batch=1, mode=mode,
                          cache=PlanCache(args.plan_cache), params=params,
                          device=dev)
    if replan != plan:
        raise SystemExit("plan cache reload did not reproduce the plan")
    print(f"plan cache round-trip ok ({args.plan_cache})")

    # auto vs dense on a reduced-channel slice: the first dense-kept conv
    # and the first two sparse ones, at 12 px
    convs = [l for l, _ in program.conv_table]
    picked = ([next(l for l in convs if l.sparsity == 0)]
              + [l for l in convs if l.sparsity > 0][:2])
    slice_net = []
    for l in picked:
        slice_net.append(dataclasses.replace(
            l, out_c=max(8, min(32, l.out_c // 8)), stride=1))
        slice_net.append(cnn.Relu())
    slice_prog = lower(slice_net, (3, 12, 12))
    sparams = cnn.init_cnn(slice_net, 3, rng, 12, device=dev)
    x = torch.from_numpy(rng.standard_normal((1, 3, 12, 12)).astype(
        np.float32)).to(dev)
    # a fresh in-memory cache: the slice's geometries stay out of the file
    splan = plan_program(slice_prog, batch=1, mode="roofline",
                         cache=PlanCache(), device=dev)
    apply_plan_to_params(sparams, splan)
    engine = CnnEngine(slice_prog, sparams, splan, device=dev)
    y_auto = engine(x, "auto")
    report = engine.last_report if telemetry.is_enabled() else None
    y_dense = engine(x, "dense")
    torch.testing.assert_close(y_auto, y_dense, rtol=1e-4, atol=1e-4)
    methods = sorted({pe.method for pe in splan.values()})
    print(f"auto-vs-dense slice check ok (slice methods: "
          f"{', '.join(methods)})")
    if report is not None:
        print(report.format())
        if report.fallback_count:
            raise SystemExit(
                f"traced forward took {report.fallback_count} fallback(s): "
                f"{[o.fallback_reason for o in report.fallback_ops]}")
        engine.forward_timed(x, "auto")


def cnn_serve_main(args) -> None:
    """Robust CNN serving flow: shape-bucketed admission and degradation
    ladder over a reduced network slice, driven by a seeded arrival trace
    on a virtual clock (deterministic).  ``--chaos`` turns on seeded fault
    injection: the run must still terminate every request (zero lost) and
    leave degradation evidence (a ladder step-down or a dropped rung)."""
    from repro_torch.engine import init_conv_params, lower
    from repro_torch.serving import (BucketSpec, ChaosConfig, ChaosInjector,
                                     RobustCnnServer, VirtualClock,
                                     arrival_trace, slice_net)

    dev = resolve_device(args.device)
    name = args.cnn
    net = slice_net(name)
    rng = np.random.default_rng(args.seed)
    params = init_conv_params(lower(net, (3, 12, 12)), rng, device=dev)
    chaos = None
    if args.chaos:
        chaos = ChaosInjector(ChaosConfig(
            seed=args.chaos_seed, step_fault_rate=0.35,
            plan_corruption_rate=0.5, straggler_rate=0.1))
    server = RobustCnnServer(
        net, params,
        [BucketSpec(3, 12, 12, batch=2), BucketSpec(3, 16, 16, batch=2)],
        clock=VirtualClock(), queue_depth=16, max_attempts=6,
        cooldown_ticks=4, chaos=chaos, device=dev)
    trace = arrival_trace(
        args.requests, [(3, 12, 12), (3, 10, 10), (3, 16, 16)],
        seed=args.seed, mean_gap_s=0.0005, deadline_s=(1.0, 2.0))
    ladder = {b.spec.key: [r.name for r in b.rungs] for b in server._buckets}
    print(f"serving {name} slice on {dev}: {args.requests} requests over "
          f"{len(ladder)} buckets; ladders {ladder}"
          + (f"; chaos seed {args.chaos_seed}" if chaos else ""))
    rep = server.run_trace(trace)
    print(rep.format())
    rep.verify()  # zero lost, zero duplicated, or raise
    if chaos is not None:
        print("chaos:", chaos.summary())
        if not (rep.degradations or rep.dropped_rungs):
            raise SystemExit(
                "chaos run left no degradation evidence (no ladder "
                "step-down, no dropped rung): injection did not exercise "
                "the ladder")
    print(f"slo ok: {rep.completed}/{rep.submitted} served, "
          f"{rep.rejected_total} shed with reasons, 0 lost")


def export_trace(path: str) -> None:
    """Validate and write the tracer's Chrome-trace JSON, with a metrics
    summary: what ``--trace out.json`` produces."""
    tracer = telemetry.get_tracer()
    tracer.export(path)
    print(f"exported {len(tracer)} trace events -> {path} "
          f"({len(telemetry.snapshot())} metrics recorded)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help=f"one of {cfgs.list_archs()}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--autotune", action="store_true",
                    help="run the kernel-customization autotuner (CNN path)")
    ap.add_argument("--cnn", default="alexnet",
                    choices=("alexnet", "googlenet", "resnet50"))
    ap.add_argument("--plan-cache", default=DEFAULT_PLAN_CACHE)
    ap.add_argument("--tune-mode", default="roofline",
                    choices=("roofline", "wall"))
    ap.add_argument("--trace", metavar="OUT_JSON",
                    help="enable telemetry and export a Chrome-trace JSON "
                         "(chrome://tracing / Perfetto) on exit")
    ap.add_argument("--cnn-serve", action="store_true",
                    help="run the fault-tolerant bucketed CNN serving loop "
                         "(repro_torch.serving.robust) on a reduced slice")
    ap.add_argument("--chaos", action="store_true",
                    help="with --cnn-serve: seeded fault injection (step "
                         "faults, plan corruption, stragglers)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=40,
                    help="with --cnn-serve: arrival-trace length")
    args = ap.parse_args(argv)

    if args.trace:
        telemetry.enable()
    if args.cnn_serve:
        cnn_serve_main(args)
        if args.trace:
            export_trace(args.trace)
        return
    if args.autotune:
        autotune_main(args)
        if args.trace:
            export_trace(args.trace)
        return
    if not args.arch:
        ap.error("--arch is required unless --autotune or --cnn-serve is "
                 "given")

    cfg = cfgs.get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dev)
    if args.sparsity > 0:
        params = sparsify_params(params, cfg, args.sparsity)
        print(f"serving with Escoin BCSR weights at sparsity {args.sparsity}")

    b, p, g = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    cache = T.init_cache(cfg, b, p + g, dev)
    serve_step = make_serve_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill token by token through the decode step, as the reference does
    t0 = time.perf_counter()
    for i in range(p):
        nxt, cache = serve_step(params, prompts[:, i:i + 1], cache, i)
    sync()
    t_prefill = time.perf_counter() - t0

    out = [nxt]
    t0 = time.perf_counter()
    for i in range(p, p + g - 1):
        nxt, cache = serve_step(params, out[-1][:, None], cache, i)
        out.append(nxt)
    sync()
    t_decode = time.perf_counter() - t0
    gen_ids = torch.stack(out, dim=1).cpu()
    assert gen_ids.shape == (b, g), gen_ids.shape
    assert bool(((gen_ids >= 0) & (gen_ids < cfg.vocab)).all())
    print(f"generated {g} tokens x {b} seqs on {dev}; prefill "
          f"{t_prefill:.2f}s, decode {t_decode:.2f}s "
          f"({t_decode / max(g - 1, 1) * 1e3:.1f} ms/tok)")
    print("sample:", gen_ids[0, :12].tolist())
    if args.trace:
        export_trace(args.trace)


if __name__ == "__main__":
    main()
