"""An open-loop image service: ``RobustCnnServer`` on ``WallClock``.

The cell's traffic: single images of the ``sizes`` given, each drawn from a
pool of ``pool_per_size`` seeded host images, arriving on a Poisson-like
schedule at the fixed ``rate`` (``traffic.open_loop``: exactly rate x
seconds requests), every request with the deadline ``deadline_s``; the
server has one bucket of ``bucket_batch`` images for each of ``buckets``
and its default ladder (tuned, quantised, dense).  The tuned rung is the
configuration's plan: ``auto`` the server's own roofline plan a bucket,
``pallas`` every pruned conv on the ELL kernel.

Window entry: ``run_trace`` over the schedule; the window runs from its
start until it returns, every request answered or rejected.  Each
request is timed from when it was due to when its result reached the host
(a rejected one: until the window closed).  Every completed answer is
compared with the reference's logits of its image, zero-padded to its
bucket as the server pads it.  An answer computed on another rung than
the tuned one counts as failed: the configuration states f32 at its plan.
The end-to-end number is the goodput: requests answered on the tuned
rung within ``slo_ms`` of being due, over the window; the cell's fixed
rate is its ceiling, and it falls as the serving path slows enough that
answers miss the limit, are shed or step down the ladder.  The latencies
themselves go to the per-layer ``p95_ms.serve``: their tail spreads too
widely from run to run to hold a bound.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from escoin_bench import judge, profiling, traffic, weights
from escoin_bench.harness import Ctx, Run
from escoin_bench.reference import cnn as ref
from escoin_bench.systems import cnn as system

TRACE_PURPOSE = 5


class Spanned:
    """A bucket's engine with a host span around each call, until it
    returns (no synchronisation: the server copies the result after)."""

    def __init__(self, engine, spans: List[float]):
        self.engine = engine
        self.spans = spans

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return self.engine(*args, **kw)
        finally:
            self.spans.append(time.perf_counter() - t0)


def run(ctx: Ctx) -> Run:
    from repro_torch.serving import robust

    tr, dev, cfg = ctx.cell["traffic"], ctx.device, ctx.config
    sizes, buckets = tr["sizes"], tr["buckets"]
    marks = [("start", time.perf_counter() - ctx.t_process)]
    built = system.build(cfg, ctx.seed, max(buckets), dev)
    marks.append(("weights and banks", time.perf_counter() - ctx.t_process))
    plan = system.ell_plan if cfg["plan"] == "pallas" else None
    plan_s: List[float] = []
    with system.timed_planner(plan_s):
        server = robust.RobustCnnServer(
            built.net, built.params,
            [robust.BucketSpec(cfg["in_channels"], s, s, tr["bucket_batch"])
             for s in buckets],
            plan=plan, default_deadline_s=tr["deadline_s"],
            clock=robust.WallClock(), device=dev)
    marks.append(("server", time.perf_counter() - ctx.t_process))
    buckets_ = server._buckets
    notes = [f"dropped rungs: {server.dropped_rungs}"] \
        if server.dropped_rungs else []
    tuned_ok = all(b.rungs[0].name == "tuned"
                   and b.rungs[0].report.fallback_count == 0
                   for b in buckets_)
    dispatch: List[float] = []
    for b in buckets_:
        x = torch.zeros((tr["bucket_batch"],) + b.spec.shape, device=dev)
        for rung in b.rungs:    # banks, halves, cuDNN's choice: set-up
            for _ in range(2):
                b.engine(x, "auto", plan_override=rung.plan, rung=rung.name)
        eng = b.engine if ctx.engine_hook is None else ctx.engine_hook(
            b.engine)
        b.engine = Spanned(eng, dispatch)
    pool = weights.image_pool(sizes, tr["pool_per_size"], cfg["in_channels"],
                              ctx.seed)

    def serve(arrivals):
        make = lambda a: robust.InferenceRequest(  # noqa: E731
            rid=a.rid, x=pool[a.size][a.image], deadline_s=a.deadline_s)
        t0 = time.perf_counter()
        server.run_trace(arrivals, request_factory=make, max_ticks=10 ** 9)
        return t0, time.perf_counter()

    arrivals = traffic.open_loop(tr["rate"], ctx.seconds, sizes,
                                 tr["pool_per_size"], tr["deadline_s"],
                                 ctx.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t_process
    marks.append(("warm-up", setup_s))
    t0, t1 = serve(arrivals)
    slo = server.slo_report()
    window_dispatch = list(dispatch)
    window_s = t1 - t0
    by_rid = {r.rid: r for r in server.requests}
    late, lat = [], []
    for a in arrivals:
        r = by_rid[a.rid]
        due = t0 + a.t_s
        late.append(r.submitted_s - due)
        lat.append((r.completed_s if r.status == "done" else t1) - due)
    trace = None
    traced: List[robust.InferenceRequest] = []
    if ctx.trace:
        extra = traffic.open_loop(tr["rate"], tr["trace_seconds"], sizes,
                                  tr["pool_per_size"], tr["deadline_s"],
                                  ctx.seed, purpose=TRACE_PURPOSE,
                                  first_rid=len(arrivals))
        trace = profiling.profiled(lambda: serve(extra), dev)
        traced = [r for r in server.requests if r.rid >= len(arrivals)]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = [by_rid[a.rid] for a in arrivals]
    good = sum(1 for r, t in zip(window, lat) if r.status == "done"
               and r.rung == "tuned" and t <= tr["slo_ms"] / 1e3)
    done = [r for r in window + traced if r.status == "done"]
    off_rung = sum(1 for r in done if r.rung != "tuned")
    del server, buckets_

    # The reference, once the window has closed: each pool image once,
    # zero-padded into its bucket (the smallest that holds it).
    fcw = ref.fc_weights(built.fcs, built.fc_seed, dev)
    refs: Dict[Tuple[int, int], np.ndarray] = {}
    for si, x in enumerate(weights.padded_pool(pool, sizes, buckets)):
        y = ref.forward(cfg["layers"], built.weights, fcw, x.to(dev))
        for i, row in enumerate(y.cpu().numpy()):
            refs[(si, i)] = row
    arrival = {a.rid: a for a in arrivals}
    if ctx.trace:
        arrival.update({a.rid: a for a in extra})
    tuned = [r for r in done if r.rung == "tuned"]
    err = 0.0
    if tuned:
        ys = np.stack([r.result for r in tuned])
        rs = np.stack([refs[(arrival[r.rid].size, arrival[r.rid].image)]
                       for r in tuned])
        err = float(judge.image_errors(ys, rs).max())
    failed = len(arrivals) - slo.completed + sum(
        1 for r in window if r.status == "done" and r.rung != "tuned")
    quarters = [float(np.median(q)) * 1e3 for q in np.array_split(lat, 4)]
    notes.append(
        f"{slo.completed}/{slo.submitted} completed in {window_s:.3f} s, "
        f"{good} within {tr['slo_ms']} ms on the tuned rung, "
        f"{slo.ticks} ticks, rejected {slo.rejected}, ladder "
        f"{[(round(e.t_s - t0, 3), e.bucket, e.to_rung, e.reason) for e in slo.degradations]}, "
        f"{off_rung} answers off the tuned rung, median ms a quarter of "
        f"the schedule {[round(q, 2) for q in quarters]}, "
        f"plan {sum(plan_s):.3f} s")
    notes.append(f"set-up s at each step: "
                 f"{[(k, round(v, 3)) for k, v in marks]}")
    return Run(
        e2e={"goodput_images_per_s": good / window_s, "setup_s": setup_s},
        attempted=len(arrivals), failed=failed,
        checks={"logit_err": (err, ctx.cell["limits"]["logit_err"])},
        ok=(tuned_ok and slo.lost == 0 and slo.duplicated == 0
            and len(tuned) > 0),
        memory_peak_bytes=peak, window_s=window_s, images=slo.completed,
        flops_per_image=built.flops_per_image,
        spans={"dispatch": window_dispatch, "plan": plan_s,
               "late": late, "latency": lat},
        counts={"completed": slo.completed, "ticks": slo.ticks,
                "bucket_batch": tr["bucket_batch"],
                "step_downs": len([e for e in slo.degradations
                                   if e.reason != "recovered"])},
        trace=trace, notes=notes)
