"""Offline batches, closed loop, one client, two batches in flight.

The cell's traffic: ``batch`` images of ``image`` px a forward, cycled
from ``batches`` seeded batches made on the device at set-up.  Forward
k + 1 is enqueued before batch k's logits are copied to the host (on a
copy stream, so the copy does not wait behind forward k + 1).  The window
runs from the first enqueue until the last result of the batches issued
in ``--seconds`` reached the host; ``images_per_s`` is every image over
that time.  Window entry: ``CnnEngine.__call__`` (``models.cnn
.engine_for``) with the configuration's method (``auto``: the engine's
own roofline plan, made at set-up for the cell's batch; ``pallas``: every
pruned conv on the ELL kernel).  Every result of the window is compared
with the reference's logits of its batch.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from escoin_bench import judge, profiling, weights
from escoin_bench.harness import Ctx, Run
from escoin_bench.reference import cnn as ref
from escoin_bench.systems import cnn as system


class Pump:
    """Forwards with two in flight: forward k + 1 is enqueued before batch
    k's logits are copied to the host, on a copy stream that waits for
    forward k alone.  The stream and the pinned host buffer are made
    once, at set-up."""

    def __init__(self, call: Callable, batches: torch.Tensor,
                 out_shape: Tuple[int, ...], device: torch.device):
        self.call, self.batches, self.device = call, batches, device
        self.cuda = device.type == "cuda"
        self.copy = torch.cuda.Stream(device) if self.cuda else None
        self.host = (torch.empty(out_shape, pin_memory=True) if self.cuda
                     else None)

    def _collect(self, results, k, y, done) -> None:
        if not self.cuda:
            results.append((k, y.numpy().copy()))
            return
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(done)
            self.host.copy_(y, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self.copy)
        landed.synchronize()
        results.append((k, self.host.numpy().copy()))

    def __call__(self, *, seconds: float = 0.0, count: int = 0,
                 dispatch: List[float] = None,
                 ) -> Tuple[List[Tuple[int, np.ndarray]], float, float]:
        """Issue forwards for ``seconds`` (or ``count`` of them); return
        ``[(k, logits)]``, the start and the last result's arrival."""
        results: List[Tuple[int, np.ndarray]] = []
        pending = None
        t0 = time.perf_counter()
        k = 0
        while (count and k < count) or (
                seconds and time.perf_counter() - t0 < seconds):
            ts = time.perf_counter()
            y = self.call(self.batches[k % len(self.batches)])
            if dispatch is not None:
                dispatch.append(time.perf_counter() - ts)
            done = None
            if self.cuda:
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                self._collect(results, *pending)
            pending = (k, y, done)
            k += 1
        if pending is not None:
            self._collect(results, *pending)
        return results, t0, time.perf_counter()


def run(ctx: Ctx) -> Run:
    tr, dev = ctx.cell["traffic"], ctx.device
    method = ctx.config["plan"]
    batch, image = tr["batch"], tr["image"]
    marks = [("start", time.perf_counter() - ctx.t_process)]
    built = system.build(ctx.config, ctx.seed, image, dev)
    marks.append(("weights and banks", time.perf_counter() - ctx.t_process))
    from repro_torch.models import cnn

    engine = cnn.engine_for(built.net, built.params,
                            system.in_shape(ctx.config, image), device=dev)
    plan_s: List[float] = []
    with system.timed_planner(plan_s):
        report = engine.execution_report(
            (batch,) + system.in_shape(ctx.config, image), method)
    layers = system.layer_bounds(built.convs, built.nnz, report, batch)
    marks.append(("plan and report", time.perf_counter() - ctx.t_process))
    call = engine if ctx.engine_hook is None else ctx.engine_hook(engine)

    def forward(x):
        return call(x, method)

    batches = weights.image_batches(tr["batches"], batch,
                                    system.in_shape(ctx.config, image),
                                    ctx.seed, dev)
    pump = Pump(forward, batches, (batch, built.fcs[-1]["out_f"]), dev)
    pump(count=3)        # banks derived, cuDNN's algorithms chosen
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t_process
    marks.append(("warm-up", setup_s))

    dispatch: List[float] = []
    results, t0, t1 = pump(seconds=ctx.seconds, dispatch=dispatch)
    images = len(results) * batch
    window_s = t1 - t0
    trace, traced = None, []
    if ctx.trace:
        def slice_():
            traced.extend(pump(count=tr["trace_forwards"])[0])
        trace = profiling.profiled(slice_, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, call

    # The reference, once the window has closed: one forward a batch.
    fcw = ref.fc_weights(built.fcs, built.fc_seed, dev)
    refs = [ref.forward(ctx.config["layers"], built.weights, fcw, x)
            .cpu().numpy() for x in batches]
    err = max(float(judge.image_errors(y, refs[k % len(refs)]).max())
              for k, y in results + traced)
    fallbacks = report.fallback_count
    return Run(
        e2e={"images_per_s": images / window_s, "setup_s": setup_s},
        attempted=images, failed=images if fallbacks else 0,
        checks={"logit_err": (err, ctx.cell["limits"]["logit_err"])},
        ok=fallbacks == 0 and len(results) > 0,
        memory_peak_bytes=peak, window_s=window_s, images=images,
        flops_per_image=built.flops_per_image,
        spans={"dispatch": dispatch, "plan": plan_s}, layers=layers,
        forwards_traced=len(traced), trace=trace,
        notes=[f"{len(results)} batches of {batch} in {window_s:.3f} s, "
               f"{fallbacks} fallback ops, plan {sum(plan_s):.3f} s",
               f"set-up s at each step: {[(k, round(v, 3)) for k, v in marks]}"])
