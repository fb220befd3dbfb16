"""Continuous-batching serving engine (slot-based, vLLM-style scheduling
over fixed-shape decode steps).

Port of ``repro/serving/scheduler.py``.  The ``serve_step`` has a fixed
batch of B *slots*; the scheduler admits requests into free slots, steps the
whole batch every tick, and retires slots whose request hit its token
budget or produced EOS.  The cache tensors never change shape, so every
tick launches the same kernels at the same shapes whatever the arrival
pattern.  The engine moves each tick's tokens to its ``device`` (the card
unless the caller asks for the CPU) and reads the step's next tokens back
to the host.

Position bookkeeping: the model's decode path takes a *scalar* ``cur_len``
— every slot's KV is written at one shared position per tick.  The engine
therefore drives a monotonic write cursor (reset only when the batch fully
drains) so the write position never regresses and live KV is never
clobbered, and tracks a per-slot ``pos`` for retirement so each request is
retired at its own depth.  Mid-stream admission is capacity-gated: a
request only enters a free slot when the cache depth remaining above the
cursor covers its prompt + generation budget; otherwise it waits for the
batch to drain (continuous batching degrades to waves near capacity —
correct, if not latency-optimal).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.runtime.fault_tolerance import StragglerMonitor


class DrainExhaustedWarning(UserWarning):
    """``run_until_drained`` hit ``max_ticks`` with requests still pending."""


class StragglerTickWarning(UserWarning):
    """A serving tick straggled (k-sigma above the EWMA tick time)."""


class DrainResult(List["Request"]):
    """``run_until_drained``'s return value: the finished-request list
    (drop-in for existing callers) plus the drain status.

    ``drained`` is False when the tick budget ran out with requests still
    queued or active — previously a *silently incomplete* return; callers
    that must not lose requests check it (or count
    ``serving.drain_exhausted``).
    """

    drained: bool = True
    ticks: int = 0
    pending_queued: int = 0
    pending_active: int = 0

    @property
    def pending(self) -> int:
        return self.pending_queued + self.pending_active


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0              # next KV write position for this slot
    prompt_cursor: int = 0    # how much of the prompt has been fed

    @property
    def free(self) -> bool:
        return self.request is None


class ContinuousBatcher:
    """Admission + retirement policy over B fixed slots."""

    def __init__(self, n_slots: int, max_len: int):
        self.slots = [_Slot() for _ in range(n_slots)]
        self.max_len = max_len
        self.queue: List[Request] = []
        # Oversize-rejected requests: popped from the queue at admission, so
        # they must be tracked here or they vanish from the finished list.
        self.rejected: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self, budget: Optional[int] = None) -> int:
        """Fill free slots from the queue.

        ``budget`` is the cache depth still available (engine: max_len minus
        the current write cursor).  Requests that can never fit max_len are
        rejected outright; requests that merely don't fit the *remaining*
        budget stay queued until the batch drains and the cursor resets.
        """
        budget = self.max_len if budget is None else budget
        admitted = 0
        for slot in self.slots:
            if not self.queue:
                break
            if slot.free:
                req = self.queue[0]
                if len(req.prompt) + req.max_new_tokens > self.max_len:
                    self.queue.pop(0)
                    req.done = True  # reject oversize; surfaced to caller
                    self.rejected.append(req)
                    if telemetry.is_enabled():
                        telemetry.counter("serving.rejections").inc()
                    continue
                if len(req.prompt) + req.max_new_tokens > budget:
                    break  # not enough cache left this wave: wait, don't drop
                self.queue.pop(0)
                slot.request = req
                slot.pos = 0
                slot.prompt_cursor = 0
                admitted += 1
        if admitted and telemetry.is_enabled():
            telemetry.counter("serving.admissions").inc(admitted)
        return admitted

    def retire(self) -> List[Request]:
        out = []
        for slot in self.slots:
            req = slot.request
            if req is None:
                continue
            hit_budget = len(req.output) >= req.max_new_tokens
            hit_eos = (req.eos_id is not None and req.output
                       and req.output[-1] == req.eos_id)
            hit_cap = slot.pos >= self.max_len - 1
            if hit_budget or hit_eos or hit_cap:
                req.done = True
                out.append(req)
                slot.request = None
        if out and telemetry.is_enabled():
            telemetry.counter("serving.retirements").inc(len(out))
        return out

    @property
    def active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)


class ServeEngine:
    """Drives a serve_step over the batcher's slots.

    serve_step(params, tokens (B,1), cache, cur_len int) -> (next (B,), cache)
    """

    def __init__(self, serve_step: Callable, params, cache, n_slots: int,
                 max_len: int, pad_id: int = 0,
                 monitor: Optional[StragglerMonitor] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.step = serve_step
        self.params = params
        self.cache = cache
        self.batcher = ContinuousBatcher(n_slots, max_len)
        self.n_slots = n_slots
        self.max_len = max_len
        self.pad_id = pad_id
        self._tick = 0
        # Shared KV write position: monotonic while any slot is live, reset
        # only when the batch fully drains.  Taking max(slot.pos) instead
        # would regress when the deepest slot retires and overwrite live KV.
        self._cursor = 0
        # Soft-failure detection: working-tick wall times feed an EWMA
        # monitor; a k-sigma outlier tick is a straggler (host contention,
        # background compile, a slow collective) — counted, and warned
        # about once so a degrading serving host leaves a signal even with
        # telemetry off.
        self.monitor = monitor or StragglerMonitor()
        self._straggler_warned = False

    def submit(self, req: Request) -> None:
        self.batcher.submit(req)

    def _feed_tokens(self) -> np.ndarray:
        toks = np.full((self.n_slots, 1), self.pad_id, np.int32)
        for i, slot in enumerate(self.batcher.slots):
            req = slot.request
            if req is None:
                continue
            if slot.prompt_cursor < len(req.prompt):
                toks[i, 0] = req.prompt[slot.prompt_cursor]
            elif req.output:
                toks[i, 0] = req.output[-1]
        return toks

    def tick(self) -> None:
        telem = telemetry.is_enabled()
        t0 = time.perf_counter()
        self.batcher.admit(budget=self.max_len - self._cursor)
        if telem:
            # Levels are recorded even for idle ticks (before the early
            # return) so the gauges reflect drained batches too.
            telemetry.gauge("serving.queue_depth").set(
                len(self.batcher.queue))
            telemetry.gauge("serving.active_slots").set(self.batcher.active)
        if self.batcher.active == 0:
            return
        toks = self._feed_tokens()
        # Shared-position stepping: all live slots write KV at the engine
        # cursor (the model's cur_len is a scalar).
        cur = self._cursor
        nxt, self.cache = self.step(
            self.params, torch.from_numpy(toks).to(self.device), self.cache,
            cur)
        nxt = torch.as_tensor(nxt).cpu().numpy()
        for i, slot in enumerate(self.batcher.slots):
            req = slot.request
            if req is None:
                continue
            # Advance each slot's position individually: snapping to the
            # global max would jump mid-stream admissions to the deepest
            # slot's depth and make hit_cap retire fresh requests early.
            slot.pos += 1
            if slot.prompt_cursor < len(req.prompt):
                slot.prompt_cursor += 1
                if slot.prompt_cursor == len(req.prompt):
                    req.output.append(int(nxt[i]))  # first generated token
            else:
                req.output.append(int(nxt[i]))
        self._cursor += 1
        self.batcher.retire()
        if self.batcher.active == 0:
            self._cursor = 0  # batch drained: next wave reuses the cache
        self._tick += 1
        # Straggler accounting covers working ticks only — idle ticks
        # return above and would drown both the EWMA and the latency
        # distribution in no-op times.
        dt = time.perf_counter() - t0
        if self.monitor.observe(dt):
            if telem:
                telemetry.counter("serving.straggler_ticks").inc()
            if not self._straggler_warned:
                self._straggler_warned = True
                warnings.warn(
                    f"ServeEngine: tick {self._tick - 1} took {dt * 1e3:.1f} "
                    f"ms against an EWMA of {self.monitor.mean * 1e3:.1f} ms "
                    f"— straggling (further stragglers are counted under "
                    f"serving.straggler_ticks, not warned)",
                    StragglerTickWarning, stacklevel=2)
        if telem:
            telemetry.gauge("serving.tick_ewma_s").set(self.monitor.mean)
            telemetry.histogram("serving.tick_latency_s").observe(dt)

    def run_until_drained(self, max_ticks: int = 10_000) -> DrainResult:
        finished: DrainResult = DrainResult()
        ticks = 0
        for _ in range(max_ticks):
            before = [s.request for s in self.batcher.slots]
            self.tick()
            ticks += 1
            finished.extend(r for r in before
                            if r is not None and r.done and r not in finished)
            if not self.batcher.queue and self.batcher.active == 0:
                break
        # collect any stragglers: requests still queued, and oversize
        # rejections (popped from the queue at admission — sweeping only the
        # queue silently dropped them from the finished list).  Rejections
        # are drained, not copied: a reused engine must not re-surface them
        # (or leak them) on the next drain cycle.
        finished.extend(r for r in self.batcher.queue if r.done)
        finished.extend(r for r in self.batcher.rejected if r not in finished)
        self.batcher.rejected.clear()
        finished.ticks = ticks
        finished.pending_queued = sum(1 for r in self.batcher.queue
                                      if not r.done)
        finished.pending_active = self.batcher.active
        finished.drained = finished.pending == 0
        if not finished.drained:
            # Hitting the tick budget with live requests used to return
            # silently incomplete — surface it: the caller sees the status,
            # telemetry counts it, and a warning names the shortfall.
            if telemetry.is_enabled():
                telemetry.counter("serving.drain_exhausted").inc()
            warnings.warn(
                f"run_until_drained: tick budget {max_ticks} exhausted with "
                f"{finished.pending_queued} request(s) still queued and "
                f"{finished.pending_active} still active — returned list is "
                f"incomplete (result.drained is False)",
                DrainExhaustedWarning, stacklevel=2)
        return finished
