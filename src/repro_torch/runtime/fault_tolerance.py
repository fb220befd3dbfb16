"""Fault-tolerance runtime: checkpoint/restart, failure retry, stragglers.

Port of ``repro/runtime/fault_tolerance.py``, framework-level Python around
the step:

  StragglerMonitor -- per-step wall-time EWMA with k-sigma straggler
      flagging; the serving scheduler feeds it its tick times, the training
      loop its step times.
  FailureDetector  -- classifies a step's exception as retryable (transient
      collective / network markers) or fatal; counts strikes.
  StepRunner       -- the restart loop: run a step, on a retryable failure
      restore the latest committed checkpoint and continue; on repeated
      failure escalate to the caller.
  Backoff          -- deterministic capped-exponential retry delay (no
      jitter: the serving chaos harness asserts exact schedules).

``FailureDetector`` and ``StragglerMonitor`` are shared with the CNN
serving tier (``repro_torch.serving.robust``), which re-enqueues a
retryable serve-step failure under ``Backoff`` and rejects a fatal one.

CUDA errors, classified by the same markers:

  * a sticky error (``CUDA error: an illegal memory access was
    encountered``, ``unspecified launch failure``) poisons the context, so
    it is fatal: no marker matches;
  * ``torch.cuda.OutOfMemoryError`` is fatal, as the reference's
    ``RESOURCE_EXHAUSTED`` is;
  * a collective (NCCL) timeout is retryable: its message says
    "collective";
  * ``cudaErrorDevicesUnavailable`` ("all CUDA-capable devices are busy or
    unavailable") matches ``UNAVAILABLE`` (case-insensitively) and is
    therefore retryable: a card held by another process may come free.

CUDA errors are asynchronous and surface at the first synchronisation, so a
step that wants its faults classified synchronises inside its ``try``.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Optional, Tuple

RETRYABLE_MARKERS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED", "collective",
    "socket closed", "connection reset", "heartbeat",
)


class StragglerMonitor:
    """EWMA step-time monitor with k-sigma straggler flagging."""

    def __init__(self, alpha: float = 0.1, k_sigma: float = 3.0,
                 warmup_steps: int = 5):
        self.alpha = alpha
        self.k = k_sigma
        self.warmup = warmup_steps
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0
        self.flags: collections.deque = collections.deque(maxlen=100)

    def observe(self, dt: float) -> bool:
        """Record one step time; returns True if flagged as straggling."""
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.n > self.warmup:
            sigma = max(self.var ** 0.5, 1e-6)
            if dt > self.mean + self.k * sigma and dt > 1.2 * self.mean:
                is_straggler = True
                self.flags.append((self.n, dt, self.mean))
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler

    def observe_hosts(self, host_times: Dict[int, float]) -> list:
        """Flag specific hosts whose step contribution lags the median."""
        if not host_times:
            return []
        ts = sorted(host_times.values())
        med = ts[len(ts) // 2]
        return [h for h, t in host_times.items()
                if t > 1.5 * med and t - med > 1.0]


class Backoff:
    """Capped exponential retry delay: ``base * mult**attempt``, <= ``cap``.

    Jitter-free: retry schedules must replay under the seeded fault
    injection harness (``repro_torch.serving.chaos``).
    """

    def __init__(self, base_s: float = 0.05, mult: float = 2.0,
                 cap_s: float = 2.0):
        if base_s <= 0 or mult < 1.0:
            raise ValueError(f"bad backoff policy base={base_s} mult={mult}")
        self.base_s = base_s
        self.mult = mult
        self.cap_s = cap_s

    def delay_s(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (0-based: the first retry
        waits ``base_s``)."""
        return min(self.cap_s, self.base_s * self.mult ** max(attempt, 0))


class FailureDetector:
    def __init__(self, max_strikes: int = 3):
        self.max_strikes = max_strikes
        self.strikes = 0

    def classify(self, exc: BaseException) -> str:
        msg = str(exc)
        if any(m.lower() in msg.lower() for m in RETRYABLE_MARKERS):
            return "retryable"
        return "fatal"

    def record(self, exc: BaseException) -> str:
        kind = self.classify(exc)
        if kind == "retryable":
            self.strikes += 1
            if self.strikes >= self.max_strikes:
                return "escalate"
        return kind

    def reset(self) -> None:
        self.strikes = 0


class StepRunner:
    """Checkpoint/restart training loop wrapper.

    run() executes steps, saving every ``ckpt_every``; a retryable failure
    restores the latest committed checkpoint and resumes; repeated failures
    escalate.
    """

    def __init__(self, step_fn: Callable[[Any, Any], Tuple[Any, Dict]],
                 ckpt_manager, loader_factory: Callable[[int], Any], *,
                 ckpt_every: int = 100,
                 monitor: Optional[StragglerMonitor] = None,
                 detector: Optional[FailureDetector] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.loader_factory = loader_factory
        self.ckpt_every = ckpt_every
        self.monitor = monitor or StragglerMonitor()
        self.detector = detector or FailureDetector()

    def run(self, state: Any, start_step: int, num_steps: int,
            *, on_metrics: Optional[Callable[[int, Dict], None]] = None):
        step = start_step
        loader = self.loader_factory(step)
        while step < start_step + num_steps:
            batch = next(loader)
            t0 = time.time()
            try:
                state, metrics = self.step_fn(state, batch)
                # float() waits for the card, so failures surface inside the
                # try and timings are real
                metrics = {k: float(v) for k, v in metrics.items()}
            except Exception as exc:  # noqa: BLE001 - classified below
                verdict = self.detector.record(exc)
                if verdict in ("fatal", "escalate"):
                    self.ckpt.wait()
                    raise
                restored, ck_step = self.ckpt.restore_latest(state)
                if restored is None:
                    raise
                state = restored
                step = ck_step
                loader.close()
                loader = self.loader_factory(step)
                continue
            self.detector.reset()
            dt = time.time() - t0
            if self.monitor.observe(dt) and on_metrics:
                on_metrics(step, {"straggler_flag": dt, **metrics})
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(state, step)
            if on_metrics:
                on_metrics(step, metrics)
        loader.close()
        self.ckpt.wait()
        return state, step
