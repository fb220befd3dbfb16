"""Structured span/event tracer with Chrome-trace-format JSON export.

Port of ``repro/telemetry/trace.py``; the document format is the same, so a
trace from either package passes either package's validator.

Spans collect into an in-memory event list and export as the Chrome trace
event format (the ``{"traceEvents": [...]}`` JSON that chrome://tracing and
Perfetto load): complete events (``ph="X"``) for spans with a duration,
instant events (``ph="i"``) for point markers, and metadata events
(``ph="M"``) naming the lanes.  Timestamps are microseconds relative to the
tracer's first event, taken from ``time.perf_counter`` — a monotonic clock,
so spans never go backwards.

Two kinds of spans share the timeline on separate lanes (``tid``):

  wall      -- real measured durations (timed-mode op segmentation:
               CUDA events on the card, the host clock on the CPU)
  roofline  -- analytic per-op durations from an ExecutionReport: the
               engine's default (untimed) forward does not synchronise
               between ops, so it lays the roofline-attributed estimates
               out sequentially instead, tagged ``args.estimated = true``

:func:`validate_chrome_trace` checks an exported document against the
schema the tools require; CI runs it on a traced forward so a malformed
export fails the build instead of failing to load in Perfetto.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List, Optional

# Lane ids (Chrome trace "tid"): one per span kind.
TID_WALL = 0
TID_ROOFLINE = 1

_THREAD_NAMES = {TID_WALL: "wall", TID_ROOFLINE: "roofline (estimated)"}


class Tracer:
    """Collects span/instant events; exports Chrome-trace JSON."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._t0: Optional[float] = None

    # -- clock ------------------------------------------------------------

    def _rel_us(self, t_s: Optional[float] = None) -> float:
        """Microseconds since the tracer's first event."""
        t_s = time.perf_counter() if t_s is None else t_s
        if self._t0 is None:
            self._t0 = t_s
        return (t_s - self._t0) * 1e6

    # -- recording --------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "op", tid: int = TID_WALL,
             **args: Any):
        """Context manager recording one complete ("X") event."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self.complete(name, start_s=t0, dur_s=t1 - t0, cat=cat,
                          tid=tid, args=args)

    def complete(self, name: str, *, start_s: Optional[float] = None,
                 dur_s: float, cat: str = "op", tid: int = TID_WALL,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete event with an explicit duration.

        ``start_s`` is in the ``time.perf_counter`` domain (defaults to
        now); ``dur_s`` may be a measured wall time or an analytic
        estimate (tag the latter via ``args={"estimated": True}``).
        """
        self.events.append({
            "name": str(name), "cat": cat, "ph": "X",
            "ts": self._rel_us(start_s), "dur": max(0.0, dur_s) * 1e6,
            "pid": 0, "tid": tid, "args": dict(args or {}),
        })

    def instant(self, name: str, cat: str = "event", tid: int = TID_WALL,
                **args: Any) -> None:
        self.events.append({
            "name": str(name), "cat": cat, "ph": "i", "s": "t",
            "ts": self._rel_us(), "pid": 0, "tid": tid,
            "args": dict(args or {}),
        })

    # -- export -----------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace event format document (JSON Object Format)."""
        meta = [{
            "name": "thread_name", "ph": "M", "ts": 0.0, "pid": 0,
            "tid": tid, "args": {"name": label},
        } for tid, label in sorted(_THREAD_NAMES.items())]
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        doc = self.to_chrome_trace()
        validate_chrome_trace(doc)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)
        return path

    def clear(self) -> None:
        self.events.clear()
        self._t0 = None

    def __len__(self) -> int:
        return len(self.events)


def validate_chrome_trace(doc: Any) -> None:
    """Raise ``ValueError`` unless ``doc`` is a loadable Chrome-trace JSON
    object: a dict whose ``traceEvents`` is a list of event dicts, each
    carrying ``name``/``ph``/``ts``/``pid``/``tid`` with the right types,
    complete ("X") events a non-negative ``dur``, and JSON-serializable
    ``args``.  The contract CI enforces on every exported trace."""
    if not isinstance(doc, dict):
        raise ValueError(f"chrome trace must be a JSON object, got "
                         f"{type(doc).__name__}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("chrome trace must carry a 'traceEvents' list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for field, types in (("name", str), ("ph", str)):
            if not isinstance(ev.get(field), types):
                raise ValueError(f"traceEvents[{i}] missing/invalid "
                                 f"{field!r}: {ev.get(field)!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}] missing/invalid 'ts'")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                raise ValueError(f"traceEvents[{i}] missing/invalid "
                                 f"{field!r}")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}] ('X') needs a "
                                 f"non-negative 'dur', got {dur!r}")
        if "args" in ev:
            try:
                json.dumps(ev["args"])
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    f"traceEvents[{i}] args not JSON-serializable: {exc}")
    # whole-document serializability (catches exotic values outside args)
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"chrome trace not JSON-serializable: {exc}")
