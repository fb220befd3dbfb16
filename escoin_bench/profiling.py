"""A profiled slice of a run: the device's operations, its busy time and
its idle gaps, from ``torch.profiler``'s trace.

The trace is written to a temporary file (under ``TMPDIR``), read back and
deleted.  Device operations are the trace's kernels, copies and sets.  Each
kernel keeps the name of the host op that launched it (the trace's
``External id``), so a library call's kernels can be told apart from the
port's own.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, str]]     # (name, seconds, host op)
    gaps: List[Tuple[str, float]]   # the longest: (host op then, s)

    def seconds_where(self, keep: Callable[[str, str], bool]) -> float:
        return sum(d for name, d, op in self.kernels if keep(name, op))

    def breakdown(self) -> Dict[str, List[List]]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for name, d, _ in self.kernels:
            by_name[name[:NAME_CHARS]] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def parse(events: List[Dict], window_s: float) -> Trace:
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS]
    by_ext = {}
    for e in host:
        ext = (e.get("args") or {}).get("External id")
        if ext is not None and e.get("cat") == "cpu_op":
            # the innermost op: the shortest with that id
            if ext not in by_ext or e["dur"] < by_ext[ext]["dur"]:
                by_ext[ext] = e
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    kernels = []
    for e in dev:
        op = by_ext.get((e.get("args") or {}).get("External id"))
        kernels.append((e["name"], e["dur"] * 1e-6,
                        op["name"] if op is not None else ""))
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    spans = sorted(((end, start) for (_, end), (start, _)
                    in zip(busy, busy[1:])), key=lambda g: g[0] - g[1])
    gaps = []
    for end, start in spans[:10]:       # the longest, labelled
        mid = (end + start) / 2
        around = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        label = (min(around, key=lambda e: e["dur"])["name"] if around
                 else "host outside any op")
        gaps.append((label, (start - end) * 1e-6))
    return Trace(window_s=window_s,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernels=kernels, gaps=gaps)


def profiled(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` (which ends with the device idle) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return parse(events, window_s)


def launched_by(trace: Optional[Trace], ops: Tuple[str, ...]) -> float:
    """Device seconds of the kernels that host ops named ``ops`` launched."""
    if trace is None:
        return 0.0
    return trace.seconds_where(lambda name, op: op in ops)


def named(trace: Optional[Trace], part: str) -> float:
    """Device seconds of the kernels whose names hold ``part``."""
    if trace is None:
        return 0.0
    return trace.seconds_where(lambda name, op: part in name)
