"""What the two conv ablation scripts share: the five main-path layers,
building a kernel's source variants, and timing on the card.

``python -m repro_torch.kernels.sparse_conv.ablate`` and
``python -m repro_torch.kernels.bsr_conv.ablate`` build variants of their
kernel's source with one part cut out (their results are wrong; only their
times count) and time each against the kernel as built, in turns (as built,
variants, variants reversed, as built), with CUDA events after a warm-up and
by the profiler's device time, at the layers ``chip_smoke.py``'s kernel
phase times: ResNet-50 res3a/1x1a,
res4b/3x3, res4b/1x1b (with its residual), res5a/3x3 and AlexNet conv2, at
batch 8 and 224 px, with weights drawn from a seed and magnitude-pruned to
each layer's sparsity.  Each also times every tile the source instantiates
(``--tiles``).  ``--act bf16`` runs the kernels' bf16 instances (rows 1c
and 2e of PERF.md): bf16 input and residual, a bf16 bank (the ELL kernel)
or bf16 tiles (the BCSR kernel), bf16 output; the variants then cut the
bf16 code paths.  They print one JSON line per (variant or tile, layer)
and the card's name and power limit.  Building needs ``nvcc`` and a card;
the variants go to ``build/kernels/ablate_<kernel>``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.kernels import _build

BATCH = 8
# --act: the activations' dtype (input, residual, output) and the bank's
ACTS = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    c: int
    h: int
    m: int
    r: int
    stride: int
    pad: int
    sparsity: float
    residual: bool

    @property
    def e(self) -> int:
        return (self.h + 2 * self.pad - self.r) // self.stride + 1


# (ResNet-50 and AlexNet at 224 px, as repro_torch.models.cnn lowers them)
LAYERS = (Layer("res3a/1x1a", 256, 56, 128, 1, 2, 0, 0.7, False),
          Layer("res4b/3x3", 256, 14, 256, 3, 1, 1, 0.7, False),
          Layer("res4b/1x1b", 256, 14, 1024, 1, 1, 0, 0.7, True),
          Layer("res5a/3x3", 512, 7, 512, 3, 1, 1, 0.7, False),
          Layer("conv2", 96, 26, 256, 5, 1, 2, 0.62, False))


def operands(layer: Layer, seed: int, device, act: str = "f32") -> dict:
    """The layer's input, dense pruned weights, bias and residual; at
    ``act`` bf16 the input and residual rounded to bf16 (the weights stay
    f32: each script rounds its bank)."""
    from repro_torch.core.pruning import magnitude_prune

    rng = np.random.default_rng(seed)
    w = magnitude_prune(rng.standard_normal(
        (layer.m, layer.c, layer.r, layer.r)).astype(np.float32),
        layer.sparsity)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    x = rng.standard_normal((BATCH, layer.c, layer.h, layer.h))
    res = (rng.standard_normal((BATCH, layer.m, layer.e, layer.e))
           if layer.residual else None)
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    return {"w": w, "x": t(x.astype(np.float32)).to(dt),
            "bias": t(rng.standard_normal(layer.m).astype(np.float32)),
            "res": None if res is None else t(res.astype(np.float32)).to(dt)}


def cut(src: str, old: str, new: str = "") -> str:
    if old not in src:
        raise ValueError(f"ablate: the source no longer holds {old!r}")
    return src.replace(old, new)


def build(kernel: str, sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Compile each variant of ``kernel`` (all at once) -> name -> library."""
    out = _build.build_dir() / f"ablate_{kernel}"
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
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in sources}


def event_ms(fn: Callable[[], torch.Tensor], reps: int) -> float:
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


def device_ms(fn: Callable[[], torch.Tensor], reps: int) -> float:
    """Device milliseconds a call: the CUDA kernels of ``reps`` calls
    summed under ``torch.profiler`` (after a warm-up call), which leaves out
    the launcher's host time that CUDA events around back-to-back calls
    measure when a kernel is shorter than its launch; 0.0 where the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def in_turns(kernel: str, libs: Dict[str, ctypes.CDLL],
             calls: Dict[str, Callable[[], torch.Tensor]],
             want: Dict[str, torch.Tensor], reps: int) -> None:
    """Time every (variant, layer) in turns and print a line each: its
    times (CUDA events; ``device_ms`` the profiler's) and its largest
    difference from the plain version."""
    times: Dict[tuple, List[float]] = {}
    dev: Dict[tuple, List[float]] = {}
    diffs: Dict[tuple, float] = {}
    for name in list(libs) + list(reversed(list(libs))):
        _build._LOADED[kernel] = libs[name]
        for layer, fn in calls.items():
            times.setdefault((name, layer), []).append(event_ms(fn, reps))
            dev.setdefault((name, layer), []).append(device_ms(fn, reps))
            diffs[(name, layer)] = float(
                (fn().float() - want[layer].float()).abs().max())
    _build._LOADED[kernel] = libs["as_built"]
    for (name, layer), ms in times.items():
        print(json.dumps({"kernel": kernel, "variant": name, "layer": layer,
                          "ms": ms, "device_ms": dev[(name, layer)],
                          "max_abs_err": diffs[(name, layer)]}),
              flush=True)


def tile_line(kernel: str, tile, layer: str, **values) -> None:
    """One line of a tile sweep: ``ms`` and ``max_abs_err``, or the
    ``reason`` the schedule refused the tile."""
    print(json.dumps({"kernel": kernel, "tile": tile, "layer": layer,
                      **values}), flush=True)


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
