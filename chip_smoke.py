#!/usr/bin/env python3
"""Drive the PyTorch port's pruned-CNN inference path on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):

1. build   -- compile every CUDA kernel of ``src/repro_torch/kernels/*/csrc``
              into ``build/kernels/`` (one ``nvcc`` per source, all started
              together) and print the card's name and power limit.
2. kernels -- each kernel against its plain PyTorch version at main-path
              shapes (ResNet-50 res3a/1x1a, res4b/3x3, res4b/1x1b with its
              residual tail, res5a/3x3; AlexNet conv2), batch 8 at 224 px:
              one JSON line per (kernel, layer) with ``max_abs_err``,
              ``kernel_ms`` (CUDA events over back-to-back launches, after a
              warm-up, L2 warm), ``plain_ms``, ``library_ms`` (``F.conv2d``
              with bias on the dense pruned weights, TF32 off; a yardstick the
              port never calls) and ``bound_ms`` (the larger of the bytes the
              conv must move over 3.35 TB/s and its f32 operations over
              67 TFLOP/s, H100 SXM data sheet).  The bytes count the input
              elements the conv reads, not the padded copy the wrapper
              builds (a stride-2 1x1 conv reads a quarter of its input),
              the weights, bias and residual once, and the output once.
3. path    -- ResNet-50, GoogLeNet and AlexNet at full width, random pruned
              weights from ``--seed``, through ``cnn_forward`` with
              ``pallas``, ``bsr`` and ``dense``.  For each net and kernel
              method the launch counters are set to 0, one forward runs, and
              the counts must equal the net's sparse conv layers (39 / 49 /
              4): every sparse layer runs its kernel.  Both kernel methods
              must agree with ``dense`` within rtol = 1e-4 of the output's
              largest magnitude, and give finite (batch, 1000) logits.
              Each (net, method) line carries the forward time (host clock
              over 3 synchronised forwards) and, from one forward under
              ``torch.profiler``, the device's busy time, its idle share of
              the unprofiled forward time, and the kernels that took the
              most device time.
4. the ``kernels`` JSON line, then the device line last.

Tolerances against the plain versions: the ELL kernel rounds each multiply
and add as its plain version does, in the same order, so it is held to
1e-5; the BCSR kernel sums in another order than the plain version's library
contraction and is held to rtol = atol = 1e-4.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 without tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
EXPECTED_SPARSE = {"resnet50": 39, "googlenet": 49, "alexnet": 4}
KERNEL_LAYERS = [("resnet50", "res3a/1x1a"), ("resnet50", "res4b/3x3"),
                 ("resnet50", "res4b/1x1b"), ("resnet50", "res5a/3x3"),
                 ("alexnet", "conv2")]
BATCH = 8
IMAGE = 224
ELL_TOL = 1e-5
BSR_TOL = 1e-4
PATH_RTOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_cuda(torch, fn, reps: int, warmup: int) -> float:
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls after ``warmup`` calls."""
    for _ in range(warmup):
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_bytes(op, w, batch: int) -> int:
    """f32 bytes the conv itself must move, apart from its weights: the input
    elements it reads once (the unpadded input's channels that hold a nonzero
    weight, at the rows and columns some output reaches through a tap that
    holds one; a strided 1x1 conv reads only every stride-th row and column),
    the bias and the residual once, and the output once."""
    nz = w != 0
    chans = int(nz.any(dim=3).any(dim=2).any(dim=0).sum())
    taps_r = nz.any(dim=3).any(dim=1).any(dim=0).nonzero().flatten().tolist()
    taps_s = nz.any(dim=2).any(dim=1).any(dim=0).nonzero().flatten().tolist()
    rows = {e * op.stride + r - op.pad for e in range(op.e) for r in taps_r}
    cols = {f * op.stride + s - op.pad for f in range(op.f) for s in taps_s}
    rows = sum(0 <= i < op.h for i in rows)
    cols = sum(0 <= j < op.w for j in cols)
    out = batch * op.m * op.e * op.f
    return 4 * (batch * chans * rows * cols + op.m
                + (out if op.res is not None else 0) + out)


def device_breakdown(torch, fn, forward_ms: float, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time summed over
    the CUDA kernels it ran (one stream, so the sum is the busy time), the
    idle share of an unprofiled forward of ``forward_ms`` (the profiler's own
    host overhead would inflate a profiled wall time), and the kernels that
    took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return {"device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / forward_ms),
            "kernel_launches": sum(k[2] for k in kernels),
            "top_kernels": [[name[:60], ms, n] for name, ms, n in kernels[:top]]}


def kernel_phase(torch, mods, nets, device, batch, seed):
    """Each kernel against its plain version at the listed layers; returns
    per-kernel lists of row dicts."""
    F = torch.nn.functional
    np = mods["np"]
    ops_ell, ops_bsr = mods["ops_ell"], mods["ops_bsr"]
    rows = {"sparse_conv": [], "bsr_conv": []}
    rng = np.random.default_rng(seed + 1)
    for net_name, layer in KERNEL_LAYERS:
        program, params = nets[net_name]
        op = {o.name: o for o in program.conv_ops}[layer]
        entry = params[layer]
        x = torch.from_numpy(rng.standard_normal(
            (batch, op.c, op.h, op.w)).astype(np.float32)).to(device)
        bias = torch.from_numpy(
            rng.standard_normal(op.m).astype(np.float32)).to(device)
        res = None
        if op.res is not None:
            res = torch.from_numpy(rng.standard_normal(
                (batch, op.m, op.e, op.f)).astype(np.float32)).to(device)
        xpad = mods["pad_in"](x, op.pad)
        w = entry["w"]

        def library():
            return F.conv2d(x, w, bias, stride=op.stride, padding=op.pad)

        library_ms = time_cuda(torch, library, reps=20, warmup=3)

        # -- ELL direct sparse conv --------------------------------------
        ell = entry["ell"]
        sched, reason = ops_ell.resolve_schedule(op.m, ell.k, op.e, op.f)
        check(sched is not None, f"{layer}: no ELL schedule ({reason})")
        tm, tp, ks = sched
        packed = ops_ell.pack_indices(ell)
        args = (xpad, ell.value, packed, ell.nnz, bias, res)
        kw = dict(rs=op.k * op.k, s=op.k, e=op.e, f=op.f, stride=op.stride,
                  fuse_relu=op.fuse_relu)
        got = mods["ell_kernel"](*args, tm=tm, tp=tp, ks=ks, **kw)
        torch.cuda.synchronize()
        want = mods["ell_plain"](*args, **kw)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"{layer}: ELL kernel not finite")
        check(err <= ELL_TOL * (1 + scale),
              f"{layer}: ELL kernel disagrees with its plain version "
              f"(max_abs_err {err}, tolerance {ELL_TOL}*(1+{scale}))")
        ms = time_cuda(torch, lambda: mods["ell_kernel"](
            *args, tm=tm, tp=tp, ks=ks, **kw), reps=20, warmup=3)
        plain_ms = time_cuda(torch, lambda: mods["ell_plain"](*args, **kw),
                             reps=2, warmup=1)
        nnz_total = int(ell.nnz.sum())
        act_bytes = conv_bytes(op, w, batch)
        moved = act_bytes + nnz_total * 8 + ell.nnz.numel() * 4
        b_ms, b_by = bound(moved, 2.0 * nnz_total * batch * op.e * op.f)
        row = {"kernel": "sparse_conv", "net": net_name, "layer": layer,
               "shape": {"n": batch, "c": op.c, "h": op.h, "m": op.m,
                         "k": op.k, "stride": op.stride, "pad": op.pad,
                         "nnz": nnz_total, "K": ell.k, "residual":
                         res is not None},
               "schedule": {"tm": tm, "tp": tp, "ks": ks},
               "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_bytes": moved}
        print(json.dumps(row), flush=True)
        rows["sparse_conv"].append(row)

        # -- BCSR block-sparse conv --------------------------------------
        bc = mods["bcsr_from_dense"](w.cpu().numpy(), block=mods["block"],
                                     device=device)
        gbm, kb_dim, bm, bn = bc.blocks.shape
        sched, reason = ops_bsr.resolve_bsr_schedule(bm, bn, op.e, op.f)
        check(sched is not None, f"{layer}: no BCSR schedule ({reason})")
        (tp,) = sched
        mpad = gbm * bm
        bpad = torch.zeros(mpad, device=device)
        bpad[:op.m] = bias
        rpad = None
        if res is not None:
            rpad = torch.zeros((batch, mpad, op.e, op.f), device=device)
            rpad[:, :op.m] = res
        bargs = (xpad, bc.blocks, bc.blockcol, bc.nblocks, bpad, rpad)
        got = mods["bsr_kernel"](*bargs, tp=tp, **kw)
        torch.cuda.synchronize()
        want = mods["bsr_plain"](*bargs, **kw)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"{layer}: BCSR kernel not finite")
        check(err <= BSR_TOL * (1 + scale),
              f"{layer}: BCSR kernel disagrees with its plain version "
              f"(max_abs_err {err}, tolerance {BSR_TOL}*(1+{scale}))")
        ms = time_cuda(torch, lambda: mods["bsr_kernel"](*bargs, tp=tp, **kw),
                       reps=20, warmup=3)
        plain_ms = time_cuda(torch, lambda: mods["bsr_plain"](*bargs, **kw),
                             reps=2, warmup=1)
        kept = int(bc.nblocks.sum())
        moved = act_bytes + kept * bm * bn * 4 + kept * 4 + gbm * 4
        b_ms, b_by = bound(moved, 2.0 * kept * bm * bn * batch * op.e * op.f)
        row = {"kernel": "bsr_conv", "net": net_name, "layer": layer,
               "shape": {"n": batch, "c": op.c, "h": op.h, "m": op.m,
                         "k": op.k, "stride": op.stride, "pad": op.pad,
                         "block": [bm, bn], "kept_tiles": kept,
                         "tiles": gbm * (-(-op.c * op.k * op.k // bn)),
                         "residual": res is not None},
               "schedule": {"tp": tp},
               "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_bytes": moved}
        print(json.dumps(row), flush=True)
        rows["bsr_conv"].append(row)
    return rows


def path_phase(torch, mods, nets, device, batch, image, seed):
    """Full-width forwards through ``cnn_forward``; returns launches per
    kernel over the counted forwards."""
    np = mods["np"]
    cnn = mods["cnn"]
    ell_k, bsr_k = mods["ell_kernel"], mods["bsr_kernel"]
    launches = {"sparse_conv": 0, "bsr_conv": 0}
    rng = np.random.default_rng(seed + 2)
    for net_name in ("resnet50", "googlenet", "alexnet"):
        program, params = nets[net_name]
        net = cnn.NETWORKS[net_name]()
        sparse = [op for op in program.conv_ops if op.sparsity > 0]
        check(len(sparse) == EXPECTED_SPARSE[net_name],
              f"{net_name}: {len(sparse)} sparse convs, expected "
              f"{EXPECTED_SPARSE[net_name]}")
        x = torch.from_numpy(rng.standard_normal(
            (batch, 3, image, image)).astype(np.float32)).to(device)
        out = {}
        for method in ("dense", "pallas", "bsr"):
            # warm-up: cuDNN's algorithm choice and the BCSR banks, built
            # once per layer on first use, stay out of the counted forward
            cnn.cnn_forward(net, params, x, method)
            torch.cuda.synchronize()
            ell_k.launches = 0
            bsr_k.launches = 0
            y = cnn.cnn_forward(net, params, x, method)
            torch.cuda.synchronize()
            counts = {"sparse_conv": ell_k.launches,
                      "bsr_conv": bsr_k.launches}
            want = {"dense": {"sparse_conv": 0, "bsr_conv": 0},
                    "pallas": {"sparse_conv": len(sparse), "bsr_conv": 0},
                    "bsr": {"sparse_conv": 0, "bsr_conv": len(sparse)}}[method]
            check(counts == want, f"{net_name}/{method}: kernel launches "
                  f"{counts}, expected {want}")
            for name in launches:
                launches[name] += counts[name]
            check(tuple(y.shape) == (batch, 1000),
                  f"{net_name}/{method}: output shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()),
                  f"{net_name}/{method}: non-finite output")
            t0 = time.perf_counter()
            reps = 3
            for _ in range(reps):
                cnn.cnn_forward(net, params, x, method)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) / reps * 1e3
            out[method] = y
            row = {"phase": "path", "net": net_name, "method": method,
                   "batch": batch, "image": image, "launches": counts,
                   "forward_ms": fwd_ms}
            row.update(device_breakdown(
                torch, lambda: cnn.cnn_forward(net, params, x, method),
                fwd_ms))
            if method != "dense":
                err = float((y - out["dense"]).abs().max())
                scale = float(out["dense"].abs().max())
                row.update(max_abs_err_vs_dense=err, dense_absmax=scale)
                check(err <= PATH_RTOL * max(1.0, scale),
                      f"{net_name}/{method}: disagrees with dense "
                      f"(max_abs_err {err}, tolerance {PATH_RTOL}*"
                      f"max(1, {scale}))")
            print(json.dumps(row), flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.core.direct_conv import pad_in
    from repro_torch.core.sparse_format import bcsr_conv_from_dense
    from repro_torch.engine.engine import DEFAULT_BSR_BLOCK
    from repro_torch.engine.lower import lower
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_conv import ops as ops_bsr
    from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel
    from repro_torch.kernels.bsr_conv.ref import bsr_conv_plain
    from repro_torch.kernels.sparse_conv import ops as ops_ell
    from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel
    from repro_torch.kernels.sparse_conv.ref import sparse_conv_plain
    from repro_torch.models import cnn

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "libraries": {k: os.path.relpath(str(v), ROOT)
                                    for k, v in paths.items()}}), flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    mods = dict(np=np, cnn=cnn, pad_in=pad_in, ops_ell=ops_ell,
                ops_bsr=ops_bsr, ell_kernel=sparse_conv_kernel,
                ell_plain=sparse_conv_plain, bsr_kernel=bsr_conv_kernel,
                bsr_plain=bsr_conv_plain,
                bcsr_from_dense=bcsr_conv_from_dense,
                block=DEFAULT_BSR_BLOCK)
    nets = {}
    for i, name in enumerate(("resnet50", "googlenet", "alexnet")):
        net = cnn.NETWORKS[name]()
        params = cnn.init_cnn(net, 3, np.random.default_rng(args.seed + i),
                              IMAGE)
        nets[name] = (lower(net, (3, IMAGE, IMAGE)), params)

    try:
        rows = kernel_phase(torch, mods, nets, device, BATCH, args.seed)
        launches = path_phase(torch, mods, nets, device, BATCH,
                              IMAGE, args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "sparse_conv": ("src/repro_torch/kernels/sparse_conv/csrc/sparse_conv.cu",
                        "src/repro/kernels/sparse_conv/kernel.py:213"),
        "bsr_conv": ("src/repro_torch/kernels/bsr_conv/csrc/bsr_conv.cu",
                     "src/repro/kernels/bsr_conv/kernel.py:155"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        rs = rows[name]
        b_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] == "bytes")
        b_ops = sum(r["bound_ms"] for r in rs if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["kernel_ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": b_bytes + b_ops,
            "bound_by": "bytes" if b_bytes > b_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            "times_are": "sums over the kernel phase's "
                         f"{len(rs)} main-path layers, batch {BATCH}",
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
