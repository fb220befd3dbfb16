"""Where the flash kernels spend their time, on the card.

Builds variants of ``csrc/flash_attention.cu`` with one part cut out (their
results are wrong; only their times count) or with other chunk or ring
depths, and times each against the kernels as built, in turns (as built,
variants, variants reversed, as built), with CUDA events after a warm-up::

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate \
        [--shape prefill|train_4k] [--reps 10]
    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate \
        --f32 [--fma-source PATH] [--variants NAME ...] [--reps 10]

bf16 (the default): the tensor-core forward and dK/dV at prefill (B 4,
H 32, KV 4, T 2048) or train_4k (B 1, H 32, KV 4, T 4096), causal, d 128,
on the model's (B, T, H, d) layout.  Variants:

* ``no_wgmma``: no wgmma issued (softmax, split and staging only);
* ``no_loads``: no cp.async after the first stages (stale tiles);
* ``no_softmax``: the forward's softmax replaced by alpha = sum = 1;
* ``fast_exp``: ``exp2f`` replaced by the bare ``ex2.approx.ftz``;
* ``stages3``: both rings one stage deeper.

``--f32``: the split-TF32 dQ and dK/dV at HuBERT-XLarge's shape (B 1,
H = KV = 16, T 2048, d 80, bidirectional), Phi-3-Vision's (B 1, H = KV =
32, T 2048, d 96, causal) and B 1, H 32, KV 4, T 2048, d 128, causal, each
first held to the plain backward (max |error| within 1e-4 of the largest
|plain|).  Variants:

* ``no_wgmma``: no wgmma issued (the split passes, fragments, softmax and
  copies only);
* ``no_lo``: one product a step (a_hi b_hi), the price of the split;
* ``no_loads``: no copies after the first chunk (stale tiles);
* ``no_split``: no split pass over the copied tiles;
* ``chunk32``: 32-key (dQ) and 32-row (dK/dV) chunks at every head dim;
* ``rna_split``: the halves rounded by cvt.rna.tf32.f32, hi = tf32(x) (also
  stored over the copied tile) and lo = tf32(x - hi), where the kernels
  take the word itself as hi (the tensor cores ignore its low 13 bits) and
  lo = x - hi's top 19 bits.

Every variant is checked as the kernels are (its error printed; only the
kernels as built must pass).

``--fma-source``: a ``flash_attention.cu`` whose ``flash_attention_bwd_dq``
and ``flash_attention_bwd_dkv`` entries launch the FMA backward kernels (the
tree before the split-TF32 kernels, unpacked with ``git archive``), built
and timed in the same turns, on the same operands.

Prints one JSON line per (variant, kernel, shape) and the card's name and
power limit.  Needs a card and ``nvcc``; builds into
``build/kernels/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fk

SHAPES = {"prefill": (4, 32, 4, 2048, 128), "train_4k": (1, 32, 4, 4096, 128)}
# --f32: (B, H, KV, T = S, d, causal)
F32_SHAPES = {"hubert_d80": (1, 16, 16, 2048, 80, False),
              "phi3_d96": (1, 32, 32, 2048, 96, True),
              "gqa_d128": (1, 32, 4, 2048, 128, True)}
F32_TOL = 1e-4   # x max |plain|, chip_smoke.py's FLASH_F32_TOL
# the FMA backward's C entries, as the tree before the split-TF32 kernels
# declares them: (pointer operands, strided operands)
FMA_SYMBOLS = {"flash_attention_bwd_dq": (7, 5),
               "flash_attention_bwd_dkv": (8, 6)}


def _cut(src: str, old: str, new: str = "") -> str:
    if old not in src:
        raise ValueError(f"ablate: the source no longer holds {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """Variant name -> source text."""
    no_wgmma = src
    for line in ("    scores_tc<D>(s, qtile + wg * TB, ktile + st);\n",
                 "    split_product<D>(acc, hi, lo, vtile + st);\n",
                 "    split_product<D>(acc, hi, lo, (wg == 0 ? dotile : qtile)"
                 " + sidx * TB);\n"):
        no_wgmma = _cut(no_wgmma, line)
    no_wgmma = _cut(_cut(no_wgmma,
                         "      scores_tc<D>(x, ktile, qtile + sidx * TB);\n",
                         "      ;\n"),
                    "      scores_tc<D>(x, vtile, dotile + sidx * TB);\n",
                    "      ;\n")
    no_loads = _cut(_cut(src, "    load_chunk(j + FWD_STAGES - 1);\n",
                         "    cp_commit();\n"),
                    "    stage(qc + DKV_STAGES - 1);\n", "    cp_commit();\n")
    start = src.index("__device__ __forceinline__ void softmax_chunk(")
    body = src.index("{", start) + 1
    end = src.index("\n}\n", body) + 3
    no_softmax = (src[:body] + "\n  alpha[0] = alpha[1] = 1.f;"
                  " sum[0] = sum[1] = 1.f;\n}\n" + src[end:])
    deeper = re.sub(r"constexpr int (FWD|DKV)_STAGES = (\d+);",
                    lambda m: f"constexpr int {m.group(1)}_STAGES = "
                              f"{int(m.group(2)) + 1};", src)
    return {"no_wgmma": no_wgmma, "no_loads": no_loads,
            "no_softmax": no_softmax,
            "fast_exp": src.replace("exp2f(", "exp2f_fast("),
            "stages3": deeper}


def f32_variants(src: str) -> dict:
    """--f32 variant name -> source text."""
    three = ("  wgmma_tf32(d, ah, bh, scale_d);\n"
             "  wgmma_tf32(d, ah, bl, 1);\n"
             "  wgmma_tf32(d, al, bh, 1);\n")
    lo = ("  wgmma_tf32(d, ah, bl, 1);\n"
          "  wgmma_tf32(d, al, bh, 1);\n")
    no_loads = _cut(_cut(src, "    load_chunk(j + 1);\n", "    cp_commit();\n"),
                    "    stage(qc + 1);\n", "    cp_commit();\n")
    return {"no_wgmma": _cut(src, three),
            "no_lo": _cut(src, lo),
            "no_loads": no_loads,
            "no_split": _cut(src, "  for (int i = tid; i < L * (D / 4); "
                                  "i += nthreads) {\n",
                             "  for (int i = tid; i < 0; i += nthreads) {\n"),
            "chunk32": _cut(src, "  return d <= 80 ? 64 : 32;\n",
                            "  return 32;\n"),
            "rna_split": _cut(_cut(
                src, "  hi = __float_as_uint(x);\n"
                     "  lo = __float_as_uint(x - __uint_as_float(hi & "
                     "0xFFFFE000u));\n",
                "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
                "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo)\n"
                "      : \"f\"(x - __uint_as_float(hi)));\n"),
                "    *reinterpret_cast<uint4*>(nl + w) = make_uint4(lo[0], lo[1], "
                "lo[2], lo[3]);\n",
                "    *reinterpret_cast<uint4*>(nh + w) = make_uint4(hi[0], hi[1], "
                "hi[2], hi[3]);\n"
                "    *reinterpret_cast<uint4*>(nl + w) = make_uint4(lo[0], lo[1], "
                "lo[2], lo[3]);\n")}


FAST_EXP = ("__device__ __forceinline__ float exp2f_fast(float x) {\n"
            "  float y;\n"
            "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
            "  return y;\n}\n")


def build(sources: dict) -> dict:
    """Compile each variant (all at once) -> name -> loaded library."""
    out = _build.build_dir() / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.nvcc_path(), {}
    for name, text in sources.items():
        if name == "fast_exp":
            text = text.replace("namespace {\n", "namespace {\n" + FAST_EXP, 1)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate: {name} failed to build:\n{log}")
        BUILD_LOGS[name] = log
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


# each variant's nvcc output (ptxas's registers and spills), by name
BUILD_LOGS = {}


def ptxas_lines(log: str, needle: str):
    """(kernel, report line) for each kernel whose name holds ``needle``:
    its registers and any spill."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else None
        elif kernel and needle in kernel and (
                "registers" in line or ("spill" in line
                                        and " 0 bytes spill stores" not in line)):
            yield kernel, line.strip()


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


def _fma_fn(lib, symbol: str):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        pointers, strided = FMA_SYMBOLS[symbol]
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * (3 * strided)
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fma_calls(lib, q, k, v, do, lse, delta, sc, causal):
    """The FMA dQ and dK/dV of an older tree's library on the operands:
    kernel name -> a call that launches it."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sizes = (b, h, kv, t, s, d)
    stream = torch.cuda.current_stream().cuda_stream

    def strides(*xs):
        return [st for x in xs for st in x.stride()[:3]]

    def run_dq():
        _build.check(_fma_fn(lib, "flash_attention_bwd_dq")(
            *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)), *sizes,
            *strides(q, k, v, do, dq), float(sc), int(causal), 0, stream),
            "fma dq")

    def run_dkv():
        _build.check(_fma_fn(lib, "flash_attention_bwd_dkv")(
            *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)),
            *sizes, *strides(q, k, v, do, dk, dv), float(sc), int(causal),
            0, stream), "fma dkv")

    return {"flash_bwd_dq": run_dq, "flash_bwd_dkv": run_dkv}, (dq, dk, dv)


def f32_main(args) -> int:
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain)

    src = _build.SOURCES["flash_attention"].read_text()
    libs = {"as_built": _build.load("flash_attention")}
    BUILD_LOGS["as_built"] = _build.BUILD_LOGS.get("flash_attention", "")
    sources = f32_variants(src)
    if args.variants is not None:
        sources = {n: sources[n] for n in args.variants}
    if args.fma_source:
        sources["fma_parent"] = open(args.fma_source).read()
    libs.update(build(sources))
    fma = libs.pop("fma_parent", None)
    for name, log in BUILD_LOGS.items():
        for kernel, line in ptxas_lines(log, "tf32_kernel"):
            print(json.dumps({"variant": name, "ptxas": kernel[-48:],
                              "report": line}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = [n for n in args.f32_shapes]
    for shape_name in names:
        b, h, kv, t, d, causal = F32_SHAPES[shape_name]
        q, k, v, do = (torch.randn((b, t, n, d), generator=gen, device=dev)
                       .transpose(1, 2) for n in (h, kv, kv, h))
        sc = d ** -0.5
        _build._LOADED["flash_attention"] = libs["as_built"]
        o, lse = fk.flash_attention_fwd(q, k, v, sc=sc, causal=causal)
        delta = fk.bwd_delta(o, do)
        calls = {"flash_bwd_dq_tf32": lambda: fk.flash_attention_bwd_dq(
                     q, k, v, do, lse, delta, sc=sc, causal=causal),
                 "flash_bwd_dkv_tf32": lambda: fk.flash_attention_bwd_dkv(
                     q, k, v, do, lse, delta, sc=sc, causal=causal)}
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, sc=sc,
                                         causal=causal)
        for name, lib in libs.items():
            _build._LOADED["flash_attention"] = lib
            got = (calls["flash_bwd_dq_tf32"](),
                   *calls["flash_bwd_dkv_tf32"]())
            errs = {part: float((g - w).abs().max() / w.abs().max())
                    for part, g, w in zip(("dq", "dk", "dv"), got, want)}
            print(json.dumps({"shape": shape_name, "check": name,
                              "err_over_max": errs, "tol": F32_TOL,
                              "ok": all(e <= F32_TOL
                                        for e in errs.values())}),
                  flush=True)
        _build._LOADED["flash_attention"] = libs["as_built"]
        if fma is not None:
            fma_runs, fma_out = fma_calls(fma, q, k, v, do, lse, delta, sc,
                                          causal)
            for run in fma_runs.values():
                run()
            torch.cuda.synchronize()
            print(json.dumps({"shape": shape_name, "check": "fma_parent",
                              "err_over_max": {
                                  name: float((g - w).abs().max()
                                              / w.abs().max())
                                  for name, g, w in zip(("dq", "dk", "dv"),
                                                        fma_out, want)}}),
                  flush=True)
        del got, want
        times = {}
        order = list(libs) + (["fma_parent"] if fma is not None else [])
        for name in order + order[::-1]:
            if name == "fma_parent":
                for kernel, fn in fma_runs.items():
                    times.setdefault((name, kernel), []).append(
                        event_ms(fn, args.reps))
                continue
            _build._LOADED["flash_attention"] = libs[name]
            for kernel, fn in calls.items():
                times.setdefault((name, kernel), []).append(
                    event_ms(fn, args.reps))
        _build._LOADED["flash_attention"] = libs["as_built"]
        for (name, kernel), ms in times.items():
            print(json.dumps({"variant": name, "kernel": kernel,
                              "shape": shape_name, "ms": ms}), flush=True)
        if fma is not None:
            print(json.dumps({"shape": shape_name, "pair_ms": {
                name: sum(min(times[(name, kern)]) for kern in kerns)
                for name, kerns in (
                    ("as_built", calls), ("fma_parent", fma_runs))}}),
                  flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--f32", action="store_true",
                    help="the split-TF32 dQ and dK/dV (f32 operands)")
    ap.add_argument("--f32-shapes", nargs="+", choices=sorted(F32_SHAPES),
                    default=list(F32_SHAPES))
    ap.add_argument("--variants", nargs="*", default=None,
                    help="--f32: the variants to build (default: all)")
    ap.add_argument("--fma-source", default=None,
                    help="--f32: an older tree's flash_attention.cu whose "
                         "f32 backward entries are the FMA kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    if args.f32:
        code = f32_main(args)
    else:
        code = bf16_main(args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return code


def bf16_main(args) -> int:
    src = _build.SOURCES["flash_attention"].read_text()
    libs = {"as_built": _build.load("flash_attention")}
    libs.update(build(variants(src)))
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    b, h, kv, t, d = SHAPES[args.shape]
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((b, t, n, d), generator=gen, device=dev)
                   .to(bf16).transpose(1, 2) for n in (h, kv, kv, h))
    sc = d ** -0.5
    o, lse = fk.flash_attention_fwd(q, k, v, sc=sc, causal=True)
    delta = fk.bwd_delta(o, do)
    calls = {"flash_fwd_tc": lambda: fk.flash_attention_fwd(
                 q, k, v, sc=sc, causal=True),
             "flash_bwd_dkv_tc": lambda: fk.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, sc=sc, causal=True)}
    times = {}
    order = list(libs) + list(reversed(list(libs)))
    for name in order:
        _build._LOADED["flash_attention"] = libs[name]
        for kernel, fn in calls.items():
            times.setdefault((name, kernel), []).append(
                event_ms(fn, args.reps))
    _build._LOADED["flash_attention"] = libs["as_built"]
    for (name, kernel), ms in times.items():
        print(json.dumps({"variant": name, "kernel": kernel,
                          "shape": args.shape, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
