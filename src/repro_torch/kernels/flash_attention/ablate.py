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

``--f32``: the split-TF32 forward, dQ and dK/dV at HuBERT-XLarge's shape
(B 1, H = KV = 16, T 2048, d 80, bidirectional), Phi-3-Vision's (B 1, H =
KV = 32, T 2048, d 96, causal) and B 1, H 32, KV 4, T 2048, d 128, causal,
each first held to the plain forward and backward (O, dQ, dK and dV: max
|error| within 1e-4 of the largest |plain|; lse within 1e-4).  Variants:

* ``no_wgmma``: no wgmma issued (the split passes, fragments, softmax and
  copies only);
* ``no_lo``: one product a step (a_hi b_hi), the price of the split;
* ``no_loads``: no copies after the first chunk (stale tiles);
* ``no_split``: no split pass over the copied tiles;
* ``chunk32``: 32-key (the forward, dQ) and 32-row (dK/dV) chunks at every
  head dim;
* ``in_place``: the forward's O rescaled in place and summed into by the
  products (scale_d 1 throughout, D / 2 registers a thread fewer), where
  the kernel as built sums each chunk's p V into a fresh partial and adds
  it with rounded f32 adds;
* ``rna_split``: the halves rounded by cvt.rna.tf32.f32, hi = tf32(x) (also
  stored over the copied tile) and lo = tf32(x - hi), where the kernels
  take the word itself as hi (the tensor cores ignore its low 13 bits) and
  lo = x - hi's top 19 bits.

Every variant is checked as the kernels are (its error printed; only the
kernels as built must pass).

``--fma-source``: an older tree's ``flash_attention.cu`` (unpacked with
``git archive``), built and timed in the same turns, on the same operands,
for each of its f32 kernels that is still the FMA design: its forward
(``flash_fwd_kernel``) and its dQ and dK/dV (``flash_bwd_dq_kernel``,
``flash_bwd_dkv_kernel``), each where the source holds it.

``--against PATH``: another tree's ``flash_attention.cu`` (one with the
same C entries), built beside the source as built; at head dims 24, 80,
96 and 128 (``AGAINST_DIMS``), bf16 and f32, causal and full,
the forward, dQ and dK/dV of both on the same operands (B 1, H 16, KV 4,
a ragged T of 1000), held bit for bit (O, lse, dQ, dK, dV), then timed in
turns (as built, against, against, as built)::

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate \
        --against build/parent/src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu

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
# the FMA kernels' C entries, as the trees that hold them declare them:
# (pointer operands, strided operands)
FMA_SYMBOLS = {"flash_attention_fwd": (5, 4),
               "flash_attention_bwd_dq": (7, 5),
               "flash_attention_bwd_dkv": (8, 6)}
# an FMA kernel of an older tree -> the kernel as built that replaced it
FMA_PAIRS = {"flash_fwd": "flash_fwd_tf32",
             "flash_bwd_dq": "flash_bwd_dq_tf32",
             "flash_bwd_dkv": "flash_bwd_dkv_tf32"}


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
            "in_place": _cut(_cut(_cut(
                src, "    float part[D / 2];\n"
                     "    chunk_product<D, L>(part, s, smem_u32(VTh), "
                     "smem_u32(VTl));\n"
                     "#pragma unroll\n"
                     "    for (int i = 0; i < D / 2; ++i)\n"
                     "      acc[i] = __fadd_rn(acc[i] * alpha[(i >> 1) & 1], "
                     "part[i]);\n",
                "#pragma unroll\n"
                "    for (int i = 0; i < D / 2; ++i) acc[i] *= "
                "alpha[(i >> 1) & 1];\n"
                "    chunk_product<D, L, true>(acc, s, smem_u32(VTh), "
                "smem_u32(VTl));\n"),
                "template <int D, int L>\n"
                "__device__ __forceinline__ void chunk_product(",
                "template <int D, int L, bool ADD = false>\n"
                "__device__ __forceinline__ void chunk_product("),
                "         n8 > 0);\n", "         ADD || n8 > 0);\n"),
            "rna_split": _cut(_cut(
                src, "  hi = __float_as_uint(x);\n"
                     "  lo = __float_as_uint(x - __uint_as_float(hi & "
                     "0xFFFFE000u));\n",
                "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
                "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo)\n"
                "      : \"f\"(x - __uint_as_float(hi)));\n"),
                "    if constexpr (LO)\n",
                "    *reinterpret_cast<uint4*>(nh + w) = make_uint4(hi[0], hi[1], "
                "hi[2], hi[3]);\n"
                "    if constexpr (LO)\n")}


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


def fma_calls(lib, src, q, k, v, do, lse, delta, sc, causal):
    """The FMA kernels of an older tree's library (``src`` its source) on
    the operands: kernel name -> a call that launches it, and their
    outputs by name (o, lse, dq, dk, dv)."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    o, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sizes = (b, h, kv, t, s, d)
    stream = torch.cuda.current_stream().cuda_stream

    def strides(*xs):
        return [st for x in xs for st in x.stride()[:3]]

    def run_fwd():
        _build.check(_fma_fn(lib, "flash_attention_fwd")(
            *(x.data_ptr() for x in (q, k, v, o, lse_out)), *sizes,
            *strides(q, k, v, o), float(sc), int(causal), 0, stream),
            "fma fwd")

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

    runs, outs = {}, {}
    if "flash_fwd_kernel(" in src:
        runs["flash_fwd"] = run_fwd
        outs.update(o=o, lse=lse_out)
    if "flash_bwd_dq_kernel(" in src:
        runs.update(flash_bwd_dq=run_dq, flash_bwd_dkv=run_dkv)
        outs.update(dq=dq, dk=dk, dv=dv)
    return runs, outs


def f32_main(args) -> int:
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)

    src = _build.SOURCES["flash_attention"].read_text()
    libs = {"as_built": _build.load("flash_attention")}
    BUILD_LOGS["as_built"] = _build.BUILD_LOGS.get("flash_attention", "")
    sources = f32_variants(src)
    if args.variants is not None:
        sources = {n: sources[n] for n in args.variants}
    fma_src = open(args.fma_source).read() if args.fma_source else None
    if fma_src is not None:
        sources["fma_parent"] = fma_src
    libs.update(build(sources))
    fma = libs.pop("fma_parent", None)
    for name, log in BUILD_LOGS.items():
        for kernel, line in ptxas_lines(log, "tf32_kernel"):
            # the kernel and its head dim, from the mangled name
            dim = re.search(r"ILi(\d+)EE", kernel)
            print(json.dumps({"variant": name,
                              "ptxas": kernel.split("tf32_kernel")[0][-16:]
                              + "tf32_kernel",
                              "d": int(dim.group(1)) if dim else None,
                              "report": line}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape_name in args.f32_shapes:
        b, h, kv, t, d, causal = F32_SHAPES[shape_name]
        q, k, v, do = (torch.randn((b, t, n, d), generator=gen, device=dev)
                       .transpose(1, 2) for n in (h, kv, kv, h))
        sc = d ** -0.5
        _build._LOADED["flash_attention"] = libs["as_built"]
        o, lse = fk.flash_attention_fwd(q, k, v, sc=sc, causal=causal)
        delta = fk.bwd_delta(o, do)
        calls = {"flash_fwd_tf32": lambda: fk.flash_attention_fwd(
                     q, k, v, sc=sc, causal=causal),
                 "flash_bwd_dq_tf32": lambda: fk.flash_attention_bwd_dq(
                     q, k, v, do, lse, delta, sc=sc, causal=causal),
                 "flash_bwd_dkv_tf32": lambda: fk.flash_attention_bwd_dkv(
                     q, k, v, do, lse, delta, sc=sc, causal=causal)}
        want = dict(zip(("o", "lse"), flash_attention_plain(
            q, k, v, sc=sc, causal=causal)))
        want.update(zip(("dq", "dk", "dv"), flash_attention_bwd_plain(
            q, k, v, o, lse, do, sc=sc, causal=causal)))

        def errors(got):
            # lse: max |error|; the others: over max |plain|
            return {part: float((g - want[part]).abs().max()
                                / (1.0 if part == "lse"
                                   else want[part].abs().max()))
                    for part, g in got.items()}

        for name, lib in libs.items():
            _build._LOADED["flash_attention"] = lib
            got = dict(zip(("o", "lse"), calls["flash_fwd_tf32"]()))
            got["dq"] = calls["flash_bwd_dq_tf32"]()
            got.update(zip(("dk", "dv"), calls["flash_bwd_dkv_tf32"]()))
            errs = errors(got)
            print(json.dumps({"shape": shape_name, "check": name,
                              "err_over_max": errs, "tol": F32_TOL,
                              "ok": all(e <= F32_TOL
                                        for e in errs.values())}),
                  flush=True)
        _build._LOADED["flash_attention"] = libs["as_built"]
        fma_runs = {}
        if fma is not None:
            fma_runs, fma_out = fma_calls(fma, fma_src, q, k, v, do, lse,
                                          delta, sc, causal)
            for run in fma_runs.values():
                run()
            torch.cuda.synchronize()
            print(json.dumps({"shape": shape_name, "check": "fma_parent",
                              "err_over_max": errors(fma_out)}), flush=True)
        del got, want
        times = {}
        order = list(libs) + (["fma_parent"] if fma_runs else [])
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
        if fma_runs:
            print(json.dumps({"shape": shape_name, "vs_fma_min_ms": {
                kern: {"as_built": min(times[("as_built", FMA_PAIRS[kern])]),
                       "fma_parent": min(times[("fma_parent", kern)])}
                for kern in fma_runs}}), flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return 0


# --against: (B, H, KV, T = S) at each of AGAINST_DIMS, causal and full
AGAINST_SHAPE = (1, 16, 4, 1000)
AGAINST_DIMS = (24, 80, 96, 128)


def against_main(args) -> int:
    libs = {"as_built": _build.load("flash_attention")}
    libs.update(build({"against": open(args.against).read()}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, kv, t = AGAINST_SHAPE
    same = True
    for d in AGAINST_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v, do = (torch.randn((b, t, n, d), generator=gen,
                                           device=dev).to(dtype)
                               .transpose(1, 2) for n in (h, kv, kv, h))
                sc = d ** -0.5
                _build._LOADED["flash_attention"] = libs["as_built"]
                o, lse = fk.flash_attention_fwd(q, k, v, sc=sc, causal=causal)
                delta = fk.bwd_delta(o, do)
                calls = {
                    "fwd": lambda: fk.flash_attention_fwd(
                        q, k, v, sc=sc, causal=causal),
                    "dq": lambda: (fk.flash_attention_bwd_dq(
                        q, k, v, do, lse, delta, sc=sc, causal=causal),),
                    "dkv": lambda: fk.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, sc=sc, causal=causal)}
                outs = {}
                for name, lib in libs.items():
                    _build._LOADED["flash_attention"] = lib
                    outs[name] = {part: fn() for part, fn in calls.items()}
                torch.cuda.synchronize()
                equal = {part: all(torch.equal(x, y) for x, y in zip(
                    outs["as_built"][part], outs["against"][part]))
                    for part in calls}
                same &= all(equal.values())
                times = {}
                for name in ("as_built", "against", "against", "as_built"):
                    _build._LOADED["flash_attention"] = libs[name]
                    for part, fn in calls.items():
                        times.setdefault(name, {}).setdefault(
                            part, []).append(event_ms(fn, args.reps))
                _build._LOADED["flash_attention"] = libs["as_built"]
                print(json.dumps({
                    "d": d, "dtype": str(dtype).split(".")[-1],
                    "causal": causal, "shape": [b, h, kv, t],
                    "bit_identical": equal, "ms": times}), flush=True)
                del q, k, v, do, o, lse, delta, outs
                torch.cuda.empty_cache()
    print(json.dumps({"against": args.against, "bit_identical": same}),
          flush=True)
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--f32", action="store_true",
                    help="the split-TF32 forward, dQ and dK/dV (f32 "
                         "operands)")
    ap.add_argument("--f32-shapes", nargs="+", choices=sorted(F32_SHAPES),
                    default=list(F32_SHAPES))
    ap.add_argument("--variants", nargs="*", default=None,
                    help="--f32: the variants to build (default: all)")
    ap.add_argument("--fma-source", default=None,
                    help="--f32: an older tree's flash_attention.cu, whose "
                         "FMA kernels are timed beside the ones as built")
    ap.add_argument("--against", default=None,
                    help="another tree's flash_attention.cu: every kernel "
                         "held bit for bit to it at AGAINST_DIMS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    if args.against:
        code = against_main(args)
    elif args.f32:
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
