"""Where the tensor-core flash kernels spend their time, on the card.

Builds variants of ``csrc/flash_attention.cu`` with one part of the bf16
forward and dK/dV kernels cut out (their results are wrong; only their
times count) or with other ring depths, and times each against the kernels
as built, in turns (as built, variants, variants reversed, as built), with
CUDA events after a warm-up::

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate \\
        [--shape prefill|train_4k] [--reps 10]

prefill is B 4, H 32, KV 4, T 2048; train_4k B 1, H 32, KV 4, T 4096; both
causal, d 128, bf16, on the model's (B, T, H, d) layout.  Variants:

* ``no_wgmma``: no wgmma issued (softmax, split and staging only);
* ``no_loads``: no cp.async after the first stages (stale tiles);
* ``no_softmax``: the forward's softmax replaced by alpha = sum = 1;
* ``fast_exp``: ``exp2f`` replaced by the bare ``ex2.approx.ftz``;
* ``stages3``: both rings one stage deeper.

Prints one JSON line per (variant, kernel) and the card's name and power
limit.  Needs a card and ``nvcc``; builds into ``build/kernels/ablate``.
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
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
