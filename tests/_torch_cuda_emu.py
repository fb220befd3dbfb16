"""Run the flash kernels (the forward, dQ and dK/dV) of
``csrc/flash_attention.cu`` on the CPU: the source compiled with g++
against ``tests/_cuda_emu.h`` (a stand-in for the CUDA features and inline
PTX those kernels use), its C entry points called through ctypes on CPU
tensors.

``emulated_library(out_dir)`` rewrites the source (the header for CUDA's,
every ``asm`` statement a no-op, an emulator call added at the top of
``cp_async16``, ``cp_async4``, each ``wgmma_tf32``, ``wgmma_ss_n64`` and
each ``wgmma_rs``, each ``<<<grid, block, smem, stream>>>`` launch an
``emu_launch``), compiles it into a shared library and loads it; ``None``
without g++.
``fwd_tf32(lib, q, k, v, sc=, causal=)`` returns O and lse from the f32
entry ``flash_attention_fwd``; ``bwd_tf32(lib, q, k, v, do, lse, delta,
sc=, causal=)`` dQ, dK, dV from the f32 entries ``flash_attention_bwd_dq``
and ``flash_attention_bwd_dkv`` (its group sum too when H > KV).
``fwd_tc`` and ``bwd_tc`` do the same on bf16 tensors through the
tensor-core entries (``*_tc``; dK/dV always with its group sum).  The
tensor-core dK/dV kernel of head dims up to 128 passes p^T through named
barriers, which the emulator does not have: only the wide one (d > 128)
runs here.
"""
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SOURCE = (HERE.parent / "src" / "repro_torch" / "kernels" / "flash_attention"
          / "csrc" / "flash_attention.cu")


def _insert_after_brace(src: str, signature: str, stmt: str) -> str:
    out, pos, n = [], 0, 0
    for m in re.finditer(signature, src):
        brace = src.index("{", m.end())
        out.append(src[pos:brace + 1] + "\n  " + stmt)
        pos = brace + 1
        n += 1
    if not n:
        raise ValueError(f"emu: the source has no {signature!r}")
    out.append(src[pos:])
    return "".join(out)


def _launches(src: str) -> str:
    """``k<<<g, b, smem, st>>>(args);`` -> ``emu_launch(g, b, smem, [&]()
    { k(args); });``."""
    out, pos = [], 0
    for m in re.finditer(r"([\w:]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),"
                         r"\s*([^,]+),\s*([^>]+)>>>\(", src):
        depth, j = 0, m.end() - 1
        while True:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            if depth == 0:
                break
            j += 1
        out += [src[pos:m.start()],
                f"emu_launch({m.group(2)}, {m.group(3)}, {m.group(4)}, "
                f"[&]() {{ {m.group(1)}({src[m.end():j]}); }})"]
        pos = j + 1
    out.append(src[pos:])
    return "".join(out)


def emulated_source() -> str:
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_bf16.h>",
                      f'#include "{HERE / "_cuda_emu.h"}"')
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src.replace("extern __shared__ __align__(128) unsigned char "
                      "smem_raw[];", "using ::smem_raw;")
    src = src.replace("asm volatile(", "EMU_ASM(")
    src = re.sub(r"\basm\(", "EMU_ASM(", src)
    src = _insert_after_brace(src, r"void cp_async16\(uint32_t dst",
                              "emu_cp_async(dst, src, bytes, 16);")
    src = _insert_after_brace(src, r"void cp_async4\(uint32_t dst",
                              "emu_cp_async(dst, src, bytes, 4);")
    src = _insert_after_brace(
        src, r"void wgmma_tf32\(float \(&d\)\[\d+\],\s*const uint32_t "
             r"\(&a\)\[4\],\s*uint64_t db, int scale_d\)",
        "emu_wgmma_tf32(d, a, db, scale_d);")
    src = _insert_after_brace(
        src, r"void wgmma_ss_n64\(float \(&d\)\[32\], uint64_t da,\s*"
             r"uint64_t db, int scale_d\)",
        "emu_wgmma_ss(d, da, db, scale_d);")
    src = _insert_after_brace(
        src, r"void wgmma_rs\(float \(&d\)\[\d+\], uint32_t a0,\s*"
             r"uint32_t a1, uint32_t a2,\s*uint32_t a3, uint64_t db\)",
        "emu_wgmma_rs(d, a0, a1, a2, a3, db);")
    return _launches(src)


def emulated_library(out_dir):
    """The emulated kernels' library, built into ``out_dir``; None if
    there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out_dir = Path(out_dir)
    cpp = out_dir / "flash_attention_emu.cpp"
    lib = out_dir / "flash_attention_emu.so"
    cpp.write_text(emulated_source())
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-fPIC", "-shared",
                    "-w", "-o", str(lib), str(cpp)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _entry(lib, name, pointers, strided):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * (3 * strided)
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strides(*xs):
    return [st for x in xs for st in x.stride()[:3]]


def fwd_tf32(lib, q, k, v, *, sc, causal):
    """O and lse of the emulated split-TF32 forward on f32 CPU tensors (q
    (B, H, T, d) and k, v (B, KV, S, d) with a contiguous last axis and
    16-byte strides), O in q's layout and both first filled with NaN."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    o = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, t), float("nan"))
    err = _entry(lib, "flash_attention_fwd", 5, 4)(
        *(x.data_ptr() for x in (q, k, v, o, lse)), b, h, kv, t, s, d,
        *_strides(q, k, v, o), sc, int(causal), 0, None)
    assert err == 0, err
    return o, lse


def dkv_tf32(lib, q, k, v, do, lse, delta, dk, dv, dk_part, dv_part, *, sc,
             causal):
    """The emulated ``flash_attention_bwd_dkv`` entry on CPU tensors (the
    operands of ``bwd_tf32``; dk_part and dv_part (B, H, S, d) f32 or None
    for a null pointer); returns its status."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    return _entry(lib, "flash_attention_bwd_dkv", 10, 6)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)),
        *(None if x is None else x.data_ptr() for x in (dk_part, dv_part)),
        b, h, kv, t, s, d, *_strides(q, k, v, do, dk, dv), sc, int(causal),
        0, None)


def bwd_tf32(lib, q, k, v, do, lse, delta, *, sc, causal):
    """dQ, dK, dV of the emulated split-TF32 kernels on f32 CPU tensors
    (q, dO (B, H, T, d) and k, v (B, KV, S, d) with a contiguous last axis
    and 16-byte strides, lse and delta (B, H, T) contiguous), each output
    first filled with NaN; the group sum's scratch only when H > KV, as
    the wrapper passes it."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    dq = torch.full_like(q, float("nan"))
    dk = torch.full_like(k, float("nan"))
    dv = torch.full_like(v, float("nan"))
    parts = ([torch.full((b, h, s, d), float("nan")) for _ in range(2)]
             if h != kv else [None, None])
    err = _entry(lib, "flash_attention_bwd_dq", 7, 5)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)),
        b, h, kv, t, s, d, *_strides(q, k, v, do, dq), sc, int(causal), 0,
        None)
    assert err == 0, err
    err = dkv_tf32(lib, q, k, v, do, lse, delta, dk, dv, *parts, sc=sc,
                   causal=causal)
    assert err == 0, err
    return dq, dk, dv


def fwd_tc(lib, q, k, v, *, sc, causal):
    """O and lse of the emulated tensor-core forward on bf16 CPU tensors
    (the layouts of ``fwd_tf32``), O first filled with NaN."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    o = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, t), float("nan"))
    err = _entry(lib, "flash_attention_fwd_tc", 5, 4)(
        *(x.data_ptr() for x in (q, k, v, o, lse)), b, h, kv, t, s, d,
        *_strides(q, k, v, o), sc, int(causal), 1, None)
    assert err == 0, err
    return o, lse


def bwd_tc(lib, q, k, v, do, lse, delta, *, sc, causal):
    """dQ, dK, dV of the emulated tensor-core dQ and dK/dV (and its group
    sum) on bf16 CPU tensors (the layouts of ``bwd_tf32``), each output and
    the group sum's scratch first filled with NaN."""
    b, h, t, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    dq = torch.full_like(q, float("nan"))
    dk = torch.full_like(k, float("nan"))
    dv = torch.full_like(v, float("nan"))
    parts = [torch.full((b, h, s, d), float("nan")) for _ in range(2)]
    err = _entry(lib, "flash_attention_bwd_dq_tc", 7, 5)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)),
        b, h, kv, t, s, d, *_strides(q, k, v, do, dq), sc, int(causal), 1,
        None)
    assert err == 0, err
    err = _entry(lib, "flash_attention_bwd_dkv_tc", 10, 6)(
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv, *parts)),
        b, h, kv, t, s, d, *_strides(q, k, v, do, dk, dv), sc, int(causal),
        1, None)
    assert err == 0, err
    return dq, dk, dv
