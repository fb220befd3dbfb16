"""Where the ELL conv kernel spends its time, on the card.

Builds variants of ``csrc/sparse_conv.cu`` with one part cut out and times
them against the kernel as built at the five main-path layers
(``kernels/conv_ablate.py`` says how)::

    PYTHONPATH=src python -m repro_torch.kernels.sparse_conv.ablate \\
        [--act bf16] [--layers res4b/3x3 conv2] [--reps 10] \\
        [--variants no_sums] [--design] [--tiles] [--slab-kb 48 96]

Variants (the default schedule of each layer; ``--act bf16``: the kernel
on a bf16 bank and bf16 activations):

* ``no_slab``: the input slab not copied;
* ``no_sums``: no nonzero walked (copies and epilogue run);
* ``no_pairs``: the runs walked and summed, but no pair loaded (every
  entry a constant);
* ``no_inputs``: the nonzeros walked and multiplied into the sums, but no
  input read from the slab (a constant instead: 1.5 pairs, or 0);
* ``mul_add``: a bf16 bank's sums with the product and the add rounded
  apart (``__fmul_rn``, ``__fadd_rn``) where the kernel takes one fmaf;
* ``no_planes``: a paired slab's plane 1 not built (plane 0 left as the
  copy put it);
* ``unroll_8``: a bf16 bank's window unrolled 8 entries deep, not 4;
* ``no_epilogue``: the sums stored without bias, residual and ReLU;
* ``two_blocks``: a launch bound of two blocks an SM, so ptxas may take
  up to 128 registers a thread (as built, the widest tiles spill a few
  bytes at 64).

``--tiles`` times, with the kernel as built, every (tm, tp) tile the source
instantiates, pipelined and blocking, at each ``--slab-kb`` size of a
block's slab stages, and checks each bit for bit against the plain
version.  ``--design`` (bf16) times, with the kernel as built, the bank
streamed three ways, in turns: as (offset, f32 value) pairs on the unpaired
slab (the first bf16 kernel's format: two shuffles, multiply and add
rounded apart), as bf16 words on the unpaired slab (one shuffle, one
fmaf), and as words on the paired slab (two pixels a shared-memory read).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import _build, budget, conv_ablate
from repro_torch.kernels.sparse_conv import ops
from repro_torch.kernels.sparse_conv.kernel import sparse_conv_kernel
from repro_torch.kernels.sparse_conv.ref import slab_width, sparse_conv_plain

KERNEL = "sparse_conv"


def variants(src: str) -> dict:
    """Variant name -> source text (the source is templated on the
    activation type: each cut holds for f32 and bf16 alike)."""
    cut = conv_ablate.cut
    return {
        "no_slab": cut(src, "        cp_async4(sb + 4 * t, src >= 0",
                       "        if (0) cp_async4(sb + 4 * t, src >= 0"),
        "no_sums": cut(src, "      int i = bounds[ml * (nchunks + 1) + k];",
                       "      int i = end;"),
        "no_pairs": cut(cut(
            src, "      EntryT win = first[rr];",
            "      EntryT win = zero_entry(EntryT());"),
            "        const EntryT nxt = i + 32 + lane < end ? __ldg(pr + i + 32 + lane)\n"
            "                                               : zero_entry(EntryT());",
            "        const EntryT nxt = win;"),
        "no_inputs": cut(
            src, "      return *reinterpret_cast<const uint32_t*>(a);\n"
                 "    else\n"
                 "      return *reinterpret_cast<const XT*>(a);",
            "      return 0x3FC03FC0u;\n"
            "    else\n"
            "      return XT();"),
        "mul_add": cut(src, "  return fmaf(v, x, acc);",
                       "  return __fadd_rn(acc, __fmul_rn(v, x));"),
        "no_planes": cut(src, "      build_planes();\n", ""),
        "unroll_8": cut(src, "#pragma unroll 4\n"
                             "    for (int t = 0; t < cnt; ++t) {\n"
                             "      const uint32_t w",
                        "#pragma unroll 8\n"
                        "    for (int t = 0; t < cnt; ++t) {\n"
                        "      const uint32_t w"),
        "two_blocks": cut(src, "__global__ void __launch_bounds__(NTH) sparse_conv_kernel(",
                          "__global__ void __launch_bounds__(NTH, 2) sparse_conv_kernel("),
        "no_epilogue": cut(
            src, "      float v = __fadd_rn(acc[rr][j], bias[m]);\n"
                 "      if (residual != nullptr) v = __fadd_rn(v, widen(residual[o]));\n"
                 "      if (relu) v = fmaxf(v, 0.f);",
            "      float v = acc[rr][j];"),
    }


def layer_call(layer: conv_ablate.Layer, seed: int, device,
               act: str = "f32", widen_bank: bool = False, **pins):
    """(kernel call, plain result, schedule) of one layer; at ``act`` bf16
    on a bf16 bank (``widen_bank``: its values widened to f32, which the
    launcher streams as (offset, f32 value) pairs) and the padded input
    ``ops.sparse_conv`` gives the kernel."""
    from repro_torch.core.direct_conv import pad_in
    from repro_torch.core.sparse_format import ell_from_dense_conv

    o = conv_ablate.operands(layer, seed, device, act)
    ell = ell_from_dense_conv(o["w"], device=device)
    value = ell.value.to(o["x"].dtype)
    if widen_bank:
        value = value.float()
    size = o["x"].element_size()
    hp = layer.h + 2 * layer.pad
    pins.setdefault("paired", value.dtype == torch.bfloat16)  # as ops asks
    sched, reason = ops.resolve_schedule(
        layer.m, ell.k, layer.e, layer.e, n=conv_ablate.BATCH, c=layer.c,
        r=layer.r, s=layer.r, stride=layer.stride, hp=hp, wp=hp,
        itemsize=size, **pins)
    if sched is None:
        return None, None, reason
    xpad = pad_in(o["x"], layer.pad)
    if layer.r > 1:
        xpad = torch.nn.functional.pad(xpad, (0, slab_width(hp, size) - hp))
    args = (xpad, value, ops.pack_indices(ell), ell.nnz, o["bias"], o["res"])
    kw = dict(rs=layer.r ** 2, s=layer.r, e=layer.e, f=layer.e,
              stride=layer.stride, fuse_relu=True)
    return ((lambda: sparse_conv_kernel(*args, schedule=sched, **kw)),
            sparse_conv_plain(*args, **kw), sched)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    names = [layer.name for layer in conv_ablate.LAYERS]
    ap.add_argument("--act", choices=conv_ablate.ACTS, default="f32")
    ap.add_argument("--layers", nargs="+", choices=names, default=names)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="variant names (default: all)")
    ap.add_argument("--tiles", action="store_true",
                    help="also time every tile the source instantiates")
    ap.add_argument("--slab-kb", type=int, nargs="+",
                    default=[budget.ELL_SLAB_BYTES // 1024])
    ap.add_argument("--design", action="store_true",
                    help="at bf16, also time the kernel as built with the "
                         "bank as (offset, f32) pairs on the unpaired slab, "
                         "as bf16 words on the unpaired slab, and as words "
                         "on the paired slab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    dev = torch.device("cuda")
    chosen = variants(_build.SOURCES[KERNEL].read_text())
    if args.variants is not None:
        chosen = {k: chosen[k] for k in args.variants}
    libs = {"as_built": _build.load(KERNEL)}
    libs.update(conv_ablate.build(KERNEL, chosen))
    layers = [lay for lay in conv_ablate.LAYERS if lay.name in args.layers]
    calls, want = {}, {}
    for i, layer in enumerate(layers):
        calls[layer.name], want[layer.name], _ = layer_call(
            layer, args.seed + i, dev, args.act)
    conv_ablate.in_turns(KERNEL, libs, calls, want, args.reps)
    if args.design:
        designs = {"pairs": dict(widen_bank=True, paired=False),
                   "words": dict(paired=False), "paired": {}}
        times = {}
        for i, layer in enumerate(layers):
            runs = {name: layer_call(layer, args.seed + i, dev, "bf16", **kw)
                    for name, kw in designs.items()}
            for name in list(designs) + list(reversed(list(designs))):
                fn, plain, sched = runs[name]
                times.setdefault((name, layer.name), []).append(
                    conv_ablate.event_ms(fn, args.reps))
                times.setdefault((name, layer.name, "dev"), []).append(
                    conv_ablate.device_ms(fn, args.reps))
                err = float((fn().float() - plain.float()).abs().max())
                times[(name, layer.name, "err")] = err
        for (name, lay), ms in [(k, v) for k, v in times.items()
                                if len(k) == 2]:
            print(json.dumps({"kernel": KERNEL, "design": name,
                              "layer": lay, "ms": ms,
                              "device_ms": times[(name, lay, "dev")],
                              "max_abs_err": times[(name, lay, "err")]}),
                  flush=True)
    if args.tiles:
        default_slab = budget.ELL_SLAB_BYTES
        for kb in args.slab_kb:
            budget.ELL_SLAB_BYTES = kb * 1024
            for i, layer in enumerate(layers):
                for tm, px in budget.ELL_TILES:
                    for pipe in (True, False):
                        fn, plain, sched = layer_call(
                            layer, args.seed + i, dev, args.act, tm=tm,
                            tp=32 * px, pipeline=pipe)
                        tile = [tm, 32 * px, pipe, kb]
                        if fn is None:
                            conv_ablate.tile_line(KERNEL, tile, layer.name,
                                                  reason=sched)
                            continue
                        conv_ablate.tile_line(
                            KERNEL, tile + [sched.cc, sched.rows,
                                            sched.paired],
                            layer.name, ms=conv_ablate.event_ms(fn, args.reps),
                            device_ms=conv_ablate.device_ms(fn, args.reps),
                            max_abs_err=float(
                                (fn().float() - plain.float()).abs().max()))
        budget.ELL_SLAB_BYTES = default_slab
    print(conv_ablate.card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
