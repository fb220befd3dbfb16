"""Where the BCSR conv kernel spends its time, on the card.

Builds variants of ``csrc/bsr_conv.cu`` with one part cut out and times
them against the kernel as built at the five main-path layers
(``kernels/conv_ablate.py`` says how), with the engine's (8, 128) blocks::

    PYTHONPATH=src python -m repro_torch.kernels.bsr_conv.ablate \\
        [--act bf16] [--layers res5a/3x3] [--reps 10] \\
        [--variants no_wgmma] [--tiles]

Variants (the default tile of each layer; ``--act bf16``: the kernel on
bf16 tiles and bf16 activations, each cut in its bf16 code path, without
``one_product``, ``three_stages`` and ``partials_of_8``, which have no bf16
counterpart, and with ``step_waits``, each 16-deep step's wgmma waited for
before the next issues, as the first bf16 kernel did):

* ``no_wgmma``: no wgmma issued (gathers, splits and copies run);
* ``one_product``: x_hi w_hi alone, the cost of the other two products of
  the split;
* ``no_gather``: the A values not loaded from the input (constants);
* ``no_tiles``: the B operands (the group's weight tiles) not copied;
* ``no_epilogue``: the sums stored without bias, residual and ReLU;
* ``three_stages``: a third stage of the B operand (a deeper copy ring);
* ``partials_of_8``: partial sums of 8 steps, half the rounded adds (at
  bf16, one a block column).

``--tiles`` times, with the kernel as built, every (N, warpgroups) tile the
source instantiates, and each one's largest difference from the plain
version.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.kernels import _build, budget, conv_ablate
from repro_torch.kernels.bsr_conv import ops
from repro_torch.kernels.bsr_conv.kernel import bsr_conv_kernel, split_weights
from repro_torch.kernels.bsr_conv.ref import bsr_conv_plain

KERNEL = "bsr_conv"
BLOCK = (8, 128)


def variants(src: str, act: str = "f32") -> dict:
    """Variant name -> source text; ``act`` picks the code path that
    ``no_wgmma`` and ``no_gather`` cut (the others are shared)."""
    cut = conv_ablate.cut
    out = {
        "no_tiles": cut(src, "          cp_async16(dst + dst_off[u]",
                        "          if (0) cp_async16(dst + dst_off[u]"),
        "three_stages": cut(src, "constexpr int BSTAGES = 2;",
                            "constexpr int BSTAGES = 3;"),
        "partials_of_8": cut(cut(src, "constexpr int GS = 4;",
                                 "constexpr int GS = 8;"),
                             "static_assert(KS % (2 * GS) == 0",
                             "static_assert(KS % GS == 0"),
        "no_epilogue": cut(
            src, "        v = v + bias[m];\n"
                 "        if (residual != nullptr) v += widen(residual[o]);\n"
                 "        if (relu) v = fmaxf(v, 0.f);", ""),
    }
    if act == "bf16":
        del out["three_stages"], out["partials_of_8"]
        products = ("        wgmma_bf16(acc, cur[ks],\n"
                    "                   smem_desc(sb0 + ks * 2 * (N * 16), "
                    "N * 16, 128), 1);\n")
        out.update(
            no_wgmma=cut(src, products, ""),
            step_waits=cut(src, products, products + "        wg_commit();\n"
                           "        wg_wait<0>();\n"),
            no_gather=cut(src, "__ldg(xh + ", "(unsigned short)("))
        return out
    products = ("        wgmma_tf32(d, hi, dhi, ks % GS != 0);\n"
                "        if (!QUANT) wgmma_tf32(d, hi, dlo, 1);\n"
                "        wgmma_tf32(d, lo, dhi, 1);\n")
    out.update(
        no_wgmma=cut(src, products, ""),
        one_product=cut(src, products,
                        "        wgmma_tf32(d, hi, dhi, ks % GS != 0);\n"),
        no_gather=cut(src, "__ldg(xpad + ", "(float)("))
    return out


def layer_call(layer: conv_ablate.Layer, seed: int, device,
               act: str = "f32", **pins):
    """(kernel call, plain result, tile) of one layer; at ``act`` bf16 on
    bf16 tiles."""
    from repro_torch.core.direct_conv import pad_in
    from repro_torch.core.sparse_format import bcsr_conv_from_dense

    o = conv_ablate.operands(layer, seed, device, act)
    dt = o["x"].dtype
    bc = bcsr_conv_from_dense(o["w"], block=BLOCK, device=device)
    blocks = bc.blocks.to(dt)
    gbm = bc.blocks.shape[0]
    mpad = gbm * BLOCK[0]
    tile, reason = ops.resolve_bsr_schedule(
        *BLOCK, layer.e, layer.e, n=conv_ablate.BATCH, m=mpad,
        crs=layer.c * layer.r ** 2, value_dtype=str(dt).split(".")[1],
        itemsize=o["x"].element_size(), **pins)
    if tile is None:
        return None, None, reason
    bias = torch.zeros(mpad, device=device)
    bias[:layer.m] = o["bias"]
    res = None
    if o["res"] is not None:
        res = torch.zeros((conv_ablate.BATCH, mpad, layer.e, layer.e),
                          dtype=dt, device=device)
        res[:, :layer.m] = o["res"]
    args = (pad_in(o["x"], layer.pad), blocks, bc.blockcol, bc.nblocks,
            bias, res)
    kw = dict(rs=layer.r ** 2, s=layer.r, e=layer.e, f=layer.e,
              stride=layer.stride, fuse_relu=True)
    halves = split_weights(blocks) if dt == torch.float32 else None
    return ((lambda: bsr_conv_kernel(*args, n_tile=tile[0], wgs=tile[1],
                                     halves=halves, **kw)),
            bsr_conv_plain(*args, **kw), tile)


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs a CUDA card")
    dev = torch.device("cuda")
    chosen = variants(_build.SOURCES[KERNEL].read_text(), args.act)
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
    if args.tiles:
        for i, layer in enumerate(layers):
            size = 2 if args.act == "bf16" else 4
            for n_tile, wgs in budget.bsr_conv_tiles(size):
                fn, plain, tile = layer_call(layer, args.seed + i, dev,
                                             args.act, n_tile=n_tile, wgs=wgs)
                if fn is None:
                    conv_ablate.tile_line(KERNEL, [n_tile, wgs], layer.name,
                                          reason=tile)
                    continue
                conv_ablate.tile_line(
                    KERNEL, list(tile), layer.name,
                    ms=conv_ablate.event_ms(fn, args.reps),
                    device_ms=conv_ablate.device_ms(fn, args.reps),
                    max_abs_err=float(
                        (fn().float() - plain.float()).abs().max()))
    print(conv_ablate.card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
