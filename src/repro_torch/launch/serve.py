"""Serving CLI: batched prefill + decode with KV cache (+ Escoin sparsity).

Port of the LLM branch of ``repro/launch/serve.py``.  With --sparsity > 0,
every large linear weight is block-pruned and served through the Escoin
BCSR path, whose products run the ``bsr_matmul`` CUDA kernel on the card::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --sparsity 0.8

It runs on the card; ``--device cpu`` runs the plain PyTorch versions on
the CPU (a smoke config is the size for that).  ``--autotune`` and
``--cnn-serve`` come with the slices that port the autotuner and the CNN
serving tier.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as cfgs
from repro_torch import resolve_device
from repro_torch.core.pruning import block_prune
from repro_torch.core.sparse_format import BcsrMatrix, bcsr_from_dense
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T

SKIP = frozenset({"embed", "lm_head", "router", "conv_w"})


def sparsify_params(params, cfg, sparsity: float, block=(16, 16),
                    min_dim: int = 64):
    """Prune and convert every large 2-D linear weight to Escoin BCSR, in
    place, one matrix at a time.

    A weight named outside ``SKIP`` with both dims >= ``min_dim`` is
    block-pruned in f32 (``block_prune``) and stored as the BCSR of its
    transpose (dense weights are (in, out); BCSR computes x @ W.T for
    (out, in)), with tiles in the weight's dtype (exact: the f32 copy holds
    the same values).  The work happens on the weight's device, and each
    dense leaf is replaced as soon as its bank is built, so the dense model
    never sits beside its banks.  Leaves in dicts and lists are converted
    in place; a weight at the root is returned converted.
    """
    def conv(name, w):
        if name in SKIP or not isinstance(w, torch.Tensor):
            return w
        if w.ndim == 2 and min(w.shape) >= min_dim:
            pruned = block_prune(w.float(), sparsity, block)
            b = bcsr_from_dense(pruned.T, block)
            return BcsrMatrix(blocks=b.blocks.to(w.dtype),
                              blockcol=b.blockcol, nblocks=b.nblocks,
                              shape=b.shape, block=b.block)
        return w

    def visit(p, name=""):
        if isinstance(p, dict):
            for k in list(p):
                p[k] = visit(p[k], k)
            return p
        if isinstance(p, list):
            for i in range(len(p)):
                p[i] = visit(p[i], name)
            return p
        return conv(name, p)

    return visit(params)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {cfgs.list_archs()}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfgs.get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dev)
    if args.sparsity > 0:
        params = sparsify_params(params, cfg, args.sparsity)
        print(f"serving with Escoin BCSR weights at sparsity {args.sparsity}")

    b, p, g = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    cache = T.init_cache(cfg, b, p + g, dev)
    serve_step = make_serve_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill token by token through the decode step, as the reference does
    t0 = time.perf_counter()
    for i in range(p):
        nxt, cache = serve_step(params, prompts[:, i:i + 1], cache, i)
    sync()
    t_prefill = time.perf_counter() - t0

    out = [nxt]
    t0 = time.perf_counter()
    for i in range(p, p + g - 1):
        nxt, cache = serve_step(params, out[-1][:, None], cache, i)
        out.append(nxt)
    sync()
    t_decode = time.perf_counter() - t0
    gen_ids = torch.stack(out, dim=1).cpu()
    assert gen_ids.shape == (b, g), gen_ids.shape
    assert bool(((gen_ids >= 0) & (gen_ids < cfg.vocab)).all())
    print(f"generated {g} tokens x {b} seqs on {dev}; prefill "
          f"{t_prefill:.2f}s, decode {t_decode:.2f}s "
          f"({t_decode / max(g - 1, 1) * 1e3:.1f} ms/tok)")
    print("sample:", gen_ids[0, :12].tolist())


if __name__ == "__main__":
    main()
