"""Train a small LM, magnitude-prune it, serve it through Escoin BCSR: the
pruning-for-deployment pipeline around the paper's technique.

Port of ``examples/train_then_prune.py``: ``make_train_step`` on the data
pipeline's batches, ``sparsify_params`` (block pruning into (16, 16) BCSR
tiles), then 16 decode steps of ``make_serve_step``, whose projections run
the ``bsr_matmul`` kernel on the card (``--device cpu``: the plain
versions; ``--smoke``: a 2-layer model of width 64)::

  PYTHONPATH=src python -m repro_torch.examples.train_then_prune --steps 120
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import DataConfig, make_loader
from repro_torch.launch.serve import sparsify_params
from repro_torch.launch.steps import init_state, make_serve_step, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig


def main(argv=None) -> float:
    """Returns the mean loss of the last 5 steps."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sparsity", type=float, default=0.7)
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer model of width 64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.smoke:
        cfg = ModelConfig(name="lm-smoke", family="dense", n_layers=2,
                          d_model=64, vocab=256, n_heads=2, n_kv_heads=2,
                          head_dim=32, d_ff=128, dtype="float32")
    else:
        cfg = ModelConfig(name="lm-28m", family="dense", n_layers=6,
                          d_model=384, vocab=8192, n_heads=6, n_kv_heads=6,
                          head_dim=64, d_ff=1024)
    print(f"model: ~{cfg.num_params() / 1e6:.1f}M params")
    opt_cfg = AdamWConfig(lr=1e-3)
    state = init_state(cfg, opt_cfg, torch.Generator(device=dev).manual_seed(0),
                       dev)
    step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
    loader = make_loader(DataConfig(seq_len=args.seq, global_batch=args.batch,
                                    vocab=cfg.vocab))
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step(state, next(loader))
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            print(f"  step {i}: loss={losses[-1]:.4f}")
    loader.close()
    last = float(np.mean(losses[-5:]))
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s; "
          f"loss {np.mean(losses[:5]):.3f} -> {last:.3f}")

    # prune + serve
    params = sparsify_params(state["params"], cfg, args.sparsity)
    serve = make_serve_step(cfg)
    cache = T.init_cache(cfg, 2, 32, dev)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for i in range(16):
            tok2, cache = serve(params, tok, cache, i)
            tok = tok2[:, None]
    assert bool(((tok >= 0) & (tok < cfg.vocab)).all())
    print(f"pruned to sparsity {args.sparsity} and served 16 tokens "
          "through Escoin BCSR: OK")
    return last


if __name__ == "__main__":
    main()
