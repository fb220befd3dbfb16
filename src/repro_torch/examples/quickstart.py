"""Escoin quickstart: prune a conv layer, run it four ways, same answer.

Port of ``examples/quickstart.py``: ``dense`` (cuDNN on the card),
``lowered`` (im2col + ELL SpMM), ``csr-direct`` (the direct sparse conv in
plain PyTorch) and the ELL ``sparse_conv`` kernel, then the same technique
on a linear layer (block pruning into (64, 64) tiles, the product through
the BCSR matmul kernel, whose tiles are 16 rows high: each kept (64, 64)
tile is four of them).  On the CPU both kernels run their plain
versions::

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (bcsr_from_dense, block_prune, dense_conv,
                              dense_matmul, direct_sparse_conv,
                              ell_from_dense, ell_from_dense_conv,
                              lowered_sparse_conv, magnitude_prune)
from repro_torch.kernels.bsr_matmul.ops import bsr_matmul
from repro_torch.kernels.sparse_conv.ops import sparse_conv


def main(argv=None) -> Dict[str, torch.Tensor]:
    """Returns each method's output on the CPU, by name: the four conv
    methods, then the linear layer's "dense linear" and "bcsr linear"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- a pruned convolution layer (the paper's setting) -------------------
    x = torch.from_numpy(
        rng.standard_normal((4, 16, 28, 28)).astype(np.float32)).to(dev)
    w = rng.standard_normal((32, 16, 3, 3)).astype(np.float32)
    w = magnitude_prune(w, 0.85)                     # weight pruning
    print(f"conv weight sparsity: {float(np.mean(w == 0)):.2f}")

    ell = ell_from_dense_conv(w, device=dev)         # CSR + weight stretching
    wt = torch.from_numpy(w).to(dev)
    outs = {
        "dense  (cuDNN)": dense_conv(x, wt, padding=1),
        "lowered (cuSPARSE analogue)": lowered_sparse_conv(
            x, ell_from_dense(w.reshape(32, -1), device=dev), 3, 3,
            padding=1),
        "escoin direct (PyTorch)": direct_sparse_conv(x, ell, padding=1),
        "escoin direct (kernel)": sparse_conv(x, ell, padding=1),
    }
    outs = {name: o.float().cpu() for name, o in outs.items()}
    ref = outs["dense  (cuDNN)"]
    for name, o in outs.items():
        err = float((o - ref).abs().max())
        print(f"  {name:28s} out={tuple(o.shape)}  max|err|={err:.2e}")

    # --- the same technique on a linear layer (BCSR tiles) ------------------
    xl = torch.from_numpy(
        rng.standard_normal((8, 256)).astype(np.float32)).to(dev)
    wl = torch.from_numpy(
        rng.standard_normal((512, 256)).astype(np.float32)).to(dev)
    wl = block_prune(wl, 0.75, (64, 64))             # structured pruning
    tiles = int(bcsr_from_dense(wl, (64, 64)).nblocks.sum())
    outs["dense linear"] = dense_matmul(xl, wl).cpu()
    outs["bcsr linear"] = bsr_matmul(xl, bcsr_from_dense(wl, (16, 64))).cpu()
    err = float((outs["bcsr linear"] - outs["dense linear"]).abs().max())
    print(f"\nlinear: {tiles}/{(512 // 64) * (256 // 64)} tiles survive "
          f"pruning -> {1 - tiles / 32:.0%} of matmul work skipped, "
          f"max|err|={err:.2e}")
    print("quickstart OK")
    return outs


if __name__ == "__main__":
    main()
