"""The paper's scenario end to end: pruned-CNN inference through Escoin vs
the lowering baselines, per-layer and whole-network, on the graph engine.

Port of ``examples/cnn_inference.py``.  The nested spec is lowered once
into a flat op program (with conv epilogues fused at lowering time), a
``CnnEngine`` binds the pruned weights on the device, and each method runs
through it: ``pallas`` and ``bsr`` launch the CUDA conv kernels on the
card, ``auto`` the engine's roofline plan; on ``--device cpu`` the kernels'
plain versions run instead::

  PYTHONPATH=src python -m repro_torch.examples.cnn_inference \\
      --net alexnet --image 99 [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.cnn_inference \\
      --net resnet50 --methods dense,csr-direct,auto
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.engine import CnnEngine, lower
from repro_torch.models import cnn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", default="alexnet", choices=list(cnn.NETWORKS))
    ap.add_argument("--image", type=int, default=99)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--methods", default="dense,lowered,csr-direct",
                    help="comma-separated subset of "
                         "dense,lowered,csr-direct,pallas,bsr,auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    net = cnn.NETWORKS[args.net]()
    rng = np.random.default_rng(0)
    program = lower(net, (3, args.image, args.image))
    params = cnn.init_cnn(net, 3, rng, args.image, device=dev)
    engine = CnnEngine(program, params, device=dev)
    x = torch.from_numpy(rng.standard_normal(
        (args.batch, 3, args.image, args.image)).astype(np.float32)).to(dev)

    def run(method):
        out = engine(x, method)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    print(f"{args.net}: lowered once -> {program.summary()}; "
          f"image {args.image}, batch {args.batch}, on {dev}")
    ref = None
    for method in args.methods.split(","):
        out = run(method)   # first use: plans and banks
        t0 = time.perf_counter()
        for _ in range(3):
            out = run(method)
        dt = (time.perf_counter() - t0) / 3
        out = out.cpu().numpy()
        if ref is None:
            ref, err = out, 0.0
        else:
            err = float(np.max(np.abs(out - ref)))
        print(f"  {method:10s}: {dt * 1e3:8.1f} ms/batch   max|err|={err:.1e}")
    print("top-1 of first image:", int(np.argmax(ref[0])))


if __name__ == "__main__":
    main()
