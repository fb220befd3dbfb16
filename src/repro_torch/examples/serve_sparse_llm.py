"""End-to-end serving driver (the paper's kind is inference): batched
requests against a language model served dense, then through Escoin BCSR
weights.

Port of ``examples/serve_sparse_llm.py``: it drives
``repro_torch.launch.serve`` (in this process) for any arch that decodes,
at sparsity 0.0 and 0.8, on the smoke config unless ``--full`` asks for
the published widths (a card's worth of memory).  On the card the sparse
run's projections go through the ``bsr_matmul`` kernel; ``--device cpu``
runs the plain versions::

  PYTHONPATH=src python -m repro_torch.examples.serve_sparse_llm \\
      --arch olmoe-1b-7b --gen 24 [--device cpu]
"""
import argparse

from repro_torch import configs
from repro_torch.launch import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-9b",
                    help=f"one of {configs.list_archs()} (not the encoder)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    size = "full config" if args.full else "smoke config"
    for sparsity in (0.0, 0.8):
        print(f"\n=== serving {args.arch} ({size}), sparsity={sparsity} ===",
              flush=True)
        serve.main(["--arch", args.arch, "--batch", str(args.batch),
                    "--prompt-len", str(args.prompt_len), "--gen",
                    str(args.gen), "--sparsity", str(sparsity), "--device",
                    args.device] + ([] if args.full else ["--smoke"]))


if __name__ == "__main__":
    main()
