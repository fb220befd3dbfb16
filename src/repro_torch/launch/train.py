"""Training CLI: end-to-end loop with checkpoint/restart + monitoring.

Port of ``repro/launch/train.py`` on one card (no mesh, so no
``--model-axis``).  Runs any of the port's archs, on the card by default or
on the CPU with ``--device cpu`` (the kernels' plain versions)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 20 --batch 8 --seq 128 --attn-impl flash --device cpu \\
      [--remat none|dots|full]

The encoder and VLM archs (hubert-xlarge, phi-3-vision-4.2b) train on the
data pipeline's f32 embeddings; deepseek-v3-671b adds its MTP term.

With ``--ckpt-dir`` the run resumes from the latest committed step there
and saves every ``--ckpt-every`` steps; without it, checkpoints go to a
temporary directory that is removed at exit.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs as cfgs
from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_loader
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.models import flags as F
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import StepRunner, StragglerMonitor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {cfgs.list_archs()}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--remat", choices=("none", "dots", "full"),
                    default="none",
                    help="activation checkpointing of the layer stack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--attn-impl", choices=("chunked", "flash"),
                    default="chunked")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfgs.get_config(args.arch, smoke=args.smoke)
    F.set_attn_impl(args.attn_impl)
    F.set_remat(args.remat)
    opt_cfg = AdamWConfig(lr=args.lr)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, seed=args.seed,
                      embed_dim=cfg.d_model if cfg.family in ("vlm", "encoder")
                      else 0)
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches,
                              total_steps=args.steps)
    state = init_state(cfg, opt_cfg,
                       torch.Generator(device=dev).manual_seed(args.seed), dev)

    with tempfile.TemporaryDirectory() as scratch:
        ckpt = CheckpointManager(args.ckpt_dir or scratch, keep=2)
        restored, ck_step = (ckpt.restore_latest(state) if args.ckpt_dir
                             else (None, None))
        start = 0
        if restored is not None:
            state, start = restored, ck_step
            print(f"resumed from step {start}")

        runner = StepRunner(step_fn, ckpt, lambda s: make_loader(dcfg, s),
                            ckpt_every=args.ckpt_every,
                            monitor=StragglerMonitor())
        t0 = time.time()
        losses = []

        def on_metrics(step, m):
            losses.append(m.get("loss", float("nan")))
            if step % 5 == 0 or step == start + 1:
                print(f"step {step}: loss={m.get('loss'):.4f} "
                      f"gnorm={m.get('grad_norm'):.3f} lr={m.get('lr'):.2e}")

        state, end = runner.run(state, start, args.steps,
                                on_metrics=on_metrics)
        dt = time.time() - t0
    k = min(5, len(losses))
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    print(f"trained {end - start} steps in {dt:.1f}s "
          f"({dt / max(end - start, 1):.2f}s/step) on {dev}; "
          f"loss {first:.4f} -> {last:.4f}")
    if not np.isfinite(last):
        raise SystemExit("loss diverged — check config")
    if len(losses) >= 50 and last > first + 0.05:
        raise SystemExit("loss did not improve — check config")


if __name__ == "__main__":
    main()
