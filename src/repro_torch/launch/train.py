"""Training CLI: end-to-end loop with checkpoint/restart + monitoring.

Port of ``repro/launch/train.py``.  Runs any of the port's archs, on the
card by default or on the CPU with ``--device cpu`` (the kernels' plain
versions)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 20 --batch 8 --seq 128 --attn-impl flash --device cpu \\
      [--remat none|dots|full]

On a mesh, one process a rank (``torchrun`` sets the world)::

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --smoke --steps 20 --batch 8 --seq 128 \\
      --model-axis 2 [--device cpu]

makes a (world / model-axis, model-axis) ("data", "model") mesh of the
world (``make_host_mesh``), places the state by ``state_placements`` and
each batch over "dp", and saves checkpoints from every rank (host = rank).
The process group's backend is ``--backend`` (default: nccl on the card,
gloo on the CPU).  Without ``torchrun`` a single process runs the meshless
path.

The encoder and VLM archs (hubert-xlarge, phi-3-vision-4.2b) train on the
data pipeline's f32 embeddings; deepseek-v3-671b adds its MTP term.

With ``--ckpt-dir`` the run resumes from the latest committed step there
and saves every ``--ckpt-every`` steps; without it, checkpoints go to a
temporary directory that is removed at exit.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as cfgs
from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_loader
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (init_state, make_train_step,
                                      place_state, state_placements)
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
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks of the mesh's model dim (under torchrun)")
    ap.add_argument("--moe-impl", choices=("gather", "ep"), default="gather")
    ap.add_argument("--backend", default="",
                    help="process-group backend under torchrun (default: "
                         "nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)

    meshed = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if args.model_axis > 1 and not meshed:
        raise SystemExit("--model-axis > 1 needs a world: launch with "
                         "torchrun --nproc-per-node N -m "
                         "repro_torch.launch.train ...")
    dev = resolve_device(args.device)
    rank, world = 0, 1
    if meshed:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(
            args.backend or ("nccl" if dev.type == "cuda" else "gloo"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=600))
    cfg = cfgs.get_config(args.arch, smoke=args.smoke)
    F.set_attn_impl(args.attn_impl)
    F.set_remat(args.remat)
    F.set_moe_impl(args.moe_impl)
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
    mesh = make_host_mesh(model=args.model_axis,
                          device_type=dev.type) if meshed else None
    rules = (shd.use_rules(shd.default_rules(mesh), mesh) if meshed
             else contextlib.nullcontext())
    say = print if rank == 0 else (lambda *a, **k: None)

    try:
        with rules, tempfile.TemporaryDirectory() as scratch:
            if meshed:
                state = place_state(state, state_placements(
                    cfg, mesh, args.model_axis), mesh)
            ckpt = CheckpointManager(args.ckpt_dir or scratch, keep=2,
                                     host_id=rank, n_hosts=world)
            restored, ck_step = (ckpt.restore_latest(state) if args.ckpt_dir
                                 else (None, None))
            start = 0
            if restored is not None:
                state, start = restored, ck_step
                say(f"resumed from step {start}")

            runner = StepRunner(step_fn, ckpt, lambda s: make_loader(dcfg, s),
                                ckpt_every=args.ckpt_every,
                                monitor=StragglerMonitor())
            t0 = time.time()
            losses = []

            def on_metrics(step, m):
                losses.append(float(m.get("loss", float("nan"))))
                if step % 5 == 0 or step == start + 1:
                    say(f"step {step}: loss={float(m.get('loss')):.4f} "
                        f"gnorm={float(m.get('grad_norm')):.3f} "
                        f"lr={float(m.get('lr')):.2e}")

            state, end = runner.run(state, start, args.steps,
                                    on_metrics=on_metrics)
            ckpt.wait()
            dt = time.time() - t0
    finally:
        if meshed:
            dist.destroy_process_group()
    k = min(5, len(losses))
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    where = (f"{dev} x {world} ranks, mesh {tuple(mesh.mesh.shape)}"
             if meshed else f"{dev}")
    say(f"trained {end - start} steps in {dt:.1f}s "
        f"({dt / max(end - start, 1):.2f}s/step) on {where}; "
        f"loss {first:.4f} -> {last:.4f}")
    if not np.isfinite(last):
        raise SystemExit("loss diverged — check config")
    if len(losses) >= 50 and last > first + 0.05:
        raise SystemExit("loss did not improve — check config")


if __name__ == "__main__":
    main()
