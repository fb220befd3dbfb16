"""Multi-pod dry run: rank 0's step of every (arch x shape) cell on the
production meshes, counted, and its roofline written as JSON.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell's jitted step for 512 placeholder host devices and reads XLA's cost
and memory analyses.  The port has no compiler in between, so its dry run
is its own program run for real, but on nothing: one process joins a world
of 256 (16 x 16) or 512 (2 x 16 x 16) ranks on PyTorch's fake process group
(``fake_pg.FakeStore``, backend ``"fake"``: every collective returns at
once), builds the production mesh (``mesh.make_production_mesh``), places
the train state (``steps.abstract_state``), the params, or for decode the
params (dense, or ``sparse_weights.abstract_sparse_params`` under
``--sparse-weights``) and the cache, and the ``specs.input_specs``
stand-ins, as ``meta`` tensors (shapes and dtypes, no storage), and runs
rank 0's meshed train, prefill or serve step end to end under the counters
of ``launch/costs.py``.  The run reaching its end with every placement
resolved is the port's "compiles"; the group is destroyed before
``lower_cell`` returns.  No device is touched: the flash and BCSR kernels'
wrappers return empty ``meta`` outputs.

What the JSON holds, against the reference's:

* the ``Roofline`` terms (``launch/roofline.py``: data-sheet rates, not
  times on a card) of rank 0's counts, which are per device as the
  reference's per-device SPMD module's are;
* ``lower_s``: the seconds of the meta run; ``compile_s``: 0.0 (nothing is
  compiled);
* ``raw_scan_flops`` / ``raw_scan_hbm``: the full-depth counts.  The
  reference's scanned program counts a loop body once, so it extrapolates
  from unrolled 1- and 2-block probes; the port's counter sees every layer,
  so its full-depth count is exact and is the one reported.  The probes
  still run (single-pod, as the reference's) and ``probe_info`` records
  them, so that ``enrich`` has its meaning;
* ``mem_*``: from the live-byte count: arguments (the state or params, the
  cache and the inputs, rank 0's shards), outputs, temporaries (the most
  the step's own storages held at once, less the outputs it made) and
  aliases (the train step updates the state in place, the serve step the
  cache, the port's counterparts of the reference's donations: alias is
  the state's or the cache's bytes);
* ``--attn-impl flash`` adds the reference's analytic attention FLOPs
  (``_flash_analytic_flops``): the counter cannot see inside a kernel, as
  XLA cannot see inside a custom call.  The BCSR matmul kernel is a
  registered op with a flop formula (2 x rows x the bank's tiles x 256;
  ``kernels/bsr_matmul/kernel.py``), so the counters see it as one op
  reading its tiles, indices and x and writing y: the sparse weights'
  bytes stay in the memory term;
* ``sparse_weights``: the ``--sparse-weights`` value (decode only, as in
  the reference; a train or prefill cell ignores it);
* ``moe_constrain``: null.  The reference's flag is a layout hint that
  pins the MoE dispatch buffers' expert dim to ``model``; the port's mesh
  path (``layers._moe_mesh``) always lays them out so and has no such
  switch, so ``--moe-constrain`` is refused by name.

A decode cell runs ``steps.make_serve_step`` once, at ``cur_len`` =
seq_len - 1 (a host int; the cache full, the write on the rank holding the
last position), on tokens (B, 1) over "dp" (whole where B does not divide,
``long_500k``) and the cache placed by ``transformer.cache_specs``.  Under
``--sparse-weights`` DeepSeek-V3's decode raises by name, as the
reference's does: its absorbed MLA decode reads k_b / v_b dense.

Usage (from the checkout, any machine; no device is used):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --all-shapes --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as cfgs
from repro_torch.distributed import sharding as S
from repro_torch.launch import costs, specs, steps
from repro_torch.launch import sparse_weights as SW
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import flags as F
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_map

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def decode_position(shape: ShapeConfig) -> int:
    """A decode cell's write position: the last of the cache."""
    return shape.seq_len - 1


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``size``-rank world on the fake process
    group; the group (and every subgroup) destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry run: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _flags(**values):
    """The model flags set for a run and restored after it."""
    old = {k: getattr(F, k) for k in values}
    for k, v in values.items():
        setattr(F, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(F, k, v)


def _inputs(cfg: ModelConfig, shape: ShapeConfig, tp: int, dp: int,
            device: str) -> Dict[str, torch.Tensor]:
    """The cell's global batch: the ``specs.input_specs`` stand-ins on
    ``meta``, else drawn with numpy from seed 0 (the same on every
    rank)."""
    sds, _ = specs.input_specs(cfg, shape, tp, dp)
    if device == "meta":
        return sds
    rs = np.random.RandomState(0)
    out = {}
    for k, v in sds.items():
        if v.dtype == torch.int32:
            a = rs.randint(0, cfg.vocab, tuple(v.shape)).astype(np.int32)
        else:
            a = rs.randn(*v.shape).astype(np.float32)
        out[k] = torch.from_numpy(a).to(v.dtype).to(device)
    return out


def count_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               device: str = "meta", num_microbatches: int = 1,
               compress_cross_pod: bool = False, fsdp_axis: str = "data",
               sparse_weights: float = 0.0, min_dim: int = 512,
               ) -> Tuple[costs.Counts, Dict[str, int], float]:
    """This rank's meshed train, prefill or serve step of ``cfg`` at
    ``shape`` on ``mesh`` (under the model flags as they are set), counted:
    (counts, memory bytes, seconds).  ``device="meta"`` runs it on
    stand-ins (the dry run); another device on a state, batch or cache
    drawn from seed 0 (the tests' gloo worlds, where the same step runs for
    real).  ``sparse_weights`` > 0 (decode): the params of
    ``abstract_sparse_params`` at that sparsity and ``min_dim``."""
    names = S._dim_names(mesh)
    tp = mesh.size(names.index("model"))
    dp = math.prod(mesh.size(names.index(a)) for a in ("pod", "data")
                   if a in names)
    rules = S.default_rules(mesh)
    if fsdp_axis != "data":
        rules["fsdp"] = fsdp_axis
    opt = AdamWConfig()
    gen = torch.Generator().manual_seed(0)
    with S.use_rules(rules, mesh):
        if shape.kind == "decode":
            args = _decode_args(cfg, shape, mesh, tp, dp, device, gen,
                                sparse_weights, min_dim)
            step = steps.make_serve_step(cfg)
        elif shape.kind == "train":
            batch = steps.place_batch(_inputs(cfg, shape, tp, dp, device),
                                      device, mesh)
            pls = steps.state_placements(cfg, mesh, tp)
            state = steps.place_state(
                steps.abstract_state(cfg, opt) if device == "meta"
                else steps.init_state(cfg, opt, gen, device), pls, mesh)
            step = steps.make_train_step(
                cfg, opt, num_microbatches=num_microbatches,
                compress_cross_pod=compress_cross_pod)
            args = (state, batch)
        else:
            batch = steps.place_batch(_inputs(cfg, shape, tp, dp, device),
                                      device, mesh)
            pls = tree_map(lambda s: S.placements(s, mesh),
                           T.param_specs(cfg, tp))
            params = steps.place_state(T.init_params(cfg, gen, device), pls,
                                       mesh)
            step = steps.make_prefill_step(cfg)
            args = (params, batch)
        t0 = time.time()
        with costs.count(known=args) as counts:
            out = step(*args)
        seconds = time.time() - t0
    held = costs.storages(args)
    made = sum(v for k, v in costs.storages(out).items() if k not in held)
    # the steps' in-place updates: the train state, the serve cache
    alias = {"train": lambda: costs.tree_bytes(args[0]),
             "decode": lambda: costs.tree_bytes(args[2])}
    mem = {"mem_arg_bytes": sum(held.values()),
           "mem_out_bytes": costs.tree_bytes(out),
           "mem_temp_bytes": max(counts.peak_new_bytes - made, 0),
           "mem_alias_bytes": alias.get(shape.kind, lambda: 0)()}
    return counts, mem, seconds


def _decode_args(cfg: ModelConfig, shape: ShapeConfig, mesh, tp: int,
                 dp: int, device: str, gen: torch.Generator,
                 sparsity: float, min_dim: int) -> Tuple[Any, ...]:
    """The serve step's (params, tokens, cache, cur_len) on ``mesh``: the
    params placed by ``param_specs`` (or ``abstract_sparse_params``' trees),
    the tokens and the cache by ``steps.place_tokens`` / ``place_cache``
    (the reference's ``decode_input_specs`` parts), on ``meta`` or drawn
    from ``gen`` (a zero cache); ``cur_len`` the host int
    ``decode_position``."""
    if sparsity > 0:
        params, pls = SW.abstract_sparse_params(
            cfg, tp, sparsity, min_dim, mesh=mesh, device=device,
            gen=None if device == "meta" else gen)
    else:
        pls = tree_map(lambda s: S.placements(s, mesh),
                       T.param_specs(cfg, tp))
        params = T.init_params(cfg, gen, device)
    b = shape.global_batch
    if device == "meta":
        sds, _ = specs.decode_input_specs(cfg, shape, tp, dp)
        tokens, cache = sds["tokens"], sds["cache"]
    else:
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab, (b, 1)).astype(np.int32))
        cache = T.init_cache(cfg, b, shape.seq_len, device)
    return (steps.place_state(params, pls, mesh),
            steps.place_tokens(tokens, device, mesh),
            steps.place_cache(cache, cfg, mesh, tp), decode_position(shape))


def _probe_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """Shallow variant with the prefix + k super-blocks."""
    prefix, period, _ = T.stage_plan(cfg)
    return dataclasses.replace(
        cfg, n_layers=cfg.first_dense_layers + k * max(len(period), 1))


def _flash_analytic_flops(cfg: ModelConfig, shape: ShapeConfig,
                          n_dev: int) -> float:
    """Attention FLOPs inside the flash kernels (per device): the counter
    sees a kernel launch as one opaque op, so with ``--attn-impl flash``
    the analytic attention flops are added: 4*B*H*hd*T_eff^2 per layer
    forward (qk + pv), x3 for train (bwd ~2x fwd), causal halves T^2."""
    if cfg.n_heads == 0:
        return 0.0
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    t = shape.seq_len
    hd = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if cfg.use_mla
          else cfg.head_dim)
    t_eff2 = t * t / (2 if cfg.causal else 1)
    per_layer = 4.0 * shape.global_batch * cfg.n_heads * hd * t_eff2
    mult = 3.0 if shape.kind == "train" else 1.0
    return n_attn * per_layer * mult / n_dev


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_shape, axes, *,
               remat: str = "dots", num_microbatches: int = 1,
               compress_cross_pod: bool = False, attn_impl: str = "chunked",
               moe_capacity: float = 1.25, moe_impl: str = "gather",
               fsdp_axis: str = "data", sparse_weights: float = 0.0,
               ) -> Tuple[costs.Counts, Dict[str, int], float]:
    """``count_step`` on ``meta`` in a fake world of the mesh's size, under
    the cell's flags (restored after)."""
    flags = dict(REMAT=remat if shape.kind == "train" else "none",
                 ATTN_IMPL=attn_impl, MOE_CAPACITY=moe_capacity,
                 MOE_IMPL=moe_impl,
                 ATTN_CHUNK=1024 if shape.seq_len <= 4096 else 4096)
    with _flags(**flags), fake_world(math.prod(mesh_shape)):
        mesh = make_mesh(tuple(mesh_shape), tuple(axes), device_type="cpu")
        return count_step(cfg, shape, mesh,
                          num_microbatches=num_microbatches,
                          compress_cross_pod=compress_cross_pod,
                          fsdp_axis=fsdp_axis,
                          sparse_weights=sparse_weights)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               remat: str = "dots", num_microbatches: int = 1,
               compress_cross_pod: bool = False, probes: bool = True,
               attn_impl: str = "chunked", moe_capacity: float = 1.25,
               moe_impl: str = "gather", fsdp_axis: str = "data",
               sparse_weights: float = 0.0, tag: str = "",
               verbose: bool = True) -> rl.Roofline:
    """One cell's dry run, written to ``RESULTS_DIR`` as the reference's
    JSON."""
    cfg = cfgs.get_config(arch)
    shape = cfgs.SHAPE_BY_NAME[shape_name]
    mesh_shape, axes = MESHES[multi_pod]
    mesh_name = "x".join(str(s) for s in mesh_shape)
    n_dev = math.prod(mesh_shape)
    kw = dict(remat=remat, num_microbatches=num_microbatches,
              compress_cross_pod=compress_cross_pod, attn_impl=attn_impl,
              moe_capacity=moe_capacity, moe_impl=moe_impl,
              fsdp_axis=fsdp_axis, sparse_weights=sparse_weights)
    counts, mem, t_lower = count_cell(cfg, shape, mesh_shape, axes, **kw)

    probe_info = None
    _, _, nblocks = T.stage_plan(cfg)
    if probes and nblocks > 1:
        p1, _, _ = count_cell(_probe_cfg(cfg, 1), shape, mesh_shape, axes,
                              **kw)
        p2, _, _ = count_cell(_probe_cfg(cfg, 2), shape, mesh_shape, axes,
                              **kw)
        probe_info = {
            "probe1": {"flops": p1.flops, "hbm": p1.hbm_bytes,
                       "coll": dict(p1.coll)},
            "probe2": {"flops": p2.flops, "hbm": p2.hbm_bytes,
                       "coll": dict(p2.coll)},
            "nblocks": nblocks}

    flash_extra = (_flash_analytic_flops(cfg, shape, n_dev)
                   if attn_impl == "flash" else 0.0)
    counts.flops += flash_extra
    peak = float(mem["mem_temp_bytes"] + mem["mem_arg_bytes"]
                 + mem["mem_out_bytes"] - mem["mem_alias_bytes"])
    r = rl.analyze(arch, shape_name, mesh_name, counts,
                   rl.model_flops_global(cfg, shape), n_dev, peak)
    if verbose:
        print(f"== {arch} x {shape_name} on mesh {mesh_name} "
              f"(meta run {t_lower:.1f}s, rank 0 of {n_dev})")
        print(f"   memory: arg={mem['mem_arg_bytes']:.3e} "
              f"out={mem['mem_out_bytes']:.3e} "
              f"temp={mem['mem_temp_bytes']:.3e} "
              f"alias={mem['mem_alias_bytes']:.3e}")
        print(f"   flops/dev={r.flops:.3e}  hbm/dev={r.hbm_bytes:.3e}  "
              f"coll/dev={r.coll_bytes:.3e}")
        print(f"   t_compute={r.t_compute*1e3:.2f}ms  "
              f"t_memory={r.t_memory*1e3:.2f}ms  "
              f"t_collective={r.t_collective*1e3:.2f}ms  "
              f"-> {r.bottleneck}-bound (data-sheet rates)")
        print(f"   useful_ratio={r.useful_ratio:.3f}  "
              f"roofline_fraction={r.roofline_fraction:.3f}")
    out = r.to_dict()
    out.update({
        "lower_s": t_lower, "compile_s": 0.0,
        "raw_scan_flops": counts.flops - flash_extra,
        "raw_scan_hbm": counts.hbm_bytes,
        "probe_info": probe_info, **mem,
        "remat": remat, "num_microbatches": num_microbatches,
        "compress_cross_pod": compress_cross_pod,
        "attn_impl": attn_impl, "moe_constrain": None,
        "sparse_weights": sparse_weights, "moe_impl": moe_impl,
        "fsdp_axis": fsdp_axis,
        "moe_capacity": moe_capacity, "flash_extra_flops": flash_extra,
    })
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = RESULTS_DIR / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(out, indent=2))
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all-shapes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", type=str, default="dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-cross-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--attn-impl", type=str, default="chunked",
                    choices=("chunked", "flash"))
    ap.add_argument("--moe-constrain", action="store_true")
    ap.add_argument("--moe-capacity", type=float, default=1.25)
    ap.add_argument("--sparse-weights", type=float, default=0.0)
    ap.add_argument("--moe-impl", type=str, default="gather",
                    choices=("gather", "ep"))
    ap.add_argument("--fsdp-axis", type=str, default="data",
                    choices=("data", "model"))
    ap.add_argument("--tag", type=str, default="")
    args = ap.parse_args(argv)
    if args.moe_constrain:
        ap.error("--moe-constrain: the port's mesh path always lays the MoE "
                 "dispatch buffers' expert dim on 'model' and has no such "
                 "switch")

    if args.all:
        cells = [(arch, s.name) for arch, s in cfgs.all_cells()]
    elif args.all_shapes:
        cells = [(args.arch, s.name)
                 for s in cfgs.applicable_shapes(args.arch)]
    else:
        cells = [(args.arch, args.shape)]

    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    failures = []
    for arch, shape in cells:
        # big models need the aggressive checkpoint policy to have any
        # chance of fitting HBM; small models keep the cheaper dots policy
        remat = ("full" if cfgs.get_config(arch).num_params() > 5e10
                 else args.remat)
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            suffix = f"__{args.tag}" if args.tag else ""
            path = RESULTS_DIR / f"{arch}__{shape}__{mesh_name}{suffix}.json"
            if args.skip_existing and path.exists():
                print(f"skip existing {path.name}")
                continue
            try:
                # probes only on the single-pod mesh, as the reference's
                lower_cell(arch, shape, multi_pod=mp, remat=remat,
                           num_microbatches=args.microbatches,
                           compress_cross_pod=args.compress_cross_pod,
                           probes=(not args.no_probes) and not mp,
                           attn_impl=args.attn_impl,
                           moe_capacity=args.moe_capacity,
                           moe_impl=args.moe_impl, fsdp_axis=args.fsdp_axis,
                           sparse_weights=args.sparse_weights, tag=args.tag)
            except Exception:
                failures.append((arch, shape, mesh_name))
                traceback.print_exc()
    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print(f"dry-run OK: {len(cells)} cell(s) x {len(meshes)} mesh(es)")


if __name__ == "__main__":
    main()
