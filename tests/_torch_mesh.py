"""What the multi-rank test files share (``test_torch_distributed.py``,
``test_torch_distributed_families.py``, ``test_torch_compress_mesh.py``,
``test_torch_moe_ep.py``, ``test_torch_elastic.py``,
``test_torch_mesh_decode.py``, ``test_torch_dryrun.py``).

Reference side: ``run_reference`` runs one of the scripts below in a
subprocess that sets ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
before importing jax (the device count locks at init), builds its meshes
with the reference's ``repro.runtime.build_mesh`` (a plain ``Mesh`` with
Auto axes; ``jax.make_mesh`` under jax 0.9 builds Explicit axes, which the
reference's ``constrain`` refuses), and writes its results under the test's
``tmp_path``: the initial train state through the reference's own
``save_state`` from the meshed arrays (the port restores it), and the
metrics of 3 meshed steps as ``.npz``.

Port side: ``spawn_world`` runs a rank function (defined here, so that
spawned ranks import no JAX) in a gloo world spawned with
``torch.multiprocessing``: one torch thread a rank, a free port, an
``init_process_group`` timeout and a join timeout, so that nothing can hang
the suite; a rank that raises fails the world.
"""
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
LR = 1e-3
TOTAL_STEPS = 10
B, SEQ = 8, 32
RTOL = 1e-4          # relative, per step, on loss and grad_norm (f32)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def batch(vocab: int, seed: int = 1):
    """The seeded (B, SEQ) token batch both packages train on."""
    toks = np.random.RandomState(seed).randint(0, vocab, (B, SEQ)).astype(
        np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def embeds_batch(d_model: int, vocab: int, seed: int = 2):
    """The seeded f32 (B, SEQ, d_model) embeddings and labels an encoder or
    VLM arch trains on (what the data pipeline feeds those families)."""
    rs = np.random.RandomState(seed)
    return {"embeds": rs.randn(B, SEQ, d_model).astype(np.float32),
            "labels": rs.randint(0, vocab, (B, SEQ)).astype(np.int32)}


def batch_name(case, cfg) -> str:
    """The stem of the ``.npz`` batch a case trains on: its own, else the
    token batch of its vocabulary."""
    return case.get("batch") or f"batch_{cfg.vocab}"


def run_reference(script: str, out_dir: Path, cases, *, devices: int = 4,
                  timeout: float = 600.0) -> None:
    """``script`` (one of the ``REF_*`` sources) in a subprocess with
    ``devices`` forced host devices; ``cases`` reach it as JSON."""
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", script, str(out_dir),
                        json.dumps(cases)], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]


def _rank_main(rank, fn, world, port, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world: int, *args, timeout: float = 300.0) -> None:
    """``fn(rank, world, *args)`` on every rank of a spawned gloo world."""
    ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"world of {world} did not finish in "
                               f"{timeout} s")


def close(got: float, want: float, what: str, rtol: float = RTOL) -> None:
    assert abs(got - want) <= rtol * max(1.0, abs(want)), (
        f"{what}: port {got} vs reference {want}")


# ---------------------------------------------------------------------------
# reference scripts
# ---------------------------------------------------------------------------

REF_PRELUDE = """
import dataclasses, json, sys
import jax, numpy as np
from repro import configs as cfgs
from repro.checkpoint import save_state
from repro.distributed import sharding as shd
from repro.launch.steps import init_state, make_train_step, state_shardings
from repro.models import flags as F
from repro.optim import AdamWConfig
from repro.runtime import build_mesh

out = sys.argv[1]
cases = json.loads(sys.argv[2])
"""

# Each case: initial state saved from the mesh (checkpoint step 0), then
# STEPS jitted meshed steps on the seeded batch; with "drops", the
# reference's moe_ep._bucket_by counts what its buckets drop through
# jax.debug.callback (every device, every call).
REF_TRAIN = REF_PRELUDE + """
from repro.models import moe_ep
drops = []
_orig = moe_ep._bucket_by
def _counted(dest, n_buckets, capacity):
    slot, tok = _orig(dest, n_buckets, capacity)
    n = jax.numpy.sum((dest < n_buckets) & (slot >= n_buckets * capacity))
    jax.debug.callback(lambda c: drops.append(int(c)), n)
    return slot, tok
moe_ep._bucket_by = _counted
for c in cases:
    F.set_moe_impl(c["moe_impl"]); F.set_attn_impl(c["attn"])
    F.set_moe_capacity(c["capacity"])
    F.set_moe_constrain(c.get("constrain", False))
    cfg = dataclasses.replace(cfgs.get_config(c["arch"], smoke=True),
                              dtype="float32")
    mesh = build_mesh((tuple(c["shape"]), tuple(c["axes"])))
    drops.clear()
    with mesh, shd.use_rules(shd.default_rules(mesh), mesh):
        tp = mesh.shape["model"]
        opt = AdamWConfig(lr=%(lr)r)
        ns = state_shardings(cfg, mesh, tp)
        step = jax.jit(make_train_step(cfg, opt, total_steps=%(total)d),
                       in_shardings=(ns, None), out_shardings=(ns, None))
        state = jax.device_put(init_state(cfg, opt, jax.random.PRNGKey(0)),
                               ns)
        save_state(state, f"{out}/{c['name']}/ckpt", 0)
        stem = c.get("batch") or f"batch_{cfg.vocab}"
        b = dict(np.load(f"{out}/{stem}.npz"))
        loss, gnorm = [], []
        for _ in range(%(steps)d):
            state, m = step(state, b)
            loss.append(float(m["loss"])); gnorm.append(float(m["grad_norm"]))
        jax.effects_barrier()
    np.savez(f"{out}/{c['name']}.npz", loss=np.array(loss),
             gnorm=np.array(gnorm), drops=np.array(sum(drops)))
""" % dict(lr=LR, total=TOTAL_STEPS, steps=STEPS)

# compressed_psum_tree inside shard_map over "pod" of a (2, 2, 1) mesh: pod
# p's leaves are x[p]; each case an (input stem, output stem) pair, by
# default ("pods", "compressed")
REF_COMPRESS = REF_PRELUDE + """
from jax.sharding import PartitionSpec as P
from repro.optim.compression import compressed_psum_tree
mesh = build_mesh(((2, 2, 1), ("pod", "data", "model")))
for src, dst in cases or [("pods", "compressed")]:
    x = dict(np.load(f"{out}/{src}.npz"))
    fn = jax.shard_map(
        lambda t: compressed_psum_tree(jax.tree.map(lambda a: a[0], t),
                                       "pod"),
        mesh=mesh, in_specs=(jax.tree.map(lambda _: P("pod"), x),),
        out_specs=jax.tree.map(lambda _: P(), x), axis_names={"pod"},
        check_vma=False)
    np.savez(f"{out}/{dst}.npz",
             **jax.tree.map(np.asarray, jax.jit(fn)(x)))
"""


# ---------------------------------------------------------------------------
# port ranks
# ---------------------------------------------------------------------------

def _cfg(arch: str, over=None):
    """``arch``'s smoke config in f32, with a case's ``over`` fields."""
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(arch, smoke=True),
                               dtype="float32", **(over or {}))


def _flags(case) -> None:
    from repro_torch.models import flags
    flags.set_moe_impl(case["moe_impl"])
    flags.set_attn_impl(case["attn"])
    flags.set_moe_capacity(case["capacity"])
    flags.set_moe_constrain(case.get("constrain", False))


def restore_reference(ckpt_dir, cfg, mesh=None, pls=None):
    """The reference's checkpoint (its stacked layout, read back by path)
    as the port's state, placed on ``mesh`` by ``pls``."""
    from repro_torch.checkpoint import read_tree
    from repro_torch.launch import steps
    state = steps.state_from_reference(read_tree(str(ckpt_dir), 0), cfg,
                                       "cpu")
    return state if pls is None else steps.place_state(state, pls, mesh)


def rank_train(rank, world, cases, out: str) -> None:
    """Each case on its mesh over the world: the reference's initial state
    restored and placed, STEPS meshed steps on the seeded batch; rank 0
    writes the metrics and the world's total of EP drops."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe_ep
    from repro_torch.optim import AdamWConfig

    for c in cases:
        _flags(c)
        cfg = _cfg(c["arch"])
        mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]),
                         device_type="cpu")
        with S.use_rules(S.default_rules(mesh), mesh):
            pls = steps.state_placements(cfg, mesh, S.axis_size("model"))
            state = restore_reference(Path(out) / c["name"] / "ckpt", cfg,
                                      mesh, pls)
            step = steps.make_train_step(cfg, AdamWConfig(lr=LR),
                                         total_steps=TOTAL_STEPS)
            b = dict(np.load(f"{out}/{batch_name(c, cfg)}.npz"))
            loss, gnorm = [], []
            with moe_ep.count_drops() as drops:
                for _ in range(STEPS):
                    state, m = step(state, b)
                    loss.append(float(m["loss"]))
                    gnorm.append(float(m["grad_norm"]))
            total = torch.tensor(sum(drops))
            dist.all_reduce(total)
        if rank == 0:
            np.savez(f"{out}/{c['name']}.port.npz", loss=np.array(loss),
                     gnorm=np.array(gnorm), drops=total.numpy())


def rank_compress(rank, world, out: str) -> None:
    """``compressed_psum_tree`` over the "pod" dim of a (2, 2, 1) mesh, pod
    p's leaves x[p]; rank 0 writes the result."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import compressed_psum_tree

    x = dict(np.load(f"{out}/pods.npz"))
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cpu")
    with S.use_rules(S.default_rules(mesh), mesh):
        pod = S.axis_index("pod")
        got = compressed_psum_tree({k: torch.from_numpy(v[pod])
                                    for k, v in x.items()}, "pod")
    if rank == 0:
        np.savez(f"{out}/compressed.port.npz",
                 **{k: v.numpy() for k, v in got.items()})


def _key(path: str) -> str:
    return path.replace("/", ".")


def rank_compress_step(rank, world, out: str) -> None:
    """The meshed step's cross-pod gradient exchange under
    ``compress_cross_pod``, on qwen1.5-0.5b's f32 smoke config (the port's
    own initial state from one seed) on (2, 2, 1) ("pod", "data", "model")
    over the world and on (2, 1, 1) over ranks 0 and 1.  For each mesh:
    every leaf's gradient from ``steps.reduce_grads`` compressed and
    uncompressed, gathered whole; each pod's own mean gradient (the
    compressed all-reduce's input), gathered whole, for the reference's
    ``compressed_psum_tree``; each pod's per-tensor int8 scale; the norm
    of the compressed gradient; then ``STEPS`` compressed train steps,
    with the first step's grad_norm and first moments (whole) and whether
    every leaf of the state is bit-equal across the pods after the last
    step.  Each mesh's rank 0 writes ``<mesh>.port.npz``."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_mesh
    from repro_torch.tree import tree_flatten, tree_paths

    _flags(dict(moe_impl="gather", attn="chunked", capacity=1.25))
    cfg = _cfg("qwen1.5-0.5b")
    opt = AdamWConfig(lr=LR)
    b = dict(np.load(f"{out}/batch_{cfg.vocab}.npz"))
    for name, shape in (("pod2x2x1", (2, 2, 1)), ("pod2x1x1", (2, 1, 1))):
        mesh = build_mesh((shape, ("pod", "data", "model")),
                          device_type="cpu")
        if rank >= int(np.prod(shape)):
            continue
        res = {}
        with S.use_rules(S.default_rules(mesh), mesh):
            pls = steps.state_placements(cfg, mesh, S.axis_size("model"))
            state = steps.place_state(
                steps.init_state(cfg, opt, torch.Generator().manual_seed(7),
                                 "cpu"), pls, mesh)
            keys = [_key(k) for k, _ in tree_paths(state["params"])]
            leaves = tree_flatten(state["params"])[0]
            ppl = [x.placements for x in leaves]
            local = tree_flatten(state["params"])[1](
                [x.to_local() for x in leaves])
            batch = steps.place_batch(b, "cpu", mesh)
            _, grads = steps.loss_and_grads(cfg, local, batch)
            whole = lambda gs: [S.full_tensor(S.wrap(g, pl)).numpy()
                                for g, pl in zip(gs, ppl)]
            gc = steps.reduce_grads(grads, ppl, mesh, True)
            g = steps.reduce_grads(grads, ppl, mesh, False)
            res["gnorm_c"] = float(steps.mesh_norm(gc, ppl, mesh))
            # each pod's mean: the in-pod sum times the pod count, its
            # shards gathered inside the pod (the pod dim taken as
            # replicated: the pods' values differ)
            pod_i = S._dim_names(mesh).index("pod")
            in_pod = [tuple(Replicate() if i == pod_i else p
                            for i, p in enumerate(pl)) for pl in ppl]
            pod_mean = [x * 2 for x in steps._sum_replicated(
                list(grads), ppl, mesh, skip=("pod",))]
            amax = [C.value_max(torch.amax(torch.abs(x)), axes)
                    for x, axes in zip(pod_mean, steps.shard_axes(ppl,
                                                                  mesh))]
            scales = torch.stack([torch.clamp(a, min=1e-12) / 127.0
                                  for a in amax])
            pod_scales = C.all_gather(scales[None], 0, "pod")
            means = [S.full_tensor(S.wrap(x, pl)).numpy()
                     for x, pl in zip(pod_mean, in_pod)]
            mean_pods = [C.all_gather(torch.from_numpy(m)[None], 0,
                                      "pod").numpy() for m in means]
            res.update({f"gc:{k}": v for k, v in zip(keys, whole(gc))})
            res.update({f"g:{k}": v for k, v in zip(keys, whole(g))})
            res.update({f"pods:{k}": v for k, v in zip(keys, mean_pods)})
            res["pod_scales"] = pod_scales.numpy()
            res["keys"] = np.array(keys)
            step = steps.make_train_step(cfg, opt, compress_cross_pod=True,
                                         total_steps=TOTAL_STEPS)
            for i in range(STEPS):
                state, m = step(state, b)
                if i == 0:
                    res["step_gnorm"] = float(m["grad_norm"])
                    res.update({f"m1:{_key(k)}": S.full_tensor(v).numpy()
                                for k, v in tree_paths(state["opt"]["m"])})
            same = True
            for k, v in tree_paths(state):
                x = v.to_local() if hasattr(v, "to_local") else v
                both = C.all_gather(x[None], 0, "pod")
                same &= bool(torch.equal(both[0], both[1]))
            res["pods_equal"] = same
        if rank == 0:
            np.savez(f"{out}/{name}.port.npz", **res)
            np.savez(f"{out}/{name}.pods.npz",
                     **{k[len("pods:"):]: v for k, v in res.items()
                        if k.startswith("pods:")})


# ---------------------------------------------------------------------------
# the elastic scenario (tests/test_elastic.py's, held to the reference)
# ---------------------------------------------------------------------------

# qwen1.5-0.5b (f32 smoke) on (2, 2): the initial state saved from the mesh,
# then 2 uninterrupted steps; and the reference's own re-mesh: its step-1
# state saved, restored on plan_remesh(2, model=1) = (2, 1), one more step
REF_ELASTIC = REF_PRELUDE + """
from repro.checkpoint import restore_state
from repro.runtime import plan_remesh
F.set_moe_impl("gather"); F.set_attn_impl("chunked"); F.set_moe_capacity(1.25)
cfg = dataclasses.replace(cfgs.get_config("qwen1.5-0.5b", smoke=True),
                          dtype="float32")
opt = AdamWConfig(lr=%(lr)r)
b = dict(np.load(f"{out}/batch_{cfg.vocab}.npz"))
mesh = build_mesh(((2, 2), ("data", "model")))
with mesh, shd.use_rules(shd.default_rules(mesh), mesh):
    ns = state_shardings(cfg, mesh, 2)
    step = jax.jit(make_train_step(cfg, opt, total_steps=%(total)d),
                   in_shardings=(ns, None), out_shardings=(ns, None))
    state = jax.device_put(init_state(cfg, opt, jax.random.PRNGKey(0)), ns)
    save_state(state, f"{out}/ref_ckpt", 0)
    state, m1 = step(state, b)
    save_state(state, f"{out}/ref_ckpt", 1)
    state, m2 = step(state, b)
plan = plan_remesh(2, model=1)
mesh_b = build_mesh(plan, devices=jax.devices()[:2])
with mesh_b, shd.use_rules(shd.default_rules(mesh_b), mesh_b):
    ns_b = state_shardings(cfg, mesh_b, 1)
    like = jax.eval_shape(lambda: init_state(cfg, opt, jax.random.PRNGKey(0)))
    st = restore_state(like, f"{out}/ref_ckpt", 1, shardings=ns_b)
    step_b = jax.jit(make_train_step(cfg, opt, total_steps=%(total)d),
                     in_shardings=(ns_b, None), out_shardings=(ns_b, None))
    st, mb = step_b(st, b)
np.savez(f"{out}/elastic.npz", loss=np.array([float(m1["loss"]),
         float(m2["loss"])]), remesh_loss=np.array(float(mb["loss"])),
         plan=np.array(plan[0]))
""" % dict(lr=LR, total=TOTAL_STEPS)


def rank_elastic(rank, world, out: str) -> None:
    """The port's scenario in a world of 4: the reference's step-0
    checkpoint restored on (2, 2), one step, the port's own checkpoint
    saved from all 4 ranks (host = rank), a second step; then that
    checkpoint restored on plan_remesh(2, model=1) over ranks 0 and 1, and
    on rank 0 alone without a mesh, each taking the second step again.
    Rank 0 writes the losses and whether the restored leaves equal the
    saved ones bit for bit."""
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_mesh, plan_remesh
    from repro_torch.tree import tree_map, tree_paths

    _flags(dict(moe_impl="gather", attn="chunked", capacity=1.25))
    cfg = _cfg("qwen1.5-0.5b")
    opt = AdamWConfig(lr=LR)
    b = dict(np.load(f"{out}/batch_{cfg.vocab}.npz"))
    make_step = lambda: steps.make_train_step(cfg, opt,
                                              total_steps=TOTAL_STEPS)
    res = {}
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with S.use_rules(S.default_rules(mesh), mesh):
        pls = steps.state_placements(cfg, mesh, 2)
        state = restore_reference(Path(out) / "ref_ckpt", cfg, mesh, pls)
        whole0 = tree_map(S.full_tensor, state)
        step = make_step()
        state, m1 = step(state, b)
        save_state(state, f"{out}/port_ckpt", 1, host_id=rank,
                   n_hosts=world)
        saved = dict(tree_paths(tree_map(S.full_tensor, state)))
        state, m2 = step(state, b)
        res["loss"] = [float(m1["loss"]), float(m2["loss"])]
    if rank == 0:
        ref0 = restore_reference(Path(out) / "ref_ckpt", cfg)
        res["ref_ckpt_exact"] = all(
            torch.equal(g, dict(tree_paths(ref0))[k])
            for k, g in tree_paths(whole0))
    plan = plan_remesh(2, model=1)
    mesh_b = build_mesh(plan, device_type="cpu")    # every rank builds it
    if rank < 2:
        with S.use_rules(S.default_rules(mesh_b), mesh_b):
            pls_b = steps.state_placements(cfg, mesh_b, 1)
            like = steps.abstract_state(cfg, opt)
            st = restore_state(like, f"{out}/port_ckpt", 1, device="cpu",
                               placements=pls_b, mesh=mesh_b)
            back = dict(tree_paths(tree_map(S.full_tensor, st)))
            res["remesh_exact"] = all(torch.equal(back[k], v)
                                      for k, v in saved.items())
            st, mb = make_step()(st, b)
            res["remesh_loss"] = float(mb["loss"])
    if rank == 0:
        st = restore_state(steps.abstract_state(cfg, opt), f"{out}/port_ckpt",
                           1, device="cpu")
        res["one_exact"] = all(torch.equal(dict(tree_paths(st))[k], v)
                               for k, v in saved.items())
        st, m1r = make_step()(st, b)
        res["one_loss"] = float(m1r["loss"])
        res["plan"] = list(plan[0])
        with open(f"{out}/elastic.port.json", "w") as f:
            json.dump(res, f)


# ---------------------------------------------------------------------------
# the dry run's counts, held to a real meshed step (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

def rank_dryrun_counts(rank, world, cases, out: str) -> None:
    """Each case's meshed step on real CPU tensors over gloo, under the dry
    run's counters (``dryrun.count_step`` with ``device="cpu"``, the
    case's flags as ``dryrun.count_cell`` sets them); rank 0 writes its
    FLOPs and collective bytes by kind, a case a JSON file."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig

    for c in cases:
        cfg = _cfg(c["arch"])
        shape = ShapeConfig(**c["shape"])
        mesh = make_mesh(tuple(c["mesh"]), tuple(c["axes"]),
                         device_type="cpu")
        if rank >= int(np.prod(c["mesh"])):
            continue
        with dryrun._flags(**c["flags"]):
            counts, _, _ = dryrun.count_step(
                cfg, shape, mesh, device="cpu",
                sparse_weights=c.get("sparsity", 0.0),
                min_dim=c.get("min_dim", 512))
        if rank == 0:
            with open(f"{out}/{c['name']}.json", "w") as f:
                json.dump({"flops": counts.flops, "coll": counts.coll}, f)


# ---------------------------------------------------------------------------
# meshed decode (tests/test_torch_mesh_decode.py)
# ---------------------------------------------------------------------------

DECODE_SEQ = 16      # the cache's length: every case fills it to the end
DECODE_SKIP = ("embed", "lm_head", "router", "conv_w")   # sparsify_params'

# Each case: the reference's params (f32 smoke config with the case's "cfg"
# fields, its own init_params from PRNGKey(0)) on the mesh; with "sparsity", every leaf that
# sparsify_params converts (2-D a layer, name outside its SKIP) pruned tp
# shard by tp shard with the port's block_prune, on the shard's (out, in)
# transpose in the reference's dry-run block of the whole weight
# (``_abstract_bcsr``'s: M / tp rows where tp divides M into rows of at
# least 8, else M; 128 columns where 128 divides N, else N), as
# ``sparse_weights.sparsify_shards`` prunes, where the shard's dims are at
# least "min_dim"; saved with its own save_state.  Then
# DECODE_SEQ jitted meshed T.decode_step calls at cur_len 0.. on the
# teacher-forced tokens (in_shardings from param_specs and
# decode_input_specs, the cache donated through out_shardings); the logits
# of every step and the last cache (saved) are the case's results.
REF_DECODE = REF_PRELUDE + """
import jax.numpy as jnp, torch
from jax.sharding import NamedSharding, PartitionSpec as RP
from repro.launch import specs as RS
from repro.models import transformer as T
from repro.models.config import ShapeConfig
from repro_torch.core.pruning import block_prune
SKIP = %(skip)r

def prune_shards(params, specs, tp, sparsity, min_dim):
    def one(path, w, spec):
        name = path[-1].key
        stacked = path[0].key == "stack"
        if name in SKIP or w.ndim - stacked != 2:
            return w
        w = np.asarray(w)
        n_in, n_out = w.shape[-2:]
        block = (n_out // tp if n_out %% tp == 0 and n_out // tp >= 8
                 else n_out, 128 if n_in %% 128 == 0 else n_in)
        axis = [i for i, e in enumerate(spec) if e == "tp"]
        parts = np.split(w, tp, axis=axis[0]) if axis else [w]
        out = []
        for part in parts:
            mats = part if stacked else part[None]
            if min(mats.shape[1:]) < min_dim:
                out.append(part)
                continue
            pruned = np.stack([block_prune(torch.from_numpy(np.array(m)).T,
                                           sparsity, block).T.numpy()
                               for m in mats])
            out.append(pruned if stacked else pruned[0])
        return jnp.asarray(np.concatenate(out, axis=axis[0]) if axis
                           else out[0])
    return jax.tree_util.tree_map_with_path(
        one, params, specs, is_leaf=lambda x: isinstance(x, RP))

for c in cases:
    F.set_moe_impl(c["moe_impl"]); F.set_attn_impl("chunked")
    F.set_moe_capacity(c["capacity"])
    cfg = dataclasses.replace(cfgs.get_config(c["arch"], smoke=True),
                              dtype="float32", **c.get("cfg", {}))
    mesh = build_mesh((tuple(c["shape"]), tuple(c["axes"])))
    b, s = c["batch"], %(seq)d
    with mesh, shd.use_rules(shd.default_rules(mesh), mesh):
        tp, dp = mesh.shape["model"], mesh.shape["data"]
        to_ns = lambda tree: jax.tree.map(
            lambda x: NamedSharding(mesh, shd.resolve(x)), tree,
            is_leaf=lambda x: isinstance(x, RP))
        pspecs = T.param_specs(cfg, tp)
        params = T.init_params(cfg, jax.random.PRNGKey(0))
        if c.get("sparsity"):
            params = prune_shards(params, pspecs, tp, c["sparsity"],
                                  c["min_dim"])
        save_state(params, f"{out}/{c['name']}/params", 0)
        _, parts = RS.decode_input_specs(
            cfg, ShapeConfig("decode_smoke", s, b, "decode"), tp, dp)
        cache_ns = to_ns(parts["cache"])
        step = jax.jit(lambda p, t, k, n: T.decode_step(p, cfg, t, k, n),
                       in_shardings=(to_ns(pspecs), to_ns(parts["tokens"]),
                                     cache_ns, None),
                       out_shardings=(None, cache_ns), donate_argnums=(2,))
        params = jax.device_put(params, to_ns(pspecs))
        cache = jax.device_put(T.init_cache(cfg, b, s), cache_ns)
        toks = np.load(f"{out}/tokens_{b}.npy")
        logits = []
        for i in range(s):
            lg, cache = step(params, toks[:, i:i + 1], cache, jnp.int32(i))
            logits.append(np.asarray(lg))
        save_state(cache, f"{out}/{c['name']}/cache", 0)
    np.save(f"{out}/{c['name']}.npy", np.stack(logits))
""" % dict(skip=DECODE_SKIP, seq=DECODE_SEQ)


def decode_tokens(vocab: int, batch: int, seed: int = 3) -> np.ndarray:
    """The seeded (batch, DECODE_SEQ) tokens every decode case is fed."""
    return np.random.RandomState(seed).randint(
        0, vocab, (batch, DECODE_SEQ)).astype(np.int32)


def rank_decode(rank, world, cases, out: str) -> None:
    """Each case on its mesh over the world: the reference's saved params
    placed (with "sparsity", each rank's tp shards converted by
    ``sparse_weights.sparsify_shards``), the cache placed, DECODE_SEQ
    ``serve_step`` calls on the teacher-forced tokens; rank 0 writes every
    step's logits (``decode_step``'s, gathered whole) and next tokens, the
    last cache by path (gathered whole), and for a sparse case its BCSR
    leaves as dense weights gathered whole.  Then the distributed argmax
    on crafted ties (``argmax.json``)."""
    from repro_torch.checkpoint import read_tree
    from repro_torch.core.sparse_format import BcsrMatrix, bcsr_to_dense
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import sparse_weights, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map, tree_paths

    decode_step = T.decode_step
    for c in cases:
        _flags(dict(c, attn="chunked"))
        cfg = _cfg(c["arch"], c.get("cfg"))
        b = c["batch"]
        mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]),
                         device_type="cpu")
        params = T.params_from_reference(
            read_tree(f"{out}/{c['name']}/params", 0), cfg, "cpu")
        toks = np.load(f"{out}/tokens_{b}.npy")
        res, seen = {}, []

        def recording(*a, **k):
            lg, cache = decode_step(*a, **k)
            seen.append(S.full_tensor(lg))
            return lg, cache

        with S.use_rules(S.default_rules(mesh), mesh):
            tp = S.axis_size("model")
            pls = tree_map(lambda s: S.placements(s, mesh),
                           T.param_specs(cfg, tp))
            placed = steps.place_state(params, pls, mesh)
            if c.get("sparsity"):
                placed = sparse_weights.sparsify_shards(
                    placed, cfg, c["sparsity"], min_dim=c["min_dim"])
                for k, w in tree_paths(placed):
                    if isinstance(w, BcsrMatrix):
                        dense = bcsr_to_dense(w).T.contiguous()
                        whole = sparse_weights.whole_but_tp(
                            dict(tree_paths(pls))[k], mesh)
                        res[f"bcsr:{k}"] = S.full_tensor(
                            S.wrap(dense, whole)).numpy()
            cache = steps.place_cache(T.init_cache(cfg, b, DECODE_SEQ, "cpu"),
                                      cfg, mesh, tp)
            serve = steps.make_serve_step(cfg)
            nxt = []
            T.decode_step = recording
            try:
                with torch.no_grad():
                    for i in range(DECODE_SEQ):
                        tk = steps.place_tokens(toks[:, i:i + 1], "cpu",
                                                mesh)
                        n, cache = serve(placed, tk, cache, i)
                        nxt.append(S.full_tensor(n).numpy())
            finally:
                T.decode_step = decode_step
            res.update({f"cache:{k}": S.full_tensor(v).numpy()
                        for k, v in tree_paths(cache)})
        if rank == 0:
            np.savez(f"{out}/{c['name']}.port.npz",
                     logits=torch.stack(seen).numpy(), next=np.stack(nxt),
                     **res)
    _rank_argmax(rank, out)


def _rank_argmax(rank, out: str) -> None:
    """``steps.mesh_argmax`` on (1, 4) over a vocabulary of 32 (8 a rank):
    row 0's maximum at global 9 and 25 (ranks 1 and 3), row 1's at 2 and
    5 (both on rank 0), row 2's on every rank at its first column, row 3's
    once at 31; rank 0 writes the result."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    full = torch.zeros(4, 32)
    full[0, [9, 25]] = 3.0
    full[1, [2, 5]] = 2.0
    full[2, [0, 8, 16, 24]] = 1.0
    full[3, 31] = 4.0
    with S.use_rules(S.default_rules(mesh), mesh):
        logits = S.distribute(full, (Replicate(), Shard(1)), mesh)
        got = S.full_tensor(steps.mesh_argmax(logits))
    if rank == 0:
        with open(f"{out}/argmax.json", "w") as f:
            json.dump({"got": got.tolist(),
                       "want": torch.argmax(full, -1).tolist()}, f)
