"""The port, built for a CNN configuration.

The program's network (``repro_torch.models.cnn.NETWORKS[config
["network"]]``) is held to the configuration's own copy of the table: the
same convs in the same order at the same geometry and rates, and the same
FC layers, or set-up fails.  The benchmark's weights go to the port
through ``params_from_reference``, which builds the port's banks from
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Tuple

import torch

from escoin_bench import weights, yardstick
from escoin_bench.reference import cnn as ref


@dataclasses.dataclass
class Built:
    net: Any                         # the program's layer spec
    params: Dict[str, Any]           # the port's params (banks built)
    convs: List[Dict]                # the table's convs, geometry at 224
    fcs: List[Dict]
    weights: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    fc_seed: int
    nnz: Dict[str, int]

    @property
    def flops_per_image(self) -> float:
        return yardstick.forward_flops(self.convs, self.nnz, self.fcs, 1)


def in_shape(config: Dict[str, Any], image: int) -> Tuple[int, int, int]:
    return (config["in_channels"], image, image)


def check_program(net, config: Dict[str, Any], shape) -> None:
    """Raise unless the program lowers ``net`` to the table's convs and
    FC layers."""
    from repro_torch.engine import lower

    program = lower(net, shape)
    convs, fcs = ref.walk_shapes(config["layers"], shape)
    ours = [(c["name"], c["c"], c["h"], c["w"], c["m"], c["k"], c["stride"],
             c["pad"], c["sparsity"]) for c in convs]
    theirs = [(l.name, c, h, w, l.out_c, l.k, l.stride, l.pad,
               float(l.sparsity)) for l, (c, h, w) in program.conv_table]
    ours += [(f["name"], f["in_f"], f["out_f"]) for f in fcs]
    theirs += [(op.name, op.in_f, op.out_f) for op in program.fc_ops]
    if ours != theirs:
        i = next((i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b),
                 min(len(ours), len(theirs)))
        raise RuntimeError(
            f"{config['name']}: the program's {config['network']} differs "
            f"from the configuration's table at layer {i}: "
            f"{theirs[i:i + 1]} against {ours[i:i + 1]}")
    pruned = sum(1 for c in convs if c["sparsity"] > 0)
    if pruned != config["pruned_convs"]:
        raise RuntimeError(f"{config['name']}: {pruned} pruned convs, the "
                           f"configuration states {config['pruned_convs']}")


def build(config: Dict[str, Any], seed: int, image: int, device) -> Built:
    """Weights from the seed on ``device``, and the port's params; on the
    card, both conv libraries built first (at once, into the checkout's
    ``build/kernels``; a no-op once they are there)."""
    from repro_torch.engine.engine import params_from_reference
    from repro_torch.kernels import _build
    from repro_torch.models import cnn

    if torch.device(device).type == "cuda":
        _build.build(["sparse_conv", "bsr_conv"])

    shape = in_shape(config, image)
    net = cnn.NETWORKS[config["network"]]()
    check_program(net, config, shape)
    convs, fcs = ref.walk_shapes(config["layers"], shape)
    w = weights.conv_weights(convs, seed, device)
    fc_seed = weights.fc_seed(seed)
    host = {name: {"w": wb[0].cpu().numpy(), "b": wb[1].cpu().numpy()}
            for name, wb in w.items()}
    nnz = {name: int((h["w"] != 0).sum()) for name, h in host.items()}
    host["_fc_rng"] = fc_seed
    params = params_from_reference(host, device=device)
    return Built(net=net, params=params, convs=convs, fcs=fcs, weights=w,
                 fc_seed=fc_seed, nnz=nnz)


def ell_plan(program, batch: int) -> Dict[str, Any]:
    """Every pruned conv on the ELL kernel (the paper's direct sparse
    conv, the engine's ``pallas`` method, its schedule chosen by the
    kernel, its epilogue fused), every other conv on cuDNN."""
    from repro_torch.tuning.cache import PlanEntry

    return {op.name: (PlanEntry(method="pallas", fuse=True, pipeline=None)
                      if op.sparsity > 0 else PlanEntry(method="dense"))
            for op in program.conv_ops}


@contextlib.contextmanager
def timed_planner(spans: List[float]):
    """Record the host time of every ``plan_program`` call made inside
    the block (the engine and the server import it when they plan)."""
    from repro_torch.tuning import planner

    inner = planner.plan_program

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            spans.append(time.perf_counter() - t0)

    planner.plan_program = timed
    try:
        yield
    finally:
        planner.plan_program = inner


def layer_bounds(convs: List[Dict], nnz: Dict[str, int], report,
                 batch: int) -> List[Dict[str, Any]]:
    """Each conv's method as the engine's report says it runs, and the
    bound of its work at ``batch`` (``yardstick``)."""
    method = {o.name: o.method_executed for o in report.ops}
    return [dict(name=c["name"], method=method[c["name"]],
                 bound_s=yardstick.conv_bound_s(c, nnz[c["name"]], batch))
            for c in convs]
