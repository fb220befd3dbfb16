"""What one rank's program costs, counted as it runs: the dry run's counters.

The reference gets these numbers from XLA (``compiled.cost_analysis()``,
``memory_analysis()`` and the collectives of the optimized HLO text); the
port runs eagerly, so it counts what its program does, op by op, while it
runs (on ``meta`` tensors in the dry run, on real ones in the tests that
hold the counts to a gloo world):

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the step
  (matrix products, convolutions and attention; elementwise ops count 0,
  as in XLA's ``flops``).  It cannot see inside a hand-written kernel (a
  launch is one opaque op, like a custom call to XLA), so the dry run adds
  the flash kernels' attention FLOPs analytically.  The BCSR matmul
  kernel is a registered op with a flop formula
  (``kernels/bsr_matmul/kernel.py``), counted as one op on every device.
* **Bytes**: the input and output bytes of every dispatched op that
  moves memory, each tensor at its local (this rank's) size.  An op that
  mutates nothing and whose every output shares an input's storage (a
  view, transpose, slice, select, expand, detach) moves none and adds 0.
  That is what the port's eager program moves: XLA counts after fusion,
  where a fused chain's intermediates never reach memory, so this count
  is higher than the reference's for the same math.
* **Collective bytes by kind**: the result bytes of every all-gather,
  all-reduce, reduce-scatter and all-to-all (broadcast, send and receive
  as ``collective-permute``), as the reference's ``collective_bytes`` sums
  result shapes.  They are counted at the dispatcher, where every eager
  c10d call passes (``distributed/collectives.py``'s and the train step's
  own ``dist.all_reduce`` alike), with the bytes of groups whose ranks
  span more than one node of ``GPUS_PER_NODE`` (``launch/roofline.py``
  prices those at the inter-node rate).
* **Peak live bytes**: the bytes of the storages the step makes (a
  ``meta`` tensor has a storage of its size, and no data), added as each
  is made and taken off as it is freed, over the step; storages of the
  arguments (state and inputs) are the arguments' bytes.

The counters hold one rank's program: in the dry run rank 0's, whose
numbers are per device as the reference's per-device SPMD module's are.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d operator name (without its trailing "_") -> the reference's kind
_KINDS = {"allgather": "all-gather", "_allgather_base": "all-gather",
          "allgather_into_tensor_coalesced": "all-gather",
          "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
          "reduce_scatter": "reduce-scatter",
          "_reduce_scatter_base": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "alltoall": "all-to-all", "alltoall_base": "all-to-all",
          "broadcast": "collective-permute", "send": "collective-permute",
          "recv": "collective-permute"}
# GPUs a node holds (an 8-GPU H100 board, the hopper-kernels guide, 1)
GPUS_PER_NODE = 8


@dataclasses.dataclass
class Counts:
    """One rank's counts over a step (``count``)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_cross_bytes: int = 0   # of those, on groups that span nodes
    peak_new_bytes: int = 0     # the most the step's own storages held
    live_new_bytes: int = 0     # what they hold at the end


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def local_tensors(tree, out: Optional[list] = None) -> list:
    """The tensors of ``tree`` (nested tuples, lists, dicts and
    dataclasses such as ``BcsrMatrix``), a DTensor as its local shard."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            local_tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            local_tensors(x, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            local_tensors(getattr(tree, f.name), out)
    return out


def storages(tree) -> Dict[int, int]:
    """The storages of ``tree``'s tensors (a DTensor's local shard): their
    bytes by identity."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in local_tensors(tree)}


def tree_bytes(tree) -> int:
    """Bytes of the tensors of ``tree``, each storage once."""
    return sum(storages(tree).values())


def _group_ranks(args) -> Optional[list]:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
            except RuntimeError:
                continue
    return None


def _aliases(ins: list, outs: list) -> bool:
    """Every output shares an input's storage: the op made a view."""
    held = {t.untyped_storage()._cdata for t in ins}
    return bool(outs) and all(t.untyped_storage()._cdata in held
                              for t in outs)


class _Counter(TorchDispatchMode):
    """Bytes of every op, collective result bytes by kind, and the live
    bytes of the storages the ops make."""

    def __init__(self, counts: Counts, known: Iterable[torch.Tensor]):
        super().__init__()
        self.c = counts
        self.known = set(storages(list(known)))
        self.live: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.c.live_new_bytes -= self.live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.live:
            return
        self.live[key] = st.nbytes()
        self.c.live_new_bytes += st.nbytes()
        self.c.peak_new_bytes = max(self.c.peak_new_bytes,
                                    self.c.live_new_bytes)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = local_tensors((args, kwargs)), local_tensors(out)
        if func._schema.is_mutable or not _aliases(ins, outs):
            self.c.hbm_bytes += sum(t.numel() * t.element_size()
                                    for t in ins + outs)
        for t in outs:
            self._track(t)
        kind = (_KINDS.get(func._opname.rstrip("_"))
                if func.namespace == "c10d" else None)
        if kind is not None:
            # the result: the first argument, the output tensor(s) or the
            # tensors reduced in place
            nbytes = sum(t.numel() * t.element_size()
                         for t in local_tensors(args[0]))
            self.c.coll[kind] += nbytes
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            if ranks and len({r // GPUS_PER_NODE for r in ranks}) > 1:
                self.c.coll_cross_bytes += nbytes
        return out


class count:
    """Context manager: ``Counts`` of everything run inside it.  ``known``
    is a tree of the tensors that exist before it (the step's arguments),
    whose storages are not the step's own."""

    def __init__(self, known: Any = ()):
        self.counts = Counts()
        self._known = local_tensors(known)

    def __enter__(self) -> Counts:
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        self._mode = _Counter(self.counts, self._known)
        self._mode.__enter__()
        return self.counts

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.counts.flops = float(self._flops.get_total_flops())
        return False

