"""Logical-axis sharding rules (MaxText-style) on a ``DeviceMesh``.

Port of ``repro/distributed/sharding.py``.  Params and activations are
annotated with *logical* names; a rules table maps them to the mesh's named
dims at launch time, so the model code stays mesh-agnostic.

Logical names:
  fsdp  -- parameter / optimizer-state sharding (ZeRO-3) axis
  tp    -- tensor parallel axis (heads, d_ff columns, experts, vocab)
  dp    -- activation batch axis (pure data parallel, incl. the pod axis)
  sp    -- sequence parallel axis for long-context activations

The reference's constructs, here:

* ``PartitionSpec`` -> ``P``, a tuple of logical (or, after ``resolve``,
  mesh) names, one entry per tensor dim; ``resolve`` is the reference's
  logic, pure Python.
* ``NamedSharding`` -> DTensor placements on the mesh (``placements``,
  ``named_sharding``): ``Shard(d)`` on each mesh dim an entry names,
  ``Replicate()`` elsewhere.  A leaf sharded over two mesh dims on one
  tensor dim is chunked major dim first, as ``NamedSharding`` chunks it.
* ``with_sharding_constraint`` -> ``constrain``: a DTensor activation
  redistributed to the resolved placements through the port's own
  collectives (``collectives.py``) on the mesh dims' process groups; a
  no-op outside a mesh run.  DTensor's built-in redistribution is not used:
  its functional collectives crash (SIGSEGV, torch 2.11) on a gloo group
  with CUDA tensors, which is how ranks that share one card talk.

A tensor dim is sharded only where the mesh dims' product divides it; an
activation dim that does not divide stays whole on those mesh dims (the
reference pads it, the same function), a param or batch leaf that does not
divide is refused (``local_chunk``).
"""
from __future__ import annotations

import types
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Axis = Union[None, str, Tuple[str, ...]]

# The active rules and mesh, for the whole process (the reference keeps them
# per thread): the autograd engine runs a CUDA graph's backward, and the
# forward that activation checkpointing recomputes, on a thread of its own,
# which must see the mesh of the run.
_STATE = types.SimpleNamespace(rules=None, mesh=None)


class P(tuple):
    """A partition spec: one entry per leading tensor dim, each None, a
    name, or a tuple of names."""

    def __new__(cls, *entries: Axis) -> "P":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _dim_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def default_rules(mesh) -> Dict[str, Axis]:
    """DP over (pod, data); FSDP over data only (ZeRO gathers stay inside a
    pod, the cross-pod hop is pure gradient DP); TP/SP/EP over model."""
    has_pod = "pod" in _dim_names(mesh)
    return {
        "fsdp": "data",
        "tp": "model",
        "dp": ("pod", "data") if has_pod else ("data",),
        "sp": "model",
    }


def set_rules(rules: Optional[Dict[str, Axis]], mesh=None) -> None:
    _STATE.rules = rules
    _STATE.mesh = mesh


def get_rules() -> Optional[Dict[str, Axis]]:
    return _STATE.rules


def get_mesh():
    return _STATE.mesh


class use_rules:
    """Context manager: activate a rules table (and mesh) for a run."""

    def __init__(self, rules: Optional[Dict[str, Axis]], mesh=None):
        self.rules, self.mesh = rules, mesh

    def __enter__(self):
        self.prev = (get_rules(), get_mesh())
        set_rules(self.rules, self.mesh)
        return self

    def __exit__(self, *exc):
        set_rules(*self.prev)
        return False


def _mesh_axes() -> Sequence[str]:
    mesh = get_mesh()
    return _dim_names(mesh) if mesh is not None else ()


def resolve(spec: Sequence[Axis]) -> P:
    """Map a logical spec to mesh dim names.

    Unknown names map to None (replicated); tuples of names flatten.  A mesh
    dim may appear at most once per spec: when two logical names map to the
    same mesh dim, the first position keeps it and later positions drop to
    None.
    """
    rules = get_rules() or {}
    used: set = set()

    def one(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            out = []
            for e in entry:
                r = one(e)
                if isinstance(r, tuple):
                    out.extend(r)
                elif r is not None:
                    out.append(r)
            return tuple(out) if out else None
        r = rules.get(entry, entry if entry in _mesh_axes() else None)
        if r is None:
            return None
        axes = r if isinstance(r, tuple) else (r,)
        kept = tuple(a for a in axes if a not in used)
        used.update(kept)
        if not kept:
            return None
        return kept if isinstance(r, tuple) else kept[0]

    return P(*(one(e) for e in spec))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence[Axis], mesh=None, shape=None) -> tuple:
    """DTensor placements of a logical spec on ``mesh`` (the active one by
    default): ``Shard(d)`` on every mesh dim that entry d resolves to,
    ``Replicate()`` on the others.  With ``shape``, a tensor dim that the
    product of its mesh dims does not divide is left whole."""
    mesh = mesh if mesh is not None else get_mesh()
    names = _dim_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(resolve(spec)):
        axes = _axes(entry)
        if shape is not None:
            n = 1
            for a in axes:
                n *= mesh.size(names.index(a))
            if shape[d] % n:
                continue
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def named_sharding(spec: Sequence[Axis]) -> Optional[tuple]:
    """The placements of ``spec`` on the active mesh; None outside a mesh
    run."""
    if get_mesh() is None:
        return None
    return placements(spec)


def axis_size(axis: str, mesh=None) -> int:
    mesh = mesh if mesh is not None else get_mesh()
    return mesh.size(_dim_names(mesh).index(axis))


def axis_index(axis: str, mesh=None) -> int:
    mesh = mesh if mesh is not None else get_mesh()
    return mesh.get_local_rank(axis)


def tp_axis() -> Optional[str]:
    """The mesh dim the ``tp`` rule names, or None (no mesh, or no such
    dim)."""
    mesh = get_mesh()
    ax = (get_rules() or {}).get("tp")
    return ax if mesh is not None and ax in _dim_names(mesh) else None


def tp_size() -> int:
    ax = tp_axis()
    return axis_size(ax) if ax is not None else 1


# ---------------------------------------------------------------------------
# local shards of whole tensors, and back
# ---------------------------------------------------------------------------

def local_chunk(full: torch.Tensor, pls: Sequence, mesh=None) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``pls`` (a view): the mesh dims
    in order, each ``Shard(d)`` narrowing dim d to its coordinate's part.
    Raises where a sharded dim does not divide."""
    mesh = mesh if mesh is not None else get_mesh()
    out = full
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n, d = mesh.size(i), pl.dim
            if out.shape[d] % n:
                raise ValueError(f"dim {d} of shape {tuple(full.shape)} "
                                 f"does not split over {n} ranks")
            size = out.shape[d] // n
            out = out.narrow(d, mesh.get_local_rank(i) * size, size)
    return out


def distribute(full: torch.Tensor, pls: Sequence, mesh=None) -> DTensor:
    """A DTensor on ``mesh`` holding this rank's chunk of ``full`` (a copy):
    every rank holds ``full`` (drawn from one seed, or read from a
    checkpoint), so placing it moves no data."""
    mesh = mesh if mesh is not None else get_mesh()
    local = local_chunk(full, pls, mesh).contiguous().clone()
    return DTensor.from_local(local, mesh, tuple(pls), run_check=False)


def wrap(local: torch.Tensor, pls: Sequence) -> DTensor:
    return DTensor.from_local(local, get_mesh(), tuple(pls), run_check=False)


def map_local(fn, x: DTensor, *args, **kwargs) -> DTensor:
    """``fn`` on x's local tensor, wrapped back with x's placements: for
    functions that act along dims x is not sharded on."""
    return wrap(fn(x.to_local(), *args, **kwargs), x.placements)


def redistribute(x: DTensor, target: Sequence) -> DTensor:
    """``x`` with placements ``target`` (``Partial`` sources included),
    through ``collectives``: first every changed mesh dim, innermost
    first, to ``Replicate`` (all-gather or all-reduce), then the slices of
    the target's shards, outermost first."""
    from repro_torch.distributed import collectives as C

    mesh = get_mesh()
    names = _dim_names(mesh)
    cur = list(x.placements)
    target = tuple(target)
    if tuple(cur) == target:
        return x
    t = x.to_local()
    for i in reversed(range(len(cur))):
        if cur[i] == target[i] or isinstance(cur[i], Replicate):
            continue
        if isinstance(cur[i], Partial):
            if isinstance(target[i], Shard):
                t = C.reduce_scatter(t, target[i].dim, names[i])
                cur[i] = target[i]
                continue
            t = C.all_reduce(t, names[i])
        else:
            t = C.all_gather(t, cur[i].dim, names[i])
        cur[i] = Replicate()
    for i in range(len(cur)):
        if cur[i] != target[i]:
            assert isinstance(cur[i], Replicate) and isinstance(target[i],
                                                                Shard)
            n, d = mesh.size(i), target[i].dim
            size = t.shape[d] // n
            t = t.narrow(d, mesh.get_local_rank(i) * size, size)
            cur[i] = target[i]
    return wrap(t, target)


def constrain(x, *names: Axis):
    """``with_sharding_constraint`` by logical names: a DTensor is
    redistributed to the resolved placements; a no-op outside a mesh run
    (and on a plain tensor: single-device work inside one)."""
    mesh = get_mesh()
    if mesh is None or get_rules() is None or not isinstance(x, DTensor):
        return x
    return redistribute(x, placements(P(*names), mesh, tuple(x.shape)))


@torch.no_grad()
def full_tensor(x: DTensor) -> torch.Tensor:
    """The whole tensor of ``x`` on every rank (``DTensor.full_tensor``,
    through the port's collectives); a new tensor, never x's storage."""
    whole = (Replicate(),) * len(x.placements)
    local = x.to_local()
    if tuple(x.placements) == whole:
        return local.clone()
    with use_rules(get_rules() or {}, x.device_mesh):
        out = redistribute(x, whole).to_local()
    # sharded only over mesh dims of one rank: nothing was gathered
    if out.untyped_storage().data_ptr() == local.untyped_storage().data_ptr():
        out = out.clone()
    return out
