"""The port's trees: nested dicts and lists whose leaves are tensors (or
other values), as the JAX package's pytrees are.

``tree_flatten`` walks dicts in insertion order and lists in index order;
``tree_paths`` names each leaf by its keys and indices joined with ``/``,
as ``jax.tree_util.tree_flatten_with_path`` names them in the reference's
checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in walk order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out.extend(tree_paths(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _build(node: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(node, dict):
        return {k: _build(v, leaves) for k, v in node.items()}
    if isinstance(node, list):
        return [_build(v, leaves) for v in node]
    return next(leaves)


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves in walk order, rebuild) with ``rebuild(leaves)`` the tree of
    the same structure holding the given leaves.  (A module-level builder,
    not a recursive closure: a closure that calls itself is a reference
    cycle, and would keep every tree it built alive until Python's cyclic
    collector ran.)"""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    return leaves, lambda new: _build(tree, iter(new))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    leaves, rebuild = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return rebuild([fn(*args) for args in zip(leaves, *others)])
