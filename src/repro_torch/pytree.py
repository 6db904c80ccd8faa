"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked the
way ``jax.tree_util`` walks them (dict keys in sorted order, NamedTuple
fields by name), so that paths, flattening order and the names built from
them are the JAX package's.

A path is a tuple of entries: ``("key", k)`` for a dict key, ``("idx", i)``
for a list or tuple position, ``("name", f)`` for a NamedTuple field.
Everything that is not a container is a leaf, tensors and anything else
(a capture tag, a Python number). This module is the port's only tree
walker: ``tree_map(lambda x: x, tree)`` copies the containers and keeps
the leaves (a shared basis stays one tensor).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Path = Tuple[Tuple[str, Any], ...]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, path: Path, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (("key", k),), out)
    elif _is_namedtuple(node):
        for f in node._fields:
            _walk(getattr(node, f), path + (("name", f),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (("idx", i),), out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order.
    The walkers here are module functions, not nested closures: a closure
    that calls itself is a reference cycle, which would keep every leaf it
    saw alive until Python's cyclic collector ran (gigabytes of a train
    step's trees)."""
    out: List[Tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tensors(tree) -> List[torch.Tensor]:
    """The leaves that are tensors, in flattening order."""
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _build(node, it):
    if isinstance(node, dict):
        done = {k: _build(node[k], it) for k in sorted(node)}
        return {k: done[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_build(getattr(node, f), it)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        seq = [_build(v, it) for v in node]
        return seq if isinstance(node, list) else tuple(seq)
    return next(it)


def unflatten(tree, new_leaves) -> Any:
    """A tree shaped like ``tree`` holding ``new_leaves`` in flattening
    order (new containers; dict keys keep ``tree``'s insertion order)."""
    it = iter(new_leaves)
    out = _build(tree, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map: the trees have different structures")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr``: ``.params['decoder'][0]``."""
    parts = []
    for kind, k in path:
        parts.append(f".{k}" if kind == "name" else
                     f"[{k}]" if kind == "idx" else f"[{k!r}]")
    return "".join(parts)


def joined(path: Path, sep: str) -> str:
    """The path's keys, indices and field names joined by ``sep`` (the
    checkpoint store's npz keys)."""
    return sep.join(str(k) for _, k in path)
