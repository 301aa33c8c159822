"""Nested dict / tuple / list trees of tensors: the port's counterpart of
the ``jax.tree`` helpers it needs. Dict keys are visited sorted, and a
leaf's path is its keys and indices joined by "/", as
``jax.tree_util.tree_flatten_with_path`` orders and the reference's
checkpoint manager names them ("segments/0/attn/srf/0/g")."""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import torch


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str,
                                                              torch.Tensor]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in leaves_with_path(tree)]


def map(fn: Callable, *trees):             # noqa: A001 (jax.tree.map)
    """``fn`` over the matching leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def unbind(tree, count: int) -> List:
    """The ``count`` slices along the leading axis of every leaf, from one
    ``torch.unbind`` per leaf: in the backward each leaf's slice
    gradients are stacked once (a ``select`` per slice would write a
    zero-filled full-size gradient for every slice)."""
    if isinstance(tree, dict):
        per = {k: unbind(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(count)]
    if isinstance(tree, (tuple, list)):
        per = [unbind(v, count) for v in tree]
        return [type(tree)(p[i] for p in per) for i in range(count)]
    return list(torch.unbind(tree, 0))
