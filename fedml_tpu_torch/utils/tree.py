"""Parameter-tree utilities — counterpart of ``fedml_tpu/utils/tree.py``.

The port's tree is a flat ``{path: tensor}`` dict keyed by the reference's
flax path strings (``params/BasicBlock_0/Conv_0/kernel``). Its leaves are
taken in the order ``jax.tree`` flattens the reference's nested dicts: keys
sorted level by level (:func:`leaf_order`). Every function here returns its
dict in that order, so leaf ``i`` of a port tree is leaf ``i`` of the
reference's — what the stochastic codecs fold into their keys.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def leaf_order(keys: Iterable[str]) -> List[str]:
    """``keys`` in ``jax.tree`` flatten order: the path components compared
    level by level (which a plain sort of the joined strings is not, when a
    key holds a character below ``/``)."""
    return sorted(keys, key=lambda k: tuple(k.split("/")))


def tree_flatten(tree: Tree) -> Tuple[List[torch.Tensor], List[str]]:
    keys = leaf_order(tree)
    return [tree[k] for k in keys], keys


def tree_unflatten(keys: Sequence[str], leaves: Sequence[torch.Tensor]) -> Tree:
    return dict(zip(keys, leaves))


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    keys = leaf_order(tree)
    for other in rest:
        if set(other) != set(keys):
            raise ValueError("trees differ in their keys: "
                             f"{sorted(set(other) ^ set(keys))}")
    return {k: fn(tree[k], *(o[k] for o in rest)) for k in keys}


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Tree, scalar) -> Tree:
    return tree_map(lambda x: x * scalar, tree)


def tree_stack(trees: Sequence[Tree]) -> Tree:
    """Stack N trees with the same keys along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *trees)


def weighted_tree_sum(trees: Tree, weights) -> Tree:
    """Σ_i w_i · tree_i over the leading participant axis of stacked trees;
    ``weights`` (N,) should already be normalized. The weights take each
    leaf's dtype, as in the reference."""

    def _wsum(leaf):
        w = torch.as_tensor(weights, device=leaf.device).to(leaf.dtype)
        return torch.sum(leaf * w.reshape((-1,) + (1,) * (leaf.ndim - 1)), 0,
                         dtype=leaf.dtype)

    return tree_map(_wsum, trees)
