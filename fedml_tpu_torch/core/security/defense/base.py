"""Defense base class and the shared tensor helpers — counterpart of
``fedml_tpu/core/security/defense/base.py``. Client updates are flattened
in the reference's leaf order into an ``N × D`` f32 matrix on their device;
every defense that works on it is invariant to the order of the
coordinates inside a leaf, which is where the port's layout differs."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.utils.tree import Tree, tree_flatten, tree_leaves


class BaseDefense:
    """A defense may hook any of the three aggregation phases."""

    def __init__(self, args: Any):
        self.args = args

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        return raw_client_grad_list

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        return base_aggregation_func(self.args, raw_client_grad_list)

    def defend_after_aggregation(self, global_model: Tree) -> Tree:
        return global_model


def tree_flatten_vector(tree: Tree) -> torch.Tensor:
    """Every leaf raveled into one f32 vector, in leaf order."""
    return torch.cat([x.reshape(-1).float() for x in tree_leaves(tree)])


def tree_unflatten_vector(vec: torch.Tensor, like: Tree) -> Tree:
    """The inverse of :func:`tree_flatten_vector`, in ``like``'s shapes and
    dtypes."""
    leaves, keys = tree_flatten(like)
    out, pos = {}, 0
    for k, leaf in zip(keys, leaves):
        n = leaf.numel()
        out[k] = vec[pos:pos + n].reshape(leaf.shape).to(leaf.dtype)
        pos += n
    return out


def stack_updates(raw_client_grad_list: List[Tuple[int, Tree]]):
    """``[(n_k, tree)]`` → (N×D f32 matrix, (N,) f32 sample counts, template)."""
    vecs = torch.stack([tree_flatten_vector(p) for _, p in raw_client_grad_list])
    counts = torch.tensor([float(n) for n, _ in raw_client_grad_list],
                          dtype=torch.float32, device=vecs.device)
    return vecs, counts, raw_client_grad_list[0][1]


def unstack_to_list(vecs: torch.Tensor, counts: torch.Tensor, template: Tree
                    ) -> List[Tuple[float, Tree]]:
    host = counts.cpu().tolist()
    return [(float(host[i]), tree_unflatten_vector(vecs[i], template))
            for i in range(vecs.shape[0])]


def pairwise_sq_dists(vecs: torch.Tensor) -> torch.Tensor:
    """N×N squared L2 distances through one gram product."""
    sq = torch.sum(vecs * vecs, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (vecs @ vecs.T)
    return torch.clamp_min(d, 0.0)


def median0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: the mean of the two middle values for an
    even count (``torch.median`` takes the lower one)."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5

