"""Blockwise robust-aggregation math — counterpart of
``fedml_tpu/core/security/defense/blockwise.py``.

Every robust aggregator here decomposes into work on ``[N, C]`` slices of
the virtual ``N × D`` matrix of the clients' flattened updates, taken in
the reference's leaf order with a fixed block width, on the updates' own
device, so the device never holds the dense stack (a second copy of the N
client trees) at once:

- krum / pairwise distances — the gram ``G += X_b X_bᵀ``; distances follow
  from ``G`` alone (device memory N×C + N×N);
- coordinate-wise median / trimmed mean — per coordinate, block by block;
- geometric median — smoothed Weiszfeld, each iteration one
  distance-accumulation pass and one weighted-reduction pass.

Only the last block is narrower than the width: without a compiled program
per shape there is nothing to pad for.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.security.defense.base import median0, tree_unflatten_vector
from fedml_tpu_torch.utils.tree import Tree, tree_leaves

# 1<<22 f32 × N clients: 16.8 MB a client per block (ResNet-18, 11.2M
# parameters, streams in three blocks)
DEFAULT_BLOCK_ELEMS = 1 << 22


def flatten_clients(trees: Sequence[Tree]) -> List[List[torch.Tensor]]:
    """Per-client lists of raveled leaves (views where possible)."""
    return [[leaf.reshape(-1) for leaf in tree_leaves(t)] for t in trees]


def iter_blocks(flat_clients: List[List[torch.Tensor]],
                block_elems: int = DEFAULT_BLOCK_ELEMS
                ) -> Iterable[Tuple[torch.Tensor, int]]:
    """Yield ``(block [N, width] f32, width)`` slices of the virtual
    concatenated N×D matrix, on the clients' device."""
    n = len(flat_clients)
    dev = flat_clients[0][0].device
    left = sum(a.numel() for a in flat_clients[0])
    block, fill = None, 0
    for li in range(len(flat_clients[0])):
        size = flat_clients[0][li].numel()
        off = 0
        while off < size:
            if block is None:
                block = torch.empty((n, min(int(block_elems), left)),
                                    dtype=torch.float32, device=dev)
            take = min(block.shape[1] - fill, size - off)
            block[:, fill:fill + take] = torch.stack(
                [fc[li][off:off + take] for fc in flat_clients]).float()
            fill += take
            off += take
            if fill == block.shape[1]:
                yield block, fill
                left -= fill
                block, fill = None, 0


def pairwise_sq_dists_blockwise(blocks: Iterable[Tuple[torch.Tensor, Any]],
                                n: int) -> np.ndarray:
    """N×N squared L2 distances without the N×D stack: d_ij = g_ii + g_jj −
    2 g_ij from the accumulated gram, clamped at 0 (host float32)."""
    g = None
    for x, _ in blocks:
        g = x @ x.T if g is None else g + x @ x.T
    g = g.cpu().numpy()
    sq = np.diag(g)
    return np.maximum(sq[:, None] + sq[None, :] - 2.0 * g, 0.0)


def _trimmed_mean_block(x: torch.Tensor, k: int) -> torch.Tensor:
    xs = torch.sort(x, dim=0).values
    return torch.mean(xs[k:x.shape[0] - k], dim=0)


def coordinate_reduce_blockwise(trees: Sequence[Tree],
                                reduce_block: Callable[[torch.Tensor], torch.Tensor],
                                block_elems: int = DEFAULT_BLOCK_ELEMS) -> Tree:
    """A per-coordinate reduction over the client axis, block by block; a
    tree like one client's."""
    flat = flatten_clients(trees)
    out = torch.cat([reduce_block(x) for x, _ in iter_blocks(flat, block_elems)])
    return tree_unflatten_vector(out, trees[0])


def trimmed_mean_blockwise(trees, k: int, block_elems: int = DEFAULT_BLOCK_ELEMS) -> Tree:
    return coordinate_reduce_blockwise(trees, lambda x: _trimmed_mean_block(x, k),
                                       block_elems)


def coordinate_median_blockwise(trees, block_elems: int = DEFAULT_BLOCK_ELEMS) -> Tree:
    return coordinate_reduce_blockwise(trees, median0, block_elems)


def geometric_median_blockwise(trees: Sequence[Tree], weights: Sequence[float],
                               iters: int = 10, eps: float = 1e-8,
                               block_elems: int = DEFAULT_BLOCK_ELEMS) -> Tree:
    """Smoothed Weiszfeld over blocks: each iteration accumulates every
    client's squared distance to the estimate in one pass (host float64, as
    the reference), then rebuilds the estimate from the reweighted average
    in a second."""
    flat = flatten_clients(trees)
    n = len(flat)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def weighted(alpha: np.ndarray) -> torch.Tensor:
        a = None
        parts = []
        for x, _ in iter_blocks(flat, block_elems):
            if a is None:
                a = torch.as_tensor(alpha.astype(np.float32), device=x.device)
            parts.append(torch.einsum("n,nc->c", a, x))
        return torch.cat(parts)

    z = weighted(w)
    for _ in range(iters):
        sqd = torch.zeros(n, dtype=torch.float64, device=z.device)
        pos = 0
        for x, width in iter_blocks(flat, block_elems):
            d = x - z[None, pos:pos + width]
            sqd += torch.sum(d * d, dim=1).double()
            pos += width
        alpha = w / np.sqrt(sqd.cpu().numpy() + eps)
        z = weighted(alpha / alpha.sum())
    return tree_unflatten_vector(z, trees[0])


def stacked_bytes(raw_client_grad_list: List[Tuple[int, Tree]]) -> int:
    """f32 bytes the dense N×D stack would take."""
    d = sum(x.numel() for x in tree_leaves(raw_client_grad_list[0][1]))
    return 4 * len(raw_client_grad_list) * d


def should_go_blockwise(raw_client_grad_list, args: Any,
                        default_budget: int = 4 << 30) -> bool:
    """True when the dense stack would exceed the device budget
    (``defense_stack_budget_bytes``, default 4 GB)."""
    budget = int(getattr(args, "defense_stack_budget_bytes", 0) or default_budget)
    return stacked_bytes(raw_client_grad_list) > budget


def on_card(raw_client_grad_list) -> bool:
    """The updates live on a CUDA device: there the distance-based
    defenses (krum, the geometric median) always stream, since the N
    client trees are already resident and the dense stack would double
    them."""
    leaf = tree_leaves(raw_client_grad_list[0][1])[0]
    return leaf.device.type == "cuda"
