"""L2 clipping of a model update — counterpart of
``fedml_tpu/core/dp/frames/dp_clip.py``."""
from __future__ import annotations

import torch

from fedml_tpu_torch.utils.tree import Tree, tree_leaves, tree_map


def tree_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm of every leaf together, in f32 on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_update(params: Tree, max_norm: float) -> Tree:
    """``params · min(1, max_norm / (‖params‖ + 1e-12))`` with no host sync."""
    norm = tree_norm(params)
    factor = torch.clamp_max(torch.tensor(float(max_norm), dtype=torch.float32,
                                          device=norm.device) / (norm + 1e-12), 1.0)
    return tree_map(lambda x: (x * factor).to(x.dtype), params)
