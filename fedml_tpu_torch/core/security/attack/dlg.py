"""DLG / InvertGradient — gradient-leakage data reconstruction, counterpart
of ``fedml_tpu/core/security/attack/dlg.py`` (Zhu et al. NeurIPS'19;
Geiping et al. NeurIPS'20).

Dummy data ``(x, y-logits)`` is optimised so that the model's gradient on
it matches the observed gradient (cosine distance by default, else the
squared error). The gradient of that match is a gradient of a gradient:
``loss_grad_fn`` builds the first one with ``create_graph=True`` and
``torch.autograd.grad`` differentiates through it. The dummies are drawn
as the reference draws them, ``normal`` under ``split(key(random_seed +
99991))`` from the threefry twin, and the optimiser is ``optax.adam``'s
update (``local_sgd.adam``). A model whose forward runs the flash-attention
kernels cannot be attacked: they have no second derivative, and neither has
the reference's ``custom_vjp``; their backward raises under
``create_graph=True``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack
from fedml_tpu_torch.ml.trainer.local_sgd import adam
from fedml_tpu_torch.utils.tree import tree_leaves


def _leaves(g: Any) -> List[torch.Tensor]:
    if isinstance(g, dict):
        return tree_leaves(g)
    return list(g)


@register("dlg")
@register("invert_gradient")
class DLGAttack(BaseAttack):
    is_reconstruct = True

    def __init__(self, args: Any):
        super().__init__(args)
        self.iters = int(getattr(args, "dlg_iters", 300))
        self.lr = float(getattr(args, "dlg_lr", 0.1))
        self.use_cosine = bool(getattr(args, "dlg_cosine", True))
        self._seed = int(getattr(args, "random_seed", 0)) + 99991
        self.losses: List[torch.Tensor] = []  # the match loss of each iteration

    def dummies(self, x_shape, num_classes: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The starting ``(x, y-logits)``: the reference's draws."""
        kx, ky = threefry.split(threefry.key(self._seed), 2)
        x = threefry.normal(kx, tuple(x_shape), device)
        y = threefry.normal(ky, (int(x_shape[0]), int(num_classes)), device)
        return x, y

    def reconstruct_data(self, a_gradient: Any, extra_auxiliary_info: Any = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Recover ``(x, softmax(y-logits))`` from an observed per-example
        gradient. ``extra_auxiliary_info`` provides ``loss_grad_fn(params,
        x, y_soft)`` → the gradient (a dict keyed like ``a_gradient``, or a
        sequence in its order) built with ``create_graph=True``, and
        ``params``, ``x_shape`` and ``num_classes``."""
        info = extra_auxiliary_info
        loss_grad_fn: Callable = info["loss_grad_fn"]
        params = info["params"]
        target = [g.detach().to(torch.float32) for g in _leaves(a_gradient)]
        device = target[0].device
        dummy_x, dummy_y = self.dummies(info["x_shape"], info["num_classes"], device)
        nb = torch.sqrt(sum(torch.vdot(b.flatten(), b.flatten()) for b in target))

        def match_loss(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
            leaves = [g.to(torch.float32) for g in
                      _leaves(loss_grad_fn(params, dx, torch.softmax(dy, -1)))]
            if self.use_cosine:
                num = sum(torch.vdot(a.flatten(), b.flatten())
                          for a, b in zip(leaves, target))
                na = torch.sqrt(sum(torch.vdot(a.flatten(), a.flatten()) for a in leaves))
                return 1.0 - num / (na * nb + 1e-12)
            return sum(torch.sum((a - b) ** 2) for a, b in zip(leaves, target))

        tx = adam(self.lr)
        xy = [dummy_x, dummy_y]
        state = tx.init(xy)
        self.losses = []
        for _ in range(self.iters):
            dx, dy = (t.detach().requires_grad_(True) for t in xy)
            loss = match_loss(dx, dy)
            # an input the match does not reach gets a zero gradient, as
            # jax.grad gives it
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
                (dx, dy), torch.autograd.grad(loss, [dx, dy], allow_unused=True))]
            self.losses.append(loss.detach())
            with torch.no_grad():
                updates, state = tx.update(grads, state, xy)
                xy = [p + u for p, u in zip(xy, updates)]
        return xy[0], torch.softmax(xy[1], -1)
