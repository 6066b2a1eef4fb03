"""Revealing labels from gradients (label-leakage attack).

A copy of ``fedml_tpu/core/security/attack/revealing_labels.py``
(Wainakh et al. / iDLG-style label restoration). For softmax
cross-entropy the classifier-layer gradient decomposes as
g_c = Σ_i (p_c^i − 1[y_i = c]): every occurrence of class c subtracts
exactly 1 from row/bias c while the softmax terms add only p_c ∈ (0,1).
The attack inverts that: estimate Σ_i p_c^i (uniform 1/C prior at an
untrained model, the paper's setting) and round

    count_c = round(B·(1/C) − B·g_c)            (bias gradient)

where g_c is the MEAN gradient over the batch of size B. Without a bias
term the per-class score falls back to the weight-gradient row sums,
whose sign/magnitude carry the same signal.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack

Pytree = Any


def _host(a: Any) -> np.ndarray:
    """A gradient (a tensor on any device, or an array) as float64 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


@register("revealing_labels")
@register("revealing_labels_from_gradients")
class RevealingLabelsAttack(BaseAttack):
    is_reconstruct = True

    def __init__(self, args: Any):
        super().__init__(args)

    def reconstruct_data(self, a_gradient: Pytree,
                         extra_auxiliary_info: Any = None) -> Dict[int, int]:
        """Recover the victim batch's label histogram.

        ``extra_auxiliary_info``: {"batch_size": B, "num_classes": C,
        "bias_grad": mean bias gradient [C]  (or "weight_grad": [F, C] /
        [C, F] classifier weight gradient)}, as tensors on any device or
        arrays; the counting is host numpy.
        Returns {class → estimated count}, Σ counts == B.
        """
        info = extra_auxiliary_info or {}
        batch = int(info["batch_size"])
        num_classes = int(info["num_classes"])
        g = info.get("bias_grad")
        if g is None:
            wg = _host(info["weight_grad"])
            # orient to [.., C] and collapse the feature axis: row sums of
            # the classifier gradient behave like a scaled bias gradient
            if wg.shape[0] == num_classes and wg.shape[-1] != num_classes:
                wg = wg.T
            g = wg.sum(axis=0)
        g = _host(g)
        # count_c ≈ B/C − B·g_c, projected to a valid histogram of size B
        raw = batch / num_classes - batch * g
        counts = np.maximum(0, np.rint(raw)).astype(int)
        # repair rounding drift so Σ counts == B exactly: add/remove where
        # the unrounded residual points (largest fractional surplus /
        # smallest count first). Terminates: adding is always possible,
        # and drift < 0 implies some count > 0 each pass.
        drift = batch - int(counts.sum())
        resid = raw - counts
        order = np.argsort(-resid) if drift > 0 else np.argsort(resid)
        while drift != 0:
            progressed = False
            for c in order:
                if drift == 0:
                    break
                step = 1 if drift > 0 else -1
                if counts[c] + step >= 0:
                    counts[c] += step
                    drift -= step
                    progressed = True
            if not progressed:  # all counts 0 and drift < 0: impossible,
                break           # but never loop forever on bad input
        return {c: int(counts[c]) for c in range(num_classes)}
