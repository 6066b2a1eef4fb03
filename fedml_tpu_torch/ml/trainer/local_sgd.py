"""The client hot loop — counterpart of ``fedml_tpu/ml/trainer/local_sgd.py``.

``build_local_fn(apply_fn, args)`` returns

    run_local(params, state: LocalState, xs, ys, mask)
      -> (new_params, new_state, metrics)

over ``[steps, batch, ...]`` tensors and a ``[steps, batch]`` validity mask
(the reference's pad-and-mask batching), for FedAvg, FedProx, FedNova,
SCAFFOLD, FedDyn and Mime, with the reference's metrics (``train_loss``,
``train_correct``, ``train_samples``, ``local_steps``) as 0-d tensors on the
parameters' device: reading them is the caller's one sync per client.

The optimizer is optax's semantics written as functions on lists of
tensors (:func:`build_optimizer`): ``add_decayed_weights`` before ``sgd``,
momentum as optax's ``trace`` (g + μ·t, no dampening), ``adam`` and
``adamw`` with optax's moments and bias correction — not ``torch.optim``,
whose weight decay and momentum differ.

A fully padded step (mask all zero) is a no-op on the parameters, as in
the reference, but it still advances the optimizer state: the reference
runs ``tx.update`` on it and multiplies the update by 0. Its data-term
gradient is exactly zero, so the port skips that step's forward and
backward (the mask is on the host: no sync) and feeds the optimizer the
gradient of the regularizers alone (FedProx's and FedDyn's terms,
SCAFFOLD's correction), as the reference's program computes it.

Both programs are cataloged (``telemetry.profiling``) under the
reference's names: ``sp/local_train`` and ``sp/evaluate`` (one variant per
test-set shape by design, hence ``multi_shape``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from fedml_tpu_torch.utils.tree import Tree, leaf_order, tree_zeros_like
from fedml_tpu_torch.telemetry.profiling import repeated_cost, wrap_program

Leaves = List[torch.Tensor]


class LocalState(NamedTuple):
    """Algorithm extras threaded through local training (all optional trees).

    anchor: global params at round start (FedProx / FedDyn / SCAFFOLD / deltas)
    c_global/c_local: SCAFFOLD control variates (c_global: Mime's momentum)
    h: FedDyn per-client lagrangian accumulator
    """

    anchor: Tree
    c_global: Optional[Tree] = None
    c_local: Optional[Tree] = None
    h: Optional[Tree] = None


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels``:
    logsumexp(logits) − logits[y]."""
    y = y.long()
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, y[..., None])[..., 0])


def softmax_ce_loss(apply_fn: Callable) -> Callable:
    """``loss_fn(params, x, y, mask) -> (loss, (correct, denom))``: the
    masked mean cross-entropy; a sequence task ([B, T, V] logits) averages
    each row over T first. ``denom`` is max(Σ mask, 1)."""

    def loss_fn(params, x, y, mask):
        logits = apply_fn(params, x)
        ce = _ce(logits, y)
        if logits.ndim == 3:
            ce = ce.mean(-1)
        total = torch.sum(ce * mask)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        pred_ok = (torch.argmax(logits, -1) == y.long()).float()
        if logits.ndim == 3:
            pred_ok = pred_ok.mean(-1)
        correct = torch.sum(pred_ok * mask)
        return total / denom, (correct, denom)

    return loss_fn


# -- optax's transforms on lists of tensors -----------------------------------

class _Transform:
    def init(self, params: Leaves) -> Any:
        return None

    def update(self, updates: Leaves, state: Any, params: Leaves):
        raise NotImplementedError


class AddDecayedWeights(_Transform):
    def __init__(self, wd: float):
        self.wd = float(wd)

    def update(self, updates, state, params):
        return torch._foreach_add(updates, params, alpha=self.wd), state


class Trace(_Transform):
    """optax ``trace``: t ← g + decay·t; the update is t."""

    def __init__(self, decay: float):
        self.decay = float(decay)

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, updates, state, params):
        new = torch._foreach_add(updates, state, alpha=self.decay)
        return new, new


class ScaleByAdam(_Transform):
    """optax ``scale_by_adam`` (eps_root 0, no Nesterov)."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params):
        return (0, [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def update(self, updates, state, params):
        count, mu, nu = state
        mu = torch._foreach_add(torch._foreach_mul(updates, 1.0 - self.b1), mu,
                                alpha=self.b1)
        sq = torch._foreach_mul(updates, updates)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1.0 - self.b2), nu,
                                alpha=self.b2)
        count += 1
        # 1 − b^count in float32, as optax computes it
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        return torch._foreach_div(mu_hat, den), (count, mu, nu)


class Scale(_Transform):
    def __init__(self, step: float):
        self.step = float(step)

    def update(self, updates, state, params):
        return torch._foreach_mul(updates, self.step), state


class Chain(_Transform):
    """optax ``chain``: each transform's update feeds the next."""

    def __init__(self, *transforms: _Transform):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, updates, state, params):
        new_state = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state


def sgd(lr: float, momentum: Optional[float] = None) -> Chain:
    return Chain(*([Trace(momentum)] if momentum is not None else []), Scale(-lr))


def adam(lr: float, b1: float = 0.9) -> Chain:
    return Chain(ScaleByAdam(b1=b1), Scale(-lr))


def adamw(lr: float, weight_decay: float) -> Chain:
    return Chain(ScaleByAdam(), AddDecayedWeights(weight_decay), Scale(-lr))


def build_optimizer(args: Any) -> Chain:
    """The reference's client optimizer: ``add_decayed_weights(wd)`` when
    wd > 0, then sgd (momentum as ``trace``), adam or adamw (whose own
    decay is applied again, as in the reference)."""
    name = str(getattr(args, "client_optimizer", "sgd")).lower()
    lr = float(getattr(args, "learning_rate", 0.03))
    wd = float(getattr(args, "weight_decay", 0.0))
    momentum = float(getattr(args, "momentum", 0.0))
    chain: List[_Transform] = []
    if wd > 0:
        chain.append(AddDecayedWeights(wd))
    if name == "adam":
        chain.append(adam(lr))
    elif name == "adamw":
        chain.append(adamw(lr, wd))
    else:
        chain.append(sgd(lr, momentum if momentum > 0 else None))
    return Chain(*chain)


# the TF32 flags are process-wide: trainers on threads of one process (the
# in-process federations) share one save and restore, made by the first to
# enter and the last to leave
_FP32_LOCK = threading.Lock()
_FP32_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def fp32_precision(device: torch.device):
    """Run convolutions and matmuls on the card in full FP32, TF32 off: the
    simulation's rounds are held to the CPU and to the reference, and TF32
    would round every product's inputs to 10 bits. Restores the flags once
    no trainer of the process is inside."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _FP32_LOCK:
        if _FP32_STATE["depth"] == 0:
            _FP32_STATE["saved"] = (torch.backends.cudnn.allow_tf32,
                                    torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _FP32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_STATE["depth"] -= 1
            if _FP32_STATE["depth"] == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _FP32_STATE["saved"]


def build_local_fn(apply_fn: Callable, args: Any) -> Callable:
    """The local-training program (see module doc)."""
    fed_opt = str(getattr(args, "federated_optimizer", "FedAvg"))
    mu = float(getattr(args, "fedprox_mu", 0.1))
    feddyn_alpha = float(getattr(args, "feddyn_alpha", 0.01))
    mime_beta = float(getattr(args, "mime_beta", 0.9))
    lr = float(getattr(args, "learning_rate", 0.03))
    base_loss = softmax_ce_loss(apply_fn)
    tx = build_optimizer(args)

    def reg_loss(p: Leaves, state_l: Dict[str, Leaves]) -> Optional[torch.Tensor]:
        """FedProx's / FedDyn's term of the loss (None for the others)."""
        if fed_opt == "FedProx":
            return 0.5 * mu * sum(torch.sum((x - a) ** 2)
                                  for x, a in zip(p, state_l["anchor"]))
        if fed_opt == "FedDyn":
            lin = sum(torch.sum(h * x) for h, x in zip(state_l["h"], p))
            quad = 0.5 * feddyn_alpha * sum(torch.sum((x - a) ** 2)
                                            for x, a in zip(p, state_l["anchor"]))
            return -lin + quad
        return None

    def value_and_grad(keys, p: Leaves, state_l, x, y, m, valid: bool):
        """(loss, correct, denom, grads) of one step at params ``p``."""
        if valid:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in p]
                loss, (correct, denom) = base_loss(dict(zip(keys, leaves)), x, y, m)
                reg = reg_loss(leaves, state_l)
                if reg is not None:
                    loss = loss + reg
                grads = list(torch.autograd.grad(loss, leaves))
            return loss.detach(), correct.detach(), denom.detach(), grads
        # fully padded: the data term and its gradient are exactly 0 and
        # denom is max(0, 1) = 1; only the regularizers remain
        zero = p[0].new_zeros(())
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in p]
            reg = reg_loss(leaves, state_l)
            if reg is None:
                return zero, zero, zero + 1.0, [torch.zeros_like(t) for t in p]
            loss = zero / 1.0 + reg
            grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), zero, zero + 1.0, grads

    def run_local(params: Tree, state: LocalState, xs: torch.Tensor,
                  ys: torch.Tensor, mask: torch.Tensor,
                  valid_steps: Optional[np.ndarray] = None):
        keys = leaf_order(params)
        p = [params[k].detach().clone() for k in keys]
        state_l = {f: ([getattr(state, f)[k] for k in keys]
                       if getattr(state, f) is not None else None)
                   for f in LocalState._fields}
        if valid_steps is None:
            valid_steps = (mask.detach().cpu().numpy().sum(1) > 0)
        n_steps = int(xs.shape[0])
        opt_state = tx.init(p)
        # every step of a kind (valid or padded) does the same work: the
        # program catalog counts one of each (repeated_cost)
        n_valid = int(np.sum(valid_steps[:n_steps]))
        n_of = {True: n_valid, False: n_steps - n_valid}

        mime_full_grad = None
        if fed_opt == "Mime":
            # full-batch local gradient at the round anchor: one masked pass
            gsum = [torch.zeros_like(t) for t in p]
            wsum = p[0].new_zeros(())
            for i in range(n_steps):
                valid = bool(valid_steps[i])
                with repeated_cost(("mime_full_grad", valid), n_of[valid]):
                    _, _, _, g = value_and_grad(keys, state_l["anchor"], state_l,
                                                xs[i], ys[i], mask[i], valid)
                    w = torch.sum(mask[i])
                    torch._foreach_add_(gsum, torch._foreach_mul(g, w))
                    wsum = wsum + w
            mime_full_grad = torch._foreach_div(gsum, torch.clamp(wsum, min=1.0))

        losses, corrects, denoms = [], [], []
        for i in range(n_steps):
            valid = bool(valid_steps[i])
            with repeated_cost(("step", valid), n_of[valid]):
                loss, correct, denom, grads = value_and_grad(
                    keys, p, state_l, xs[i], ys[i], mask[i], valid)
                with torch.no_grad():
                    if fed_opt == "SCAFFOLD" and state_l["c_global"] is not None:
                        grads = torch._foreach_sub(
                            torch._foreach_add(grads, state_l["c_global"]),
                            state_l["c_local"])
                    if fed_opt == "Mime":
                        _, _, _, g_anchor = value_and_grad(
                            keys, state_l["anchor"], state_l, xs[i], ys[i], mask[i], valid)
                        grads = torch._foreach_add(torch._foreach_sub(grads, g_anchor),
                                                   mime_full_grad)
                        updates = torch._foreach_add(
                            torch._foreach_mul(grads, 1.0 - mime_beta),
                            state_l["c_global"], alpha=mime_beta)
                        updates = torch._foreach_mul(updates, -lr)
                    else:
                        updates, opt_state = tx.update(grads, opt_state, p)
                    if valid:  # a padded step's update is multiplied by 0
                        torch._foreach_add_(p, updates)
            losses.append(loss)
            corrects.append(correct)
            denoms.append(denom)

        tau = float(np.sum(valid_steps))  # the non-padded optimizer steps
        with torch.no_grad():
            if fed_opt == "FedNova":
                safe_tau = max(tau, 1.0)
                p = [a - (a - x) / safe_tau for a, x in zip(state_l["anchor"], p)]
            new_state = state
            if fed_opt == "SCAFFOLD":
                coef = 1.0 / (n_steps * lr)
                new_c = [cl - cg + coef * (a - x) for cl, cg, a, x in zip(
                    state_l["c_local"], state_l["c_global"], state_l["anchor"], p)]
                new_state = state._replace(c_local=dict(zip(keys, new_c)))
            elif fed_opt == "FedDyn":
                new_h = [h - feddyn_alpha * (x - a) for h, x, a in zip(
                    state_l["h"], p, state_l["anchor"])]
                new_state = state._replace(h=dict(zip(keys, new_h)))
            metrics = {
                "train_loss": torch.stack(losses).mean(),
                "train_correct": torch.stack(corrects).sum(),
                "train_samples": torch.stack(denoms).sum(),
                "local_steps": p[0].new_tensor(tau),
            }
            if mime_full_grad is not None:
                metrics["mime_full_grad"] = dict(zip(keys, mime_full_grad))
        return dict(zip(keys, p)), new_state, metrics

    return wrap_program("sp/local_train", run_local)


def init_local_state(params: Tree, args: Any) -> LocalState:
    fed_opt = str(getattr(args, "federated_optimizer", "FedAvg"))
    zeros = tree_zeros_like(params)
    # SCAFFOLD: c_global/c_local are control variates; Mime: c_global holds
    # the SERVER momentum s (fixed during local steps — Mime's invariant)
    return LocalState(
        anchor=params,
        c_global=zeros if fed_opt in ("SCAFFOLD", "Mime") else None,
        c_local=zeros if fed_opt == "SCAFFOLD" else None,
        h=zeros if fed_opt == "FedDyn" else None,
    )


def build_evaluator(apply_fn: Callable, chunk: int = 4096) -> Callable:
    """``evaluate(params, x, y) -> (loss_sum, correct, count)`` as 0-d
    tensors, over the whole set in chunks of ``chunk`` rows (sums over
    rows, so the chunking changes nothing but the summation order)."""

    @torch.no_grad()
    def evaluate(params: Tree, x: torch.Tensor, y: torch.Tensor):
        loss_sum = x.new_zeros((), dtype=torch.float32)
        correct = x.new_zeros((), dtype=torch.float32)
        for s in range(0, max(int(x.shape[0]), 1), chunk):
            logits = apply_fn(params, x[s:s + chunk])
            yc = y[s:s + chunk]
            ce = _ce(logits, yc)
            ok = (torch.argmax(logits, -1) == yc.long()).float()
            if logits.ndim == 3:
                ce, ok = ce.mean(-1), ok.mean(-1)
            loss_sum = loss_sum + ce.sum()
            correct = correct + ok.sum()
        return loss_sum, correct, float(y.shape[0])

    return wrap_program("sp/evaluate", evaluate, multi_shape=True)


__all__ = ["LocalState", "softmax_ce_loss", "build_optimizer", "build_local_fn",
           "init_local_state", "build_evaluator", "fp32_precision", "sgd",
           "adam", "adamw", "Chain"]
