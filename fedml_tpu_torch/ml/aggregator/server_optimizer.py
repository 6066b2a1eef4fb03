"""Server-side optimizers on the aggregated pseudo-gradient — counterpart of
``fedml_tpu/ml/aggregator/server_optimizer.py``: FedOpt (adam or sgd with
momentum on g = w_global − w_aggregated, Reddi et al.), SCAFFOLD's server
sgd, and FedNova's τ_eff rescaling; FedAvg replaces the model. The optax
transforms are ``local_sgd``'s.

:meth:`ServerOptimizer.get_state` gives the state as optax's would
flatten: ``{"0": {"trace": {path: tensor}}}`` for sgd with momentum,
``{"0": {"count": ..., "mu": {...}, "nu": {...}}}`` for adam (the chain's
position, then the state's field, then the parameter path), which is
what a round checkpoint stores."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from fedml_tpu_torch.ml.trainer.local_sgd import ScaleByAdam, Trace, adam, sgd
from fedml_tpu_torch.utils.tree import Tree, leaf_order


class ServerOptimizer:
    """w_{t+1} = server_opt(w_t, pseudo_grad). FedAvg = plain replacement."""

    def __init__(self, args: Any):
        self.fed_opt = str(getattr(args, "federated_optimizer", "FedAvg"))
        name = str(getattr(args, "server_optimizer", "sgd")).lower()
        lr = float(getattr(args, "server_lr", 1.0))
        momentum = float(getattr(args, "server_momentum", 0.9))
        if self.fed_opt in ("FedOpt", "FedOpt_seq"):
            self.tx = adam(lr, b1=momentum) if name == "adam" else sgd(
                lr, momentum=momentum or None)
        elif self.fed_opt == "SCAFFOLD":
            self.tx = sgd(lr)
        else:
            self.tx = None
        self._opt_state = None

    # -- round-checkpoint plumbing ------------------------------------------------
    def get_state(self, params: Tree) -> Dict[str, Any]:
        """The optimizer state keyed as optax's (initialised first, as the
        reference forces it), each leaf a reference to the live tensor:
        :meth:`step` replaces the state, never mutates it."""
        if self.tx is None:
            return {}
        keys = leaf_order(params)
        if self._opt_state is None:
            self._opt_state = self.tx.init([params[k] for k in keys])
        out: Dict[str, Any] = {}
        for i, (t, s) in enumerate(zip(self.tx.transforms, self._opt_state)):
            if isinstance(t, Trace):
                out[str(i)] = {"trace": dict(zip(keys, s))}
            elif isinstance(t, ScaleByAdam):
                count, mu, nu = s
                out[str(i)] = {"count": torch.tensor(count, dtype=torch.int32),
                               "mu": dict(zip(keys, mu)), "nu": dict(zip(keys, nu))}
        return out

    def set_state(self, state: Dict[str, Any]) -> None:
        """The inverse of :meth:`get_state`."""
        if self.tx is None:
            return
        new = []
        for i, t in enumerate(self.tx.transforms):
            s = state.get(str(i), {})
            if isinstance(t, Trace):
                new.append([s["trace"][k] for k in leaf_order(s["trace"])])
            elif isinstance(t, ScaleByAdam):
                keys = leaf_order(s["mu"])
                new.append((int(s["count"]), [s["mu"][k] for k in keys],
                            [s["nu"][k] for k in keys]))
            else:
                new.append(None)
        self._opt_state = new

    def step(self, w_global: Tree, w_aggregated: Tree,
             tau_eff: Optional[float] = None) -> Tree:
        keys = leaf_order(w_global)
        if self.fed_opt == "FedNova" and tau_eff is not None:
            # x⁺ = anchor + τ_eff·(x̄ − anchor)
            t = float(tau_eff)
            return {k: w_global[k] + t * (w_aggregated[k] - w_global[k]) for k in keys}
        if self.tx is None:
            return w_aggregated
        g = [w_global[k] for k in keys]
        with torch.no_grad():
            pseudo_grad = [g_ - w_aggregated[k] for g_, k in zip(g, keys)]
            if self._opt_state is None:
                self._opt_state = self.tx.init(g)
            updates, self._opt_state = self.tx.update(pseudo_grad, self._opt_state, g)
            return {k: p + u for k, p, u in zip(keys, g, updates)}
