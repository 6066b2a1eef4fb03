"""Differential-privacy frame — the per-process singleton of
``fedml_tpu/core/dp/fedml_differential_privacy.py``, configured by
:meth:`FedMLDifferentialPrivacy.init` (``enable_dp``, ``dp_solution_type``
LDP / CDP / NbAFL, ``mechanism_type``, ``epsilon``, ``delta``,
``sensitivity``, ``clipping_norm``, ``max_epsilon``) and cleared by
:meth:`reset` between in-process runs.

The noise keys follow the reference's scheme: release ``c`` draws under
``fold_in(key(random_seed + 7919), c)``, split per leaf
(``mechanisms.noise_tree``), from the bit-exact threefry twin.

Streams. In the reference each cross-silo client is its own process with
its own singleton, so its counter (and its RDP accountant) counts only its
own releases. In-process silos share this process: a caller that passes
``stream=`` (a silo's rank) gets a counter and an accountant of its own,
exactly what that silo's process would hold, whatever order the threads
run in. ``stream=None`` is the process's own (the sp simulation's, and the
server's central noise).
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)

DP_LDP = "LDP"
DP_CDP = "CDP"
DP_NBAFL = "NbAFL"


class _Stream:
    """One release counter and its accountant."""

    def __init__(self, accountant):
        self.counter = 0
        self.accountant = accountant


class FedMLDifferentialPrivacy:
    _instance = None

    def __init__(self):
        self.is_enabled = False
        self.dp_solution = None
        self.frame = None
        self.clipping_norm = None
        self._args = None
        self._seed = 0
        self._lock = threading.Lock()
        self._streams: Dict[Optional[Hashable], _Stream] = {}

    @classmethod
    def get_instance(cls) -> "FedMLDifferentialPrivacy":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    def init(self, args: Any) -> None:
        self.is_enabled = bool(getattr(args, "enable_dp", False))
        if not self.is_enabled:
            return
        self.dp_solution = getattr(args, "dp_solution_type", DP_LDP)
        self._seed = int(getattr(args, "random_seed", 0)) + 7919
        self.clipping_norm = getattr(args, "clipping_norm", None)
        self._args = args
        from fedml_tpu_torch.core.dp.frames import build_dp_frame

        self.frame = build_dp_frame(self.dp_solution, args)
        self._streams = {}
        logger.info("DP enabled: %s", self.dp_solution)

    # -- predicates ----------------------------------------------------------
    def is_dp_enabled(self) -> bool:
        return self.is_enabled

    def is_local_dp_enabled(self) -> bool:
        return self.is_enabled and self.dp_solution in (DP_LDP, DP_NBAFL)

    def is_global_dp_enabled(self) -> bool:
        return self.is_enabled and self.dp_solution in (DP_CDP, DP_NBAFL)

    is_central_dp_enabled = is_global_dp_enabled

    def is_clipping(self) -> bool:
        return self.is_enabled and self.clipping_norm is not None

    # -- streams -------------------------------------------------------------
    def _stream(self, stream: Optional[Hashable]) -> _Stream:
        with self._lock:
            s = self._streams.get(stream)
            if s is None:
                acc = None
                if str(getattr(self._args, "mechanism_type", "gaussian")).lower() == "gaussian":
                    from fedml_tpu_torch.core.dp.budget_accountant import BudgetAccountant

                    acc = BudgetAccountant(self._args)
                s = self._streams[stream] = _Stream(acc)
            return s

    @property
    def accountant(self):
        """The process stream's RDP accountant (None for laplace)."""
        return self._stream(None).accountant if self.is_enabled else None

    def _next_keys(self, n: int, stream: Optional[Hashable]) -> List[threefry.Key]:
        """Account ``n`` releases on ``stream`` and take their keys."""
        s = self._stream(stream)
        with self._lock:
            if s.accountant is not None:
                s.accountant.check_budget(pending=n)
                s.accountant.record_release(n)
            first = s.counter + 1
            s.counter += n
        base = threefry.key(self._seed)
        return [threefry.fold_in(base, c) for c in range(first, first + n)]

    def counters(self) -> Dict[Optional[Hashable], int]:
        """Each open stream's release counter (``None``: the process's)."""
        with self._lock:
            return {k: s.counter for k, s in self._streams.items()}

    def set_counters(self, counters: Dict[Optional[Hashable], int]) -> None:
        """Restore release counters from a round checkpoint; the
        accountants start afresh, as the reference's do."""
        if not self.is_enabled:
            return
        for stream, value in counters.items():
            s = self._stream(stream)
            with self._lock:
                s.counter = int(value)

    def take_key_data(self, n: int, stream: Optional[Hashable] = None) -> np.ndarray:
        """Raw key data (``[n, 2]`` uint32) of the next ``n`` releases; each
        is accounted like :meth:`add_local_noise`."""
        return np.stack([threefry.key_data(k) for k in self._next_keys(n, stream)])

    def epsilon_spent(self, stream: Optional[Hashable] = None) -> float:
        """Total (ε, δ) spend of ``stream`` (RDP-composed); 0 when untracked."""
        if not self.is_enabled:
            return 0.0
        acc = self._stream(stream).accountant
        return acc.epsilon_spent() if acc is not None else 0.0

    # -- ops -----------------------------------------------------------------
    def add_local_noise(self, params: Tree, stream: Optional[Hashable] = None) -> Tree:
        return self.frame.add_local_noise(params, self._next_keys(1, stream)[0])

    def add_global_noise(self, params: Tree, stream: Optional[Hashable] = None) -> Tree:
        return self.frame.add_global_noise(params, self._next_keys(1, stream)[0])

    def global_clip(self, client_list: List[Tuple[int, Tree]]) -> List[Tuple[int, Tree]]:
        from fedml_tpu_torch.core.dp.frames.dp_clip import clip_update

        return [(n, clip_update(p, float(self.clipping_norm))) for n, p in client_list]
