"""FA frame — the client analyzer and server aggregator ABCs, counterpart of
``fedml_tpu/fa/base_frame``. A task is a pair of operators, possibly
iterated over rounds (TrieHH, k-percentile), over the cross-silo FSM.

``device`` is where an operator keeps its tensors (a sketch's encoded
table, the fused merge); the plaintext operators hold none.
"""
from __future__ import annotations

import abc
from typing import Any, List, Optional, Tuple

import torch

from fedml_tpu_torch.device import DeviceLike, resolve_device

Payload = Any


class FAClientAnalyzer(abc.ABC):
    """Local analysis operator: (local data, server state) → submission."""

    def __init__(self, args: Any = None, device: DeviceLike = "cuda"):
        self.args = args
        self.id = 0
        self.device: torch.device = resolve_device(device)

    def set_id(self, analyzer_id: int) -> None:
        self.id = analyzer_id

    @abc.abstractmethod
    def local_analyze(self, data: Any, server_state: Payload,
                      round_idx: int) -> Payload:
        ...


class FAServerAggregator(abc.ABC):
    """Server reduction operator, iterated until it reports done.

    ``aggregate`` returns (next server_state, done, result); result is
    meaningful only when done is True.
    """

    def __init__(self, args: Any = None, device: DeviceLike = "cuda"):
        self.args = args
        self.device: torch.device = resolve_device(device)

    def init_state(self) -> Payload:
        """State broadcast with the first analyze request."""
        return None

    @abc.abstractmethod
    def aggregate(
        self,
        submissions: List[Tuple[int, Payload]],
        round_idx: int,
    ) -> Tuple[Payload, bool, Optional[Payload]]:
        ...
