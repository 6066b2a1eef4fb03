"""FedMLAttacker — the adversarial-injection singleton of
``fedml_tpu/core/security/attacker.py`` (for testing defenses), configured
by :meth:`FedMLAttacker.init` (``enable_attack``, ``attack_type`` and the
attack's own arguments) and cleared by :meth:`reset` between in-process
runs.

Data poisoning runs on the clients (``ClientTrainer``'s hook). In the
reference each cross-silo client is its own process with its own attacker,
so its generator draws only for its own data; in-process silos pass
``stream=`` (their rank) and get an attacker instance of their own, in the
state that silo's process would hold. Model attacks run on the server and
use the process's instance.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Hashable, List, Optional, Tuple

from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)


class FedMLAttacker:
    _instance = None

    def __init__(self):
        self.is_enabled = False
        self.attack_type: Optional[str] = None
        self.attacker = None
        self._args = None
        self._lock = threading.Lock()
        self._streams: Dict[Hashable, Any] = {}

    @classmethod
    def get_instance(cls) -> "FedMLAttacker":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    def init(self, args: Any) -> None:
        self.is_enabled = bool(getattr(args, "enable_attack", False))
        if not self.is_enabled:
            return
        self.attack_type = str(getattr(args, "attack_type", "")).strip().lower()
        from fedml_tpu_torch.core.security.attack import create_attacker

        self._args = args
        self.attacker = create_attacker(self.attack_type, args)
        self._streams = {}
        logger.info("attack enabled: %s", self.attack_type)

    # -- predicates (the reference's surface) --------------------------------
    def is_attack_enabled(self) -> bool:
        return self.is_enabled

    def is_data_poisoning_attack(self) -> bool:
        return self.is_enabled and getattr(self.attacker, "is_data_attack", False)

    def is_model_attack(self) -> bool:
        return self.is_enabled and getattr(self.attacker, "is_model_attack", False)

    def is_reconstruct_data_attack(self) -> bool:
        return self.is_enabled and getattr(self.attacker, "is_reconstruct", False)

    def is_to_poison_data(self) -> bool:
        return self.is_data_poisoning_attack()

    # -- ops -----------------------------------------------------------------
    def _attacker_for(self, stream: Optional[Hashable]):
        if stream is None:
            return self.attacker
        from fedml_tpu_torch.core.security.attack import create_attacker

        with self._lock:
            if stream not in self._streams:
                self._streams[stream] = create_attacker(self.attack_type, self._args)
            return self._streams[stream]

    def poison_data(self, dataset: Any, stream: Optional[Hashable] = None) -> Any:
        return self._attacker_for(stream).poison_data(dataset)

    def attack_model(self, raw_client_grad_list: List[Tuple[int, Tree]],
                     extra_auxiliary_info: Any = None) -> List[Tuple[int, Tree]]:
        return self.attacker.attack_model(raw_client_grad_list, extra_auxiliary_info)

    def reconstruct_data(self, a_gradient: Any, extra_auxiliary_info: Any = None) -> Any:
        return self.attacker.reconstruct_data(a_gradient, extra_auxiliary_info)
