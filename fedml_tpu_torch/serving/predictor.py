"""FedMLPredictor — the serving-side model operator (counterpart of
``fedml_tpu/serving/predictor.py``): ``predict(request)`` takes the decoded
JSON request body and returns a JSON-serializable response or an iterator
of JSON-serializable chunks (streaming generation).
"""
from __future__ import annotations

import abc
from typing import Any


class FedMLPredictor(abc.ABC):
    """Subclass and implement :meth:`predict`; hand to FedMLInferenceRunner."""

    def ready(self) -> bool:
        """Liveness: the runner's /ready endpoint reports this."""
        return True

    @abc.abstractmethod
    def predict(self, request: Any) -> Any:
        """request (decoded JSON) → response or an iterator of chunks."""
