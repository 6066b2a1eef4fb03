"""Attack registry (for defense tests and research) — counterpart of
``fedml_tpu/core/security/attack/__init__.py``: byzantine, label flipping,
backdoor and edge-case backdoor, lazy worker and model replacement, and
the gradient-reconstruction attacks (``dlg``/``invert_gradient``,
``revealing_labels``)."""
from __future__ import annotations

from typing import Any

_REGISTRY = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def _load() -> None:
    from fedml_tpu_torch.core.security.attack import (  # noqa: F401
        backdoor,
        byzantine,
        dlg,
        label_flipping,
        lazy_worker,
        model_replacement,
        revealing_labels,
    )


def create_attacker(name: str, args: Any):
    _load()
    key = name.strip().lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown attack {name!r}; available: {available_attacks()}")
    return _REGISTRY[key](args)


def available_attacks() -> list:
    _load()
    return sorted(_REGISTRY)
