"""Attack registry (for defense tests and research) — counterpart of
``fedml_tpu/core/security/attack/__init__.py``: byzantine, label flipping,
backdoor and edge-case backdoor, lazy worker and model replacement. The
gradient-reconstruction attacks (``dlg``/``invert_gradient``,
``revealing_labels``) are registered names that come with ROADMAP A10.2c;
creating one raises."""
from __future__ import annotations

from typing import Any

_REGISTRY = {}

# registered in the reference; ported with ROADMAP A10.2c
_A10_2C = ("dlg", "invert_gradient", "revealing_labels", "revealing_labels_from_gradients")


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def _load() -> None:
    from fedml_tpu_torch.core.security.attack import (  # noqa: F401
        backdoor,
        byzantine,
        label_flipping,
        lazy_worker,
        model_replacement,
    )


def create_attacker(name: str, args: Any):
    _load()
    key = name.strip().lower()
    if key in _A10_2C:
        raise NotImplementedError(
            f"attack {key!r}: the gradient-reconstruction attacks come with "
            "ROADMAP A10.2c")
    if key not in _REGISTRY:
        raise ValueError(f"unknown attack {name!r}; available: {available_attacks()}")
    return _REGISTRY[key](args)


def available_attacks() -> list:
    _load()
    return sorted(set(_REGISTRY) | set(_A10_2C))
