"""Defense registry — counterpart of
``fedml_tpu/core/security/defense/__init__.py``: eighteen defense modules
under the reference's registered names (23 with the aliases). Their
numeric work runs on the stacked ``N × D`` update matrix, or block by
block (:mod:`.blockwise`), on the updates' device.

The reference registers ``cross_round`` twice, in ``cross_round`` and then
in ``outlier_detection``; the modules load in the same order, so the name
resolves to the same class as there (``OutlierDetectionDefense``).
"""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.core.security.defense.base import BaseDefense

_REGISTRY = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def _load() -> None:
    from fedml_tpu_torch.core.security.defense import (  # noqa: F401
        bulyan,
        cclip,
        cross_round,
        coord_median,
        crfl,
        foolsgold,
        geometric_median,
        krum,
        norm_diff_clipping,
        outlier_detection,
        residual_reweight,
        robust_learning_rate,
        slsgd,
        soteria,
        three_sigma,
        trimmed_mean,
        weak_dp,
        wbc,
    )


def create_defender(name: str, args: Any) -> BaseDefense:
    _load()
    key = name.strip().lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown defense {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key](args)


def available_defenses() -> list:
    _load()
    return sorted(_REGISTRY)
