"""DP frames: where the noise is applied — counterpart of
``fedml_tpu/core/dp/frames/__init__.py``.

- LDP: each client clips (with ``clipping_norm``) and noises its own update
  before upload;
- CDP: the server noises the aggregate;
- NbAFL (Wei et al.): the client's clip and noise and the server's noise.
"""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.dp.frames.dp_clip import clip_update
from fedml_tpu_torch.core.dp.mechanisms import build_mechanism
from fedml_tpu_torch.utils.tree import Tree


class BaseDPFrame:
    def __init__(self, args: Any):
        self.mechanism = build_mechanism(
            getattr(args, "mechanism_type", "gaussian"),
            float(getattr(args, "epsilon", 1.0)),
            float(getattr(args, "delta", 1e-5)),
            float(getattr(args, "sensitivity", 1.0)))
        self.clipping_norm = getattr(args, "clipping_norm", None)

    def add_local_noise(self, params: Tree, key: threefry.Key) -> Tree:
        return params

    def add_global_noise(self, params: Tree, key: threefry.Key) -> Tree:
        return params


class LocalDP(BaseDPFrame):
    def add_local_noise(self, params: Tree, key: threefry.Key) -> Tree:
        if self.clipping_norm is not None:
            params = clip_update(params, float(self.clipping_norm))
        return self.mechanism.add_noise(params, key)


class CentralDP(BaseDPFrame):
    def add_global_noise(self, params: Tree, key: threefry.Key) -> Tree:
        return self.mechanism.add_noise(params, key)


class NbAFL(LocalDP):
    """Clip and noise on both sides (NbAFL, IEEE TIFS'20)."""

    def add_global_noise(self, params: Tree, key: threefry.Key) -> Tree:
        return self.mechanism.add_noise(params, key)


def build_dp_frame(solution: str, args: Any) -> BaseDPFrame:
    solution = (solution or "LDP").upper()
    if solution == "LDP":
        return LocalDP(args)
    if solution == "CDP":
        return CentralDP(args)
    if solution == "NBAFL":
        return NbAFL(args)
    raise ValueError(f"unknown dp solution {solution!r}")
