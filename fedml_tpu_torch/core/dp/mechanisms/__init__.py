"""DP noise mechanisms (gaussian, laplace) on parameter trees; counterpart
of ``fedml_tpu/core/dp/mechanisms/__init__.py``.

The noise follows the reference's keys: the release key is split into one
key per leaf in the reference's leaf order (``threefry.split``), and each
leaf's noise is drawn in the reference's layout of that leaf and carried
into the port's (``models/convert``), so a leaf gets the noise the
reference would give it. The Gaussian sigma is the classic analytic bound
``sqrt(2 ln(1.25/δ))·Δ/ε``.
"""
from __future__ import annotations

import math
from typing import Callable

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.models.convert import _from_ref, _to_ref
from fedml_tpu_torch.utils.tree import Tree, tree_flatten


def gaussian_sigma(epsilon: float, delta: float, sensitivity: float) -> float:
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / epsilon


def noise_tree(params: Tree, key: threefry.Key, draw: Callable, scale: float) -> Tree:
    """``leaf + scale · draw(key_i, shape)`` per leaf, ``key_i`` the
    ``i``-th of ``split(key, n_leaves)``; the draw in the reference's
    layout, on the leaf's device."""
    leaves, keys = tree_flatten(params)
    subkeys = threefry.split(key, len(leaves))
    out = {}
    for i, (path, leaf) in enumerate(zip(keys, leaves)):
        ref_shape = tuple(_to_ref(path, leaf).shape)
        noise = _from_ref(path, draw(subkeys[i], ref_shape, leaf.device))
        out[path] = leaf + scale * noise.to(leaf.dtype)
    return out


def add_gaussian_noise(params: Tree, key: threefry.Key, sigma: float) -> Tree:
    return noise_tree(params, key, threefry.normal, sigma)


def add_laplace_noise(params: Tree, key: threefry.Key, scale: float) -> Tree:
    return noise_tree(params, key, threefry.laplace, scale)


class Gaussian:
    def __init__(self, epsilon: float, delta: float, sensitivity: float):
        self.sigma = gaussian_sigma(epsilon, delta, sensitivity)

    def add_noise(self, params: Tree, key: threefry.Key) -> Tree:
        return add_gaussian_noise(params, key, self.sigma)


class Laplace:
    def __init__(self, epsilon: float, delta: float, sensitivity: float):
        del delta
        self.scale = sensitivity / epsilon

    def add_noise(self, params: Tree, key: threefry.Key) -> Tree:
        return add_laplace_noise(params, key, self.scale)


def build_mechanism(name: str, epsilon: float, delta: float, sensitivity: float):
    name = (name or "gaussian").lower()
    if name == "gaussian":
        return Gaussian(epsilon, delta, sensitivity)
    if name == "laplace":
        return Laplace(epsilon, delta, sensitivity)
    raise ValueError(f"unknown DP mechanism {name!r}")
