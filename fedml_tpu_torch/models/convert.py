"""Carry simulation-model weights between the reference and the port.

The port's tree (``models/layers.py``) has the reference's leaves under
the reference's flax paths (``params/BasicBlock_0/Conv_0/kernel``); what
differs is the layout of the kernels:

* a Dense or LSTM-gate kernel ``[in, out]`` is ``[out, in]`` in the port;
* a Conv kernel HWIO is OIHW in the port;
* Embed tables, biases and GroupNorm scales are the same.

:func:`from_flax_params` takes a nested flax params tree of numpy (or JAX)
arrays and gives the port's dict; :func:`to_flax_params` gives back the
nested tree of numpy arrays. :func:`to_reference_layout` /
:func:`from_reference_layout` switch one port tree between the layouts
without renaming, as views: the wire codecs encode in the reference's
layout, so a port upload is the reference's, element for element.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.utils.tree import Tree, leaf_order


def _is_kernel(path: str) -> bool:
    return path.rsplit("/", 1)[-1] == "kernel"


def _to_ref(path: str, t):
    """Port layout → the reference's (a view for torch tensors)."""
    if _is_kernel(path) and t.ndim == 2:
        return t.T
    if _is_kernel(path) and t.ndim == 4:  # OIHW → HWIO
        return t.permute(2, 3, 1, 0) if isinstance(t, torch.Tensor) else t.transpose(2, 3, 1, 0)
    return t


def _from_ref(path: str, t):
    """The reference's layout → the port's."""
    if _is_kernel(path) and t.ndim == 2:
        return t.T
    if _is_kernel(path) and t.ndim == 4:  # HWIO → OIHW
        return t.permute(3, 2, 0, 1) if isinstance(t, torch.Tensor) else t.transpose(3, 2, 0, 1)
    return t


def flatten_paths(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict → ``{"a/b/c": leaf}``."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(flatten_paths(dict(val), path))
        else:
            out[path] = val
    return out


def from_flax_params(tree: Dict[str, Any], device: DeviceLike = "cpu") -> Tree:
    """A flax params tree (``{"params": {...}}`` of numpy/JAX arrays) → the
    port's ``{path: tensor}`` dict, in the reference's leaf order."""
    flat = flatten_paths(tree)
    out = {}
    for path in leaf_order(flat):
        a = np.ascontiguousarray(_from_ref(path, np.asarray(flat[path])))
        out[path] = torch.from_numpy(a.copy()).to(device)
    return out


def to_flax_params(params: Tree) -> Dict[str, Any]:
    """The inverse of :func:`from_flax_params`: a nested dict of numpy
    arrays in the reference's layout."""
    tree: Dict[str, Any] = {}
    for path in leaf_order(params):
        t = _to_ref(path, params[path].detach().to("cpu"))
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.ascontiguousarray(t.numpy())
    return tree


def to_reference_layout(tree: Tree) -> Tree:
    """The same leaves, each as a view in the reference's layout."""
    return {k: _to_ref(k, v) for k, v in tree.items()}


def from_reference_layout(tree: Tree) -> Tree:
    """The inverse of :func:`to_reference_layout`; every leaf contiguous."""
    return {k: _from_ref(k, v).contiguous() for k, v in tree.items()}
