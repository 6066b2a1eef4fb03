"""Carry reference weights into the port.

``from_jax_params`` turns an unboxed flax params tree of numpy arrays (as
``fedml_tpu``'s ``LlamaForCausalLM.init`` makes it, after unboxing and
``np.asarray`` on every leaf) into a flat ``{name: tensor}`` dict keyed by
the port's parameter names. A quantized reference leaf is accepted as a
``(data, scale)`` pair of numpy arrays (int8 codes and f32 scales) and
becomes a :class:`~fedml_tpu_torch.ops.quant.QuantizedTensor`, so both
frameworks can be fed identical codes. ``load_weights`` installs such a
dict into a model.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch
from torch import nn

from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.ops.quant import QuantizedTensor

Weight = Union[torch.Tensor, QuantizedTensor]


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_quant_pair(v: Any) -> bool:
    return (isinstance(v, tuple) and len(v) == 2
            and np.asarray(v[0]).dtype == np.int8)


def from_jax_params(tree: Dict[str, Any],
                    device: DeviceLike = "cpu") -> Dict[str, Weight]:
    """Flatten a flax params tree into port parameter names
    (``params/layer_0/attn/q_proj/kernel`` → ``layer_0.attn.q_proj.kernel``).
    Quantized leaves become kernel-mode QuantizedTensors (the reference's
    ``pallas`` mode)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, Weight] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, dict):
                walk(val, name)
            elif _is_quant_pair(val):
                data, scale = val
                out[name] = QuantizedTensor(_to_tensor(data, device),
                                            _to_tensor(scale, device),
                                            mode="kernel")
            else:
                out[name] = _to_tensor(val, device)

    walk(tree, "")
    return out


def load_weights(model: nn.Module, weights: Dict[str, Weight]) -> nn.Module:
    """Install converted weights into ``model`` in place.

    Every parameter of the model must be given. A tensor is copied into the
    parameter (cast to the parameter's dtype); a QuantizedTensor replaces it.
    """
    names = {n for n, _ in model.named_parameters()}
    missing = names - set(weights)
    extra = set(weights) - names
    if missing or extra:
        raise KeyError(f"weights do not match the model: missing "
                       f"{sorted(missing)}, unexpected {sorted(extra)}")
    with torch.no_grad():
        for name, w in weights.items():
            p = model.get_parameter(name)
            if isinstance(w, QuantizedTensor):
                owner_name, _, leaf = name.rpartition(".")
                owner = model.get_submodule(owner_name) if owner_name else model
                delattr(owner, leaf)
                setattr(owner, leaf, w)
            else:
                if tuple(w.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(w.shape)} != "
                                     f"{tuple(p.shape)}")
                p.copy_(w.to(p.dtype))
    return model
