"""Carry reference weights into the port.

``from_jax_params`` turns an unboxed flax params tree of numpy arrays (as
``fedml_tpu``'s ``LlamaForCausalLM.init`` makes it, after unboxing and
``np.asarray`` on every leaf) into a flat ``{name: tensor}`` dict keyed by
the port's parameter names. A quantized reference leaf is accepted as a
``(data, scale)`` pair of numpy arrays (int8 codes and f32 scales), which
becomes a :class:`~fedml_tpu_torch.ops.quant.QuantizedTensor`, or as a
``(data, scale, shape, fmt, block)`` tuple (packed uint8 4-bit codes, f32
block scales and the geometry), which becomes a
:class:`~fedml_tpu_torch.ops.quant.QuantizedTensor4`, so both frameworks
can be fed identical codes. ``load_weights`` installs such a dict into a
model.

The federated exchange crosses between the frameworks as a flat dict keyed
by the reference's flax path strings (``params/layer_0/attn/q_proj/lora_a``,
what ``fedml_tpu.train.llm.trainer.extract_lora`` produces):
``to_exchange`` / ``from_exchange`` move the port's LoRA tensors in and out
of it, and ``exchange_to_numpy`` gives the numpy form the JAX trainer
takes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.ops.quant import (
    QuantizedTensor,
    QuantizedTensor4,
    named_quantized_weights,
)

Weight = Union[torch.Tensor, QuantizedTensor, QuantizedTensor4]


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_quant_pair(v: Any) -> bool:
    return (isinstance(v, tuple) and len(v) == 2
            and np.asarray(v[0]).dtype == np.int8)


def _is_quant4(v: Any) -> bool:
    return (isinstance(v, tuple) and len(v) == 5
            and np.asarray(v[0]).dtype == np.uint8)


def from_jax_params(tree: Dict[str, Any],
                    device: DeviceLike = "cpu") -> Dict[str, Weight]:
    """Flatten a flax params tree into port parameter names
    (``params/layer_0/attn/q_proj/kernel`` → ``layer_0.attn.q_proj.kernel``).
    int8 pairs become kernel-mode QuantizedTensors (the reference's
    ``pallas`` mode), 4-bit tuples QuantizedTensor4s."""
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
            elif _is_quant4(val):
                data, scale, shape, fmt, block = val
                out[name] = QuantizedTensor4(_to_tensor(data, device),
                                             _to_tensor(scale, device),
                                             shape, fmt=fmt, block=block)
            else:
                out[name] = _to_tensor(val, device)

    walk(tree, "")
    return out


def load_weights(model: nn.Module, weights: Dict[str, Weight]) -> nn.Module:
    """Install converted weights into ``model`` in place.

    Every parameter and quantized weight of the model must be given. A
    tensor is copied into its parameter (cast to the parameter's dtype); a
    quantized weight replaces the parameter or quantized weight of its name.
    An int8 weight that replaces one of the model's int8 weights is rebuilt
    in that weight's mode (through the constructor, so a ``w8a8`` weight
    gets its column-major codes); one that replaces a plain parameter keeps
    its own mode (``kernel`` from :func:`from_jax_params`).
    """
    held = dict(named_quantized_weights(model))
    quantized = set(held)
    names = {n for n, _ in model.named_parameters()} | quantized
    missing = names - set(weights)
    extra = set(weights) - names
    if missing or extra:
        raise KeyError(f"weights do not match the model: missing "
                       f"{sorted(missing)}, unexpected {sorted(extra)}")
    with torch.no_grad():
        for name, w in weights.items():
            if isinstance(w, (QuantizedTensor, QuantizedTensor4)):
                if (isinstance(w, QuantizedTensor)
                        and isinstance(held.get(name), QuantizedTensor)):
                    w = QuantizedTensor(w.data, w.scale, mode=held[name].mode)
                owner_name, _, leaf = name.rpartition(".")
                owner = model.get_submodule(owner_name) if owner_name else model
                delattr(owner, leaf)
                setattr(owner, leaf, w)
            elif name in quantized:
                raise ValueError(f"{name}: the model holds it quantized; give a "
                                 f"quantized weight")
            else:
                p = model.get_parameter(name)
                if tuple(w.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(w.shape)} != "
                                     f"{tuple(p.shape)}")
                p.copy_(w.to(p.dtype))
    return model


# -- the federated exchange --------------------------------------------------

def ref_path(name: str) -> str:
    """Port parameter name → the reference's flax path string
    (``layer_0.attn.q_proj.lora_a`` → ``params/layer_0/attn/q_proj/lora_a``)."""
    return "params/" + name.replace(".", "/")


def port_name(path: str) -> str:
    """The inverse of :func:`ref_path`."""
    keys = path.split("/")
    if keys[0] == "params":
        keys = keys[1:]
    return ".".join(keys)


def is_lora_path(path: str) -> bool:
    """A LoRA leaf: some key of the path names ``lora``."""
    return any("lora" in key for key in path.replace(".", "/").split("/"))


def extract_lora(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``{reference path: live parameter}`` of the model's LoRA adapters —
    the exchangeable state."""
    return {ref_path(n): p for n, p in model.named_parameters() if is_lora_path(n)}


def to_exchange(model: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`extract_lora` as detached copies (safe to ship while the model
    trains on)."""
    return {k: p.detach().clone() for k, p in extract_lora(model).items()}


def from_exchange(model: nn.Module, exchanged: Mapping[str, Any]) -> nn.Module:
    """Copy an exchange dict (tensors or numpy arrays, reference path keys)
    into the model's parameters in place; every key must name one."""
    with torch.no_grad():
        for path, value in exchanged.items():
            p = model.get_parameter(port_name(path))
            t = value if isinstance(value, torch.Tensor) else _to_tensor(value, p.device)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)} != {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return model


def exchange_to_numpy(exchanged: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """An exchange dict as host numpy arrays (what the JAX trainer takes)."""
    return {k: v.detach().to("cpu").numpy() for k, v in exchanged.items()}
