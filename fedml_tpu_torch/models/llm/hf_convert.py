"""HuggingFace Llama checkpoint → the port's Llama — counterpart of
``fedml_tpu/models/llm/hf_convert.py``.

Real checkpoints enter through this converter: HF parameter names and
layouts → the port's parameters (keyed, as everywhere in the port, by the
reference's flax paths), with every tensor's shape checked and every HF
key left over reported. It imports no ``transformers``: it takes a
``state_dict`` (``serve --hf-checkpoint`` reads one through
``transformers`` when that package is installed).

Layout notes (held by the logit-parity test against ``transformers``):
- HF ``nn.Linear`` stores ``[out, in]``; the port's kernels are
  ``[in, out]`` as flax's → every projection is transposed;
- both sides use the half-split RoPE ("rotate_half") with the same
  frequency schedule, so q/k need no permutation;
- LoRA adapters are the port's own (a zero ``lora_b`` makes them a no-op
  at load) and are left untouched, as are the leaves the map does not
  name (an MoE layer's experts: HF Llama has none, so its MLP keys are
  left over and the load raises).

Usage::

    model = LlamaForCausalLM(cfg, device="cuda")
    convert_hf_llama_state_dict(hf_model.state_dict(), model)
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from fedml_tpu_torch.models.llm.convert import ref_path

__all__ = ["convert_hf_llama_state_dict", "hf_key_map"]

# HF buffers that are derived, not weights
_IGNORABLE_SUFFIXES = (".rotary_emb.inv_freq",)


def hf_key_map(num_layers: int) -> Dict[str, Tuple[str, bool]]:
    """``{reference path: (hf_key, transpose)}`` for a Llama of the given
    depth."""
    m: Dict[str, Tuple[str, bool]] = {
        "params/embed_tokens": ("model.embed_tokens.weight", False),
        "params/final_norm/scale": ("model.norm.weight", False),
        "params/lm_head": ("lm_head.weight", True),
    }
    for i in range(num_layers):
        ours = f"params/layer_{i}"
        hf = f"model.layers.{i}"
        m[f"{ours}/input_norm/scale"] = (f"{hf}.input_layernorm.weight", False)
        m[f"{ours}/post_attn_norm/scale"] = (
            f"{hf}.post_attention_layernorm.weight", False)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            m[f"{ours}/attn/{proj}/kernel"] = (f"{hf}.self_attn.{proj}.weight", True)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            m[f"{ours}/mlp/{proj}/kernel"] = (f"{hf}.mlp.{proj}.weight", True)
    return m


def _to_tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.array(v, copy=True))


def convert_hf_llama_state_dict(state_dict: Mapping[str, Any],
                                model: nn.Module) -> nn.Module:
    """Fill ``model`` (a port Llama) in place from an HF Llama
    ``state_dict`` and return it; each tensor is cast to its parameter's
    dtype. Raises on a shape mismatch, a missing tensor and any HF key left
    over, so a truncated or renamed checkpoint cannot load silently."""
    sd = dict(state_dict)
    tied = "lm_head.weight" not in sd and "model.embed_tokens.weight" in sd
    named = [(ref_path(n), p) for n, p in model.named_parameters()]
    n_layers = sum(1 for path, _ in named if path.endswith("input_norm/scale"))
    keymap = hf_key_map(n_layers)
    used = set()
    with torch.no_grad():
        for path, p in named:
            if path not in keymap or "lora" in path:
                continue
            hf_key, transpose = keymap[path]
            if hf_key == "lm_head.weight" and tied:
                hf_key = "model.embed_tokens.weight"  # tied embeddings
            if hf_key not in sd:
                raise KeyError(f"HF checkpoint is missing {hf_key!r} (needed for {path})")
            w = _to_tensor(sd[hf_key])
            if transpose:
                w = w.T
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"{path}: HF tensor {hf_key!r} has shape "
                                 f"{tuple(w.shape)}, model expects {tuple(p.shape)}")
            used.add(hf_key)
            p.copy_(w.to(device=p.device, dtype=p.dtype))
    leftovers = [k for k in sd
                 if k not in used and not k.endswith(_IGNORABLE_SUFFIXES)
                 and not (tied and k == "model.embed_tokens.weight")]
    if leftovers:
        raise ValueError(f"{len(leftovers)} HF tensors were not consumed (first few: "
                         f"{leftovers[:5]}) — config/depth mismatch?")
    return model
