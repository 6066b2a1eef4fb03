"""Llama-family causal LM — counterpart of ``fedml_tpu/models/llm/llama.py``.

Same architecture and numerics as the flax reference: RMSNorm in f32,
rotary embeddings on split halves, grouped-query attention, SwiGLU MLP,
optional LoRA adapters on the attention projections. Kernels keep the JAX
``[in, out]`` layout, so int8 codes map one to one and the CUDA
dequant-matmul reads ``W[H, F]`` coalesced along F.

Module and parameter names follow the flax param paths
(``layer_0.attn.q_proj.kernel`` ↔ ``params/layer_0/attn/q_proj/kernel``),
which is what ``convert.from_jax_params`` and the quantization leaf filter
key on.

The no-cache (training) branch of attention runs the port's
``flash_attention`` when ``use_flash`` is set — on CUDA the hand-written
Hopper kernels, on the CPU their plain versions — and the plain
``reference_attention`` otherwise; the KV-cache branch serves decoding.
``remat`` checkpoints each block with ``torch.utils.checkpoint``.
Mixture-of-experts (``num_experts > 0``) waits for ROADMAP A13.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from fedml_tpu_torch.ops.quant import matmul_maybe_quantized

# flax lecun_normal: variance_scaling(1, fan_in, truncated_normal), whose
# stddev is corrected for the truncation at ±2 standard deviations
_TRUNC_STD_CORRECTION = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    lora_rank: int = 0
    lora_alpha: float = 16.0
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024
    moe_aux_weight: float = 0.01
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "full"
    use_flash: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    # -- presets (kw overrides win) -----------------------------------------
    @staticmethod
    def _preset(arch: dict, kw: dict) -> "LlamaConfig":
        for k, v in arch.items():
            kw.setdefault(k, v)
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig._preset(dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=32), kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig._preset(dict(
            vocab_size=32000, hidden_size=5120, intermediate_size=13824,
            num_hidden_layers=40, num_attention_heads=40,
            num_key_value_heads=40), kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig._preset(dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rope_theta=500000.0), kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Unit-test scale (runs on the CPU in milliseconds)."""
        return LlamaConfig._preset(dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            remat=False), kw)

    PRESETS = ("tiny", "llama2_7b", "llama2_13b", "llama3_8b")

    @staticmethod
    def from_args(args: Any, vocab_size: Optional[int] = None) -> "LlamaConfig":
        preset = str(
            getattr(args, "model_size", None)
            or getattr(args, "model_name", "tiny")
        ).lower().replace("-", "_")
        kw = {}
        for name in ("lora_rank", "lora_alpha", "max_position_embeddings",
                     "num_hidden_layers", "hidden_size", "num_experts",
                     "num_experts_per_tok", "moe_capacity_factor"):
            if getattr(args, name, None) is not None:
                kw[name] = type(LlamaConfig.__dataclass_fields__[name].default)(
                    getattr(args, name))
        if getattr(args, "use_flash_attention", None) is not None:
            kw["use_flash"] = bool(args.use_flash_attention)
        if getattr(args, "remat_policy", None) is not None:
            kw["remat_policy"] = str(args.remat_policy)
        if bool(getattr(args, "base_params_bf16", False)):
            kw["param_dtype"] = torch.bfloat16
        builder = {
            "tiny": LlamaConfig.tiny,
            "llama2_7b": LlamaConfig.llama2_7b,
            "7b": LlamaConfig.llama2_7b,
            "llama2_13b": LlamaConfig.llama2_13b,
            "13b": LlamaConfig.llama2_13b,
            "llama3_8b": LlamaConfig.llama3_8b,
            "8b": LlamaConfig.llama3_8b,
        }.get(preset, LlamaConfig.tiny)
        cfg = builder()
        if kw:
            cfg = dataclasses.replace(cfg, **kw)
        if vocab_size is not None and preset == "tiny":
            cfg = dataclasses.replace(cfg, vocab_size=max(vocab_size, 32))
        return cfg


# ---------------------------------------------------------------------------
# initializers (the flax distributions, drawn from an explicit generator)
# ---------------------------------------------------------------------------
def _param(shape: Sequence[int], dtype, device, fill, requires_grad=False):
    """Draw in f32 on ``device`` and store in ``dtype``: the weights never
    exist on the host."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    fill(t)
    return nn.Parameter(t.to(dtype), requires_grad=requires_grad)


def _lecun_normal(gen):
    def fill(t):
        std = math.sqrt(1.0 / t.shape[0]) / _TRUNC_STD_CORRECTION
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return fill


def _normal(std, gen):
    def fill(t):
        t.normal_(0.0, std, generator=gen)
    return fill


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device), requires_grad=False)

    def forward(self, x):
        x32 = x.to(torch.float32)
        normed = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + self.eps)
        return (normed * self.scale).to(self.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embeddings; positions [B, T] or [T]."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=positions.device) / head_dim))
    angles = positions.to(torch.float32)[..., None] * freqs  # [..., T, D/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, H, T, D]; cos/sin: [B, T, D/2] or [T, D/2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class LoRADense(nn.Module):
    """Dense with an optional additive low-rank adapter:
    ``y = x W + (x A) B * alpha / rank``.

    ``kernel`` is ``[in, out]`` in ``param_dtype`` (or a QuantizedTensor
    after quantization); ``lora_a`` / ``lora_b`` stay f32.
    """

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float, dtype, param_dtype, device, gen):
        super().__init__()
        self.rank = rank
        self.alpha = alpha
        self.dtype = dtype
        self.kernel = _param((in_features, features), param_dtype, device,
                             _lecun_normal(gen))
        if rank > 0:
            self.lora_a = _param((in_features, rank), torch.float32, device,
                                 _lecun_normal(gen), requires_grad=True)
            self.lora_b = _param((rank, features), torch.float32, device,
                                 nn.init.zeros_, requires_grad=True)

    def forward(self, x):
        y = matmul_maybe_quantized(x, self.kernel, self.dtype)
        if self.rank > 0:
            scaling = self.alpha / self.rank
            y = y + (x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype) * scaling
        return y


KVCache = Tuple[torch.Tensor, torch.Tensor, Any]


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, gen):
        super().__init__()
        self.cfg = cfg
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

        def dense(i, o):
            return LoRADense(i, o, cfg.lora_rank, cfg.lora_alpha, cfg.dtype,
                             cfg.param_dtype, device, gen)

        self.q_proj = dense(cfg.hidden_size, h * d)
        self.k_proj = dense(cfg.hidden_size, hkv * d)
        self.v_proj = dense(cfg.hidden_size, hkv * d)
        self.o_proj = dense(h * d, cfg.hidden_size)

    def forward(self, x, cos, sin, kv_cache: Optional[KVCache] = None,
                attention_fn: Optional[Callable] = None):
        cfg = self.cfg
        b, t, _ = x.shape
        h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(x).reshape(b, t, h, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, t, hkv, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, t, hkv, d).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        new_cache = None
        if kv_cache is not None:
            # decode / prefill: write this call's keys and values into each
            # row's cache at its own position, then attend over the whole
            # max_len cache. The cache tensors are updated IN PLACE, which
            # stands in for the reference's buffer donation.
            ck, cv, cache_len = kv_cache
            s_len = ck.shape[2]
            lens = torch.as_tensor(cache_len, device=x.device).expand(b)
            # dynamic_update_slice clamps the start so the update fits
            start = lens.clamp(0, s_len - t)
            pos_w = start[:, None] + torch.arange(t, device=x.device)[None, :]
            rows = torch.arange(b, device=x.device)[:, None]
            ck[rows, :, pos_w] = k.transpose(1, 2).to(ck.dtype)
            cv[rows, :, pos_w] = v.transpose(1, 2).to(cv.dtype)
            new_cache = (ck, cv, cache_len + t)
            group = h // hkv
            # head i attends kv head i // group — jnp.repeat(k, group,
            # axis=1) in the reference; grouping the query heads computes
            # the same products without materializing the repeated cache
            qg = q.to(torch.float32).reshape(b, hkv, group * t, d)
            logits = torch.einsum("bkqd,bksd->bkqs", qg,
                                  ck.to(torch.float32)) * (d ** -0.5)
            logits = logits.reshape(b, h, t, s_len)
            pos = lens[:, None] + torch.arange(t, device=x.device)[None, :]
            mask = (torch.arange(s_len, device=x.device)[None, None, :]
                    <= pos[:, :, None])  # causal over each row's prefix
            logits = torch.where(mask[:, None], logits, -1e30)
            probs = torch.softmax(logits, dim=-1).reshape(b, hkv, group * t, s_len)
            out = torch.einsum("bkqs,bksd->bkqd", probs, cv.to(torch.float32))
            out = out.reshape(b, h, t, d).to(cfg.dtype)
        elif attention_fn is not None:
            out = attention_fn(q, k, v)
        elif cfg.use_flash:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = reference_attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(b, t, h * d)
        return self.o_proj(out), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, gen):
        super().__init__()

        def dense(i, o):
            return LoRADense(i, o, 0, cfg.lora_alpha, cfg.dtype,
                             cfg.param_dtype, device, gen)

        self.gate_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, gen):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.attn = LlamaAttention(cfg, device, gen)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                      cfg.dtype, device)
        self.mlp = LlamaMLP(cfg, device, gen)

    def forward(self, x, cos, sin, kv_cache=None, attention_fn=None):
        attn_out, new_cache = self.attn(self.input_norm(x), cos, sin, kv_cache,
                                        attention_fn)
        x = x + attn_out
        x = x + self.mlp(self.post_attn_norm(x))
        return x, new_cache


class LlamaForCausalLM(nn.Module):
    """Token ids [B, T] → f32 logits [B, T, V].

    ``forward(tokens)`` is the no-cache forward; with ``kv_caches`` (one
    ``(k, v, cache_len)`` per layer, ``cache_len`` an int or a [B] vector)
    it returns ``(logits, new_caches)`` and writes the caches in place.
    Weights are drawn on ``device`` in ``cfg.param_dtype`` from a generator
    seeded with ``seed``, with the flax initializers' distributions.
    """

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts Llama is not ported yet (ROADMAP A13)")
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.embed_tokens = _param((cfg.vocab_size, cfg.hidden_size),
                                   cfg.param_dtype, dev, _normal(0.02, gen))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, dev, gen))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, dev)
        if not cfg.tie_word_embeddings:
            self.lm_head = _param((cfg.hidden_size, cfg.vocab_size),
                                  cfg.param_dtype, dev, _normal(0.02, gen))

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def layers(self) -> List[LlamaBlock]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.num_hidden_layers)]

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[List[KVCache]] = None,
                attention_fn: Optional[Callable] = None):
        cfg = self.cfg
        x = F.embedding(tokens, self.embed_tokens).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        remat = (cfg.remat and cfg.remat_policy != "none" and kv_caches is None
                 and torch.is_grad_enabled())
        new_caches = []
        for i, block in enumerate(self.layers()):
            cache_i = kv_caches[i] if kv_caches is not None else None
            if remat:
                x, new_cache = _checkpoint_block(block, cfg.remat_policy, x, cos,
                                                 sin, attention_fn)
            else:
                x, new_cache = block(x, cos, sin, cache_i, attention_fn)
            new_caches.append(new_cache)
        x = self.final_norm(x)
        if cfg.tie_word_embeddings:
            logits = x @ self.embed_tokens.to(cfg.dtype).T
        else:
            logits = matmul_maybe_quantized(x, self.lm_head, cfg.dtype)
        logits = logits.to(torch.float32)
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch: int, max_len: int) -> List[KVCache]:
        cfg = self.cfg
        shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        return [
            (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=cfg.dtype, device=self.device), 0)
            for _ in range(cfg.num_hidden_layers)
        ]


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the 2-D matmul outputs (the projections),
    recompute everything else — the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_block(block: LlamaBlock, policy: str, x, cos, sin, attention_fn):
    """One block under activation checkpointing: ``full`` saves only the
    block's inputs, ``dots`` also the matmul outputs."""
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}: expected none, full or dots")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    return ckpt.checkpoint(block, x, cos, sin, None, attention_fn,
                           use_reentrant=False, **kw)


def causal_lm_loss(apply_fn: Callable):
    """Next-token cross-entropy over a [B, T] token batch; ``mask`` is the
    [B] sample validity. ``loss_fn(model, x, y, mask)`` returns
    ``(loss, (correct, denom))`` as the reference's ``causal_lm_loss``;
    ``apply_fn(model, x)`` returns logits or ``(logits, aux_loss)``."""

    def loss_fn(model, x, y, mask):
        out = apply_fn(model, x)
        logits, aux = out if isinstance(out, tuple) else (out, 0.0)
        logits = logits.to(torch.float32)
        # labels < 0 are ignored: their (finite) loss is multiplied by 0
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             y.reshape(-1).clamp_min(0),
                             reduction="none").reshape(y.shape)
        valid = (y >= 0).to(torch.float32) * mask.to(torch.float32)[:, None]
        total = torch.sum(ce * valid)
        denom = torch.clamp_min(torch.sum(valid), 1.0)
        correct = torch.sum((logits.argmax(dim=-1) == y).to(torch.float32) * valid)
        return total / denom + aux, (correct, denom)

    return loss_fn
