"""The port's Llama (``fedml_tpu_torch/models/llm/llama.py``) against the
reference flax model, on the CPU, with the reference's weights carried
across by ``from_jax_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from fedml_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from fedml_tpu.models.llm.llama import LlamaForCausalLM as JaxLlama
from fedml_tpu.ops import quant as jq
from fedml_tpu_torch.models.llm.convert import from_jax_params, load_weights
from fedml_tpu_torch.models.llm.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    apply_rope,
    rope_tables,
)
from fedml_tpu_torch.ops import quant as tq


def _pair(jax_kw, torch_kw, quantize=None, seed=0):
    """(jax model, jax params, port model) sharing weights."""
    jm = JaxLlama(JaxLlamaConfig.tiny(use_flash=False, **jax_kw))
    params = meta.unbox(jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32)))
    if quantize is not None:
        params = jq.quantize_params_int8(params, min_size=1024, mode=quantize)
    tree = jax.tree_util.tree_map(
        lambda v: (np.asarray(v.data), np.asarray(v.scale))
        if isinstance(v, jq.QuantizedTensor) else np.asarray(v),
        params, is_leaf=lambda v: isinstance(v, jq.QuantizedTensor))
    tm = LlamaForCausalLM(LlamaConfig.tiny(use_flash=False, **torch_kw), device="cpu")
    load_weights(tm, from_jax_params(tree))
    return jm, params, tm


def _tokens(shape, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


def test_rope_matches_reference():
    from fedml_tpu.models.llm import llama as jl

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = jl.rope_tables(jnp.asarray(pos), 16, 5e5)
    tc, ts = rope_tables(torch.from_numpy(pos), 16, 5e5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jc, js))
    got = apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_no_cache_logits_fp32(lora_rank):
    kw = dict(dtype=jnp.float32, lora_rank=lora_rank)
    jm, params, tm = _pair(kw, dict(dtype=torch.float32, lora_rank=lora_rank))
    if lora_rank:  # lora_b initializes to zero: make the adapter count
        rng = np.random.default_rng(5)
        for layer in ("layer_0", "layer_1"):
            for proj in ("q_proj", "v_proj"):
                dense = getattr(getattr(tm, layer).attn, proj)
                b = rng.normal(size=tuple(dense.lora_b.shape)).astype(np.float32) * 0.1
                params["params"][layer]["attn"][proj]["lora_b"] = jnp.asarray(b)
                with torch.no_grad():
                    dense.lora_b.copy_(torch.from_numpy(b))
    toks = _tokens((2, 12))
    want = np.asarray(jm.apply(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got = tm(_t(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_prefill_and_per_row_decode_fp32():
    """Prefill, then 3 decode steps with a per-row cache_len vector; logits
    and the cache contents (written in place on the port side)."""
    jm, params, tm = _pair(dict(dtype=jnp.float32), dict(dtype=torch.float32))
    toks = _tokens((2, 10), seed=1)
    jc = [(k, v, 0) for k, v, _ in jm.init_kv_caches(2, 16)]
    tc = tm.init_kv_caches(2, 16)
    lj, jc = jm.apply(params, jnp.asarray(toks[:, :6]), positions=jnp.arange(6)[None],
                      kv_caches=jc)
    with torch.inference_mode():
        lt, tc2 = tm(_t(toks[:, :6]), positions=torch.arange(6)[None], kv_caches=tc)
    assert tc2[0][0] is tc[0][0]  # in place
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    lens = np.array([6, 4], np.int32)  # row 1 resumes two positions earlier
    for s in range(3):
        tok = toks[:, 6 + s:7 + s]
        lj, jc = jm.apply(params, jnp.asarray(tok), positions=jnp.asarray(lens)[:, None],
                          kv_caches=[(k, v, jnp.asarray(lens)) for k, v, _ in jc])
        with torch.inference_mode():
            lt, tc2 = tm(_t(tok), positions=torch.from_numpy(lens)[:, None].long(),
                         kv_caches=[(k, v, torch.from_numpy(lens)) for k, v, _ in tc2])
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        for (tk, tv, _), (jk, jv, _) in zip(tc2, jc):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        lens = lens + 1


ALIGNED = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=256)


def test_int8_kernel_mode_bf16_teacher_forced():
    """bf16, every dim a multiple of 128, int8 in kernel mode (the reference
    runs its Pallas kernel in interpret mode, the port its plain version):
    teacher-forced prefill and decode logits within 2e-2 of max |logit|."""
    jm, params, tm = _pair(dict(dtype=jnp.bfloat16, **ALIGNED),
                           dict(dtype=torch.bfloat16, **ALIGNED), quantize="pallas")
    n_q = sum(isinstance(v, tq.QuantizedTensor) for m in tm.modules()
              for v in vars(m).values())
    assert n_q == 2 * 7 + 1  # every projection and the LM head
    toks = _tokens((2, 11), seed=2)
    jc = [(k, v, 0) for k, v, _ in jm.init_kv_caches(2, 32)]
    tc = tm.init_kv_caches(2, 32)
    lj, jc = jm.apply(params, jnp.asarray(toks[:, :8]), positions=jnp.arange(8)[None],
                      kv_caches=jc)
    with torch.inference_mode():
        lt, tc = tm(_t(toks[:, :8]), positions=torch.arange(8)[None], kv_caches=tc)
    pairs = [(lt.numpy(), np.asarray(lj))]
    lens = np.array([8, 8], np.int32)
    for s in range(3):
        tok = toks[:, 8 + s:9 + s]
        lj, jc = jm.apply(params, jnp.asarray(tok), positions=jnp.asarray(lens)[:, None],
                          kv_caches=[(k, v, jnp.asarray(lens)) for k, v, _ in jc])
        with torch.inference_mode():
            lt, tc = tm(_t(tok), positions=torch.from_numpy(lens)[:, None].long(),
                        kv_caches=[(k, v, torch.from_numpy(lens)) for k, v, _ in tc])
        pairs.append((lt.numpy(), np.asarray(lj)))
        lens = lens + 1
    for got, want in pairs:
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_model_guards():
    moe = LlamaForCausalLM(LlamaConfig.tiny(num_experts=2), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in moe.named_parameters() if ".moe." in n}
    assert shapes == {f"layer_{i}.moe.{leaf}": shape for i in range(2) for leaf, shape in (
        ("router", (64, 2)), ("gate_proj", (2, 64, 128)), ("up_proj", (2, 64, 128)),
        ("down_proj", (2, 128, 64)))}
    assert moe.layer_0.moe.router.dtype == torch.float32
    assert not any(".mlp." in n for n, _ in moe.named_parameters())
    cfg = LlamaConfig.llama3_8b()
    assert (cfg.vocab_size, cfg.num_key_value_heads, cfg.head_dim,
            cfg.rope_theta) == (128256, 8, 128, 500000.0)

    class A:
        model_size = "8b"
        lora_rank = 8
        base_params_bf16 = True

    cfg = LlamaConfig.from_args(A())
    assert cfg.lora_rank == 8 and cfg.param_dtype == torch.bfloat16
    assert cfg.hidden_size == 4096


def test_init_is_seeded_and_follows_flax_scales():
    cfg = LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    a = LlamaForCausalLM(cfg, device="cpu", seed=3)
    b = LlamaForCausalLM(cfg, device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    k = a.layer_0.mlp.gate_proj.kernel
    # lecun_normal: std 1/sqrt(fan_in), truncated at 2 corrected stddevs
    assert abs(k.std().item() - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert k.abs().max().item() <= 2 * 128 ** -0.5 / 0.87962566103423978 + 1e-6
    assert abs(a.embed_tokens.std().item() - 0.02) < 0.002
