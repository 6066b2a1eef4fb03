"""HF Llama checkpoint import into the port (``models/llm/hf_convert.py``):
a ``transformers`` ``LlamaForCausalLM`` built from a config in code (tiny,
GQA, random weights, no download) converted by the port and by the
reference's converter gives three agreeing logits; truncated, mis-shaped
and left-over tensors raise; ``serve --hf-checkpoint`` loads through it."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from fedml_tpu.models.llm import hf_convert as jhf  # noqa: E402
from fedml_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from fedml_tpu.models.llm.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from fedml_tpu_torch.models.llm.convert import ref_path  # noqa: E402
from fedml_tpu_torch.models.llm.hf_convert import (  # noqa: E402
    convert_hf_llama_state_dict,
    hf_key_map,
)
from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402

# the port's ``tiny`` preset: GQA with 4 query heads over 2 KV heads
HIDDEN, LAYERS, HEADS, KV, INTER, VOCAB = 64, 2, 4, 2, 128, 256


def _hf_model(seed=0, tie=False):
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS, num_key_value_heads=KV,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tie, attention_bias=False, mlp_bias=False, use_cache=False)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port(**kw):
    # f32 end to end: the parity is against HF's f32 torch path
    cfg = LlamaConfig.tiny(dtype=torch.float32, **kw)
    return LlamaForCausalLM(cfg, device="cpu", seed=3)


def _jax():
    cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    model = JaxLlama(cfg)
    return model, model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_port_jax_and_transformers_logits_agree(tie):
    """The port's logits within 2e-4 (rtol 1e-3) of HF's, as the reference's
    own test holds its converter, and within 1e-4 of the reference model's
    on its converter's weights; a checkpoint with tied embeddings loads
    into the untied model, as in the reference's test."""
    hf = _hf_model(seed=int(tie), tie=tie)
    port = convert_hf_llama_state_dict(hf.state_dict(), _port())
    jm, params = _jax()
    params = jhf.convert_hf_llama_state_dict(hf.state_dict(), params)
    x = _tokens((2, 16))
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(x)).logits.numpy()
        got = port(torch.tensor(x)).numpy()
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_key_map_and_weights_equal_the_references():
    """``hf_key_map`` is the reference's map; every converted weight equals
    the reference converter's leaf bit for bit; LoRA adapters are left
    untouched."""
    assert hf_key_map(3) == jhf.hf_key_map(3)
    hf = _hf_model()
    port = _port(lora_rank=4)
    lora0 = {n: p.detach().clone() for n, p in port.named_parameters() if "lora" in n}
    convert_hf_llama_state_dict(hf.state_dict(), port)
    _, params = _jax()
    params = jhf.convert_hf_llama_state_dict(hf.state_dict(), params)
    flat = {jhf._flat_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    for n, p in port.named_parameters():
        if "lora" in n:
            assert torch.equal(p, lora0[n])
        else:
            np.testing.assert_array_equal(p.detach().numpy(), flat[ref_path(n)])


def test_truncated_misshaped_and_leftover_checkpoints_raise():
    hf = _hf_model()
    sd = {k: v for k, v in hf.state_dict().items() if "layers.1." not in k}
    with pytest.raises(KeyError, match="missing"):
        convert_hf_llama_state_dict(sd, _port())
    sd = dict(hf.state_dict())
    sd["model.layers.0.self_attn.q_proj.weight"] = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="shape"):
        convert_hf_llama_state_dict(sd, _port())
    sd = dict(hf.state_dict())
    sd["model.layers.2.mlp.up_proj.weight"] = torch.zeros(INTER, HIDDEN)
    with pytest.raises(ValueError, match="not consumed"):
        convert_hf_llama_state_dict(sd, _port())
    # a derived RoPE buffer is not a weight: ignored
    sd = dict(hf.state_dict())
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    convert_hf_llama_state_dict(sd, _port())
    # HF Llama has no experts: an MoE model leaves the MLP tensors over
    with pytest.raises(ValueError, match="not consumed"):
        convert_hf_llama_state_dict(hf.state_dict(), _port(num_experts=2))


def test_bf16_checkpoint_into_a_bf16_model():
    """A bf16 HF checkpoint loads into the served bf16 layout exactly (each
    weight the checkpoint's bits, transposed), and the logits are finite."""
    hf = _hf_model().to(torch.bfloat16)
    port = LlamaForCausalLM(LlamaConfig.tiny(param_dtype=torch.bfloat16), device="cpu")
    convert_hf_llama_state_dict(hf.state_dict(), port)
    assert torch.equal(port.layer_1.attn.k_proj.kernel,
                       hf.state_dict()["model.layers.1.self_attn.k_proj.weight"].T)
    with torch.no_grad():
        assert torch.isfinite(port(torch.tensor(_tokens((1, 8))))).all()


def test_serve_hf_checkpoint_loads_through_the_converter(tmp_path, monkeypatch):
    """``serve --model tiny --hf-checkpoint DIR`` (a ``save_pretrained``
    directory): the served bf16 weights are the checkpoint's rounded to bf16,
    and the served logits agree with HF's f32 logits within bf16 error (2e-2
    of their largest magnitude). Without ``transformers`` the option raises
    naming the package."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser

    hf = _hf_model(seed=2)
    hf.save_pretrained(str(tmp_path / "hf"))
    args = build_parser().parse_args(["serve", "--model", "tiny", "--device", "cpu",
                                      "--port", "0", "--hf-checkpoint", str(tmp_path / "hf")])
    engine, runner = build_endpoint(args)
    try:
        model = engine.params
        sd = hf.state_dict()
        assert torch.equal(model.layer_0.mlp.down_proj.kernel,
                           sd["model.layers.0.mlp.down_proj.weight"].T.to(torch.bfloat16))
        x = torch.tensor(_tokens((1, 12), seed=4))
        with torch.no_grad():
            got = model(x).float().numpy()
            want = hf(input_ids=x).logits.numpy()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    finally:
        runner.stop()
        engine.stop()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        build_endpoint(args)
