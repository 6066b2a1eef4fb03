"""The port's quantized formats (``fedml_tpu_torch/ops/quant.py``: 4-bit
int4/NF4 residency and w8a8 activation quantization) against the reference
(``fedml_tpu/ops/quant.py``), on the CPU, and a hot swap through the
serving engine's int4 transform. (The engine's greedy streams in each
quantize mode are held against the reference engine in
``test_torch_serving.py``.)

Inputs are drawn with numpy and fed to both packages. Codes, scales and
dequantized weights are held bit for bit; products as stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from fedml_tpu import telemetry as jtelemetry
from fedml_tpu.compression import codecs as jcodecs
from fedml_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from fedml_tpu.models.llm.llama import LlamaForCausalLM as JaxLlama
from fedml_tpu.ops import quant as jq
from fedml_tpu.serving.llm_engine import ContinuousBatchingEngine as JaxEngine
from fedml_tpu_torch.compression import codecs as tcodecs
from fedml_tpu_torch.models.llm.convert import from_jax_params, load_weights
from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM
from fedml_tpu_torch.ops import quant as tq
from fedml_tpu_torch.serving import ContinuousBatchingEngine
from fedml_tpu_torch.serving.live.slots import ModelSlots
from fedml_tpu_torch.telemetry import get_registry


def _quant_leaves_to_numpy(tree):
    """A reference params tree as numpy, its quantized leaves as the tuples
    ``from_jax_params`` takes: int8 ``(data, scale)``, 4-bit ``(data,
    scale, shape, fmt, block)``."""
    def conv(leaf):
        if isinstance(leaf, jq.QuantizedTensor4):
            return (np.asarray(leaf.data), np.asarray(leaf.scale), leaf.orig_shape,
                    leaf.fmt, leaf.block)
        if isinstance(leaf, jq.QuantizedTensor):
            return (np.asarray(leaf.data), np.asarray(leaf.scale))
        return np.asarray(leaf)

    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(
        x, (jq.QuantizedTensor, jq.QuantizedTensor4)))


def test_nf4_codebook_and_midpoints_identical():
    assert tcodecs.NF4_CODEBOOK.dtype == tcodecs._NF4_MIDPOINTS.dtype == np.float32
    np.testing.assert_array_equal(tcodecs.NF4_CODEBOOK, jcodecs.NF4_CODEBOOK)
    np.testing.assert_array_equal(tcodecs._NF4_MIDPOINTS, jcodecs._NF4_MIDPOINTS)


# (shape, block): blocks 2, 64 and 128, sizes that are not a block multiple,
# and a Llama-3-8B k/v projection's [4096, 1024]
QUANT4_CASES = [((96, 40), 64), ((7, 9), 2), ((33, 5), 128), ((50, 3), 64),
                ((64, 48), 128), ((4096, 1024), 64)]


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
@pytest.mark.parametrize("shape,block", QUANT4_CASES)
def test_quantize_int4_bytes_scales_and_dequant_identical(fmt, shape, block):
    rng = np.random.default_rng(11)
    w = rng.normal(size=shape).astype(np.float32)
    w.reshape(-1)[:block] = 0.0  # an all-zero block takes the scale-1 branch
    ref = jq.quantize_int4(w, fmt=fmt, block=block)
    got = tq.quantize_int4(torch.from_numpy(w), fmt=fmt, block=block)
    assert got.data.dtype == torch.uint8 and got.scale.dtype == torch.float32
    assert got.shape == tuple(shape) and got.fmt == fmt and got.block == block
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert float(got.scale[0]) == 1.0
    # the dequantized weight, exactly, in f32 and in bf16
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(ref.dequantize()))
    np.testing.assert_array_equal(
        got.dequantize(torch.bfloat16).float().numpy(),
        np.asarray(ref.dequantize(jnp.bfloat16).astype(jnp.float32)))


def test_chunked_quantize_and_dequant_match_one_piece(monkeypatch):
    """Chunking over blocks changes no bit: a leaf of several chunks (with
    a ragged last block) against the same leaf in one chunk."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.normal(size=(37, 29)).astype(np.float32))
    whole = tq.quantize_int4(w, fmt="nf4", block=8)
    monkeypatch.setattr(tq, "CHUNK_ELEMS", 24)  # 3 blocks a chunk
    parts = tq.quantize_int4(w, fmt="nf4", block=8)
    assert torch.equal(parts.data, whole.data) and torch.equal(parts.scale, whole.scale)
    assert torch.equal(parts.dequantize(torch.bfloat16),
                       whole.dequantize(torch.bfloat16))


def test_unpack4_and_codes_to_vals_match_reference():
    packed = np.arange(256, dtype=np.uint8).reshape(8, 32)
    got = tq._unpack4(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._unpack4(jnp.asarray(packed))))
    assert got[0, 2].item() == 1 and got[0, 3].item() == 0  # low nibble first
    for fmt in ("int4", "nf4"):
        np.testing.assert_array_equal(
            tq._codes_to_vals(got, fmt).numpy(),
            np.asarray(jq._codes_to_vals(jnp.asarray(got.numpy()), fmt)))


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
@pytest.mark.parametrize("x_shape", [(4, 64), (2, 3, 64)])
def test_4bit_matmul_matches_reference(fmt, x_shape):
    """f32: within 1e-5 relative of the tensor's largest output (two BLAS
    sums in different orders); bf16: both round the same bf16 weight and
    activations, so within 2 bf16 ulps of each output."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=x_shape).astype(np.float32)
    ref = jq.quantize_int4(w, fmt=fmt)
    got = tq.quantize_int4(torch.from_numpy(w), fmt=fmt)
    want = np.asarray(ref.matmul(jnp.asarray(x), jnp.float32))
    out = tq.matmul_maybe_quantized(torch.from_numpy(x), got, torch.float32).numpy()
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()
    xb = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(ref.matmul(xb, jnp.bfloat16).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    out16 = tq.matmul_maybe_quantized(xt, got, torch.bfloat16).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want16), 1e-30))) - 7)
    assert np.all(np.abs(out16 - want16) <= 2 * ulp + 1e-6)


@pytest.mark.parametrize("x_shape", [(5, 64), (2, 3, 64), (1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_bit_identical_to_reference(x_shape, dtype):
    """The reference's eager ``_matmul_w8a8`` and the port's w8a8 mode on
    the same int8 weight: identical output bits, an all-zero row included."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=x_shape).astype(np.float32)
    x.reshape(-1, 64)[0] = 0.0  # amax 0: the scale-1 branch, a zero row out
    ref = jq.quantize_int8(w, mode="w8a8")
    got = tq.quantize_int8(torch.from_numpy(w), mode="w8a8")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref.matmul(jnp.asarray(x), jdt).astype(jnp.float32))
    out = tq.matmul_maybe_quantized(torch.from_numpy(x), got, tdt)
    assert out.dtype == tdt and out.shape == x_shape[:-1] + (48,)
    np.testing.assert_array_equal(out.float().numpy(), want)
    assert not out.reshape(-1, 48)[0].any()


def test_w8a8_activation_codes_and_exact_product():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(6, 256)) * 3).astype(np.float32)
    x[2] = 0.0
    xq, xs = tq.quantize_rows_int8(torch.from_numpy(x))
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True)
    jxs = jnp.where(amax > 0, amax / 127.0, 1.0)
    jxq = jnp.clip(jnp.round(jnp.asarray(x) / jxs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    # the plain int8 product is exact: against int64 numpy at full int8 range
    a = rng.integers(-127, 128, size=(9, 4096)).astype(np.int8)
    b = rng.integers(-127, 128, size=(4096, 40)).astype(np.int8)
    b[:, 0] = 127
    a[0] = 127
    acc = tq.int8_product(torch.from_numpy(a), torch.from_numpy(b))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert int(acc[0, 0]) == 4096 * 127 * 127
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.int8_product_cuda(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq.int8_product(torch.from_numpy(a).to("meta"), torch.from_numpy(b).to("meta"))


def test_quantize_int4_validates_like_reference():
    for bad in (dict(fmt="int3"), dict(block=48), dict(block=1), dict(block=1 << 21)):
        with pytest.raises(ValueError) as want:
            jq.quantize_int4(np.ones((4, 4), np.float32), **bad)
        with pytest.raises(ValueError) as got:
            tq.quantize_int4(torch.ones(4, 4), **bad)
        assert str(got.value) == str(want.value)


def _tiny_pair(lora_rank=4):
    """(jax model, unboxed jax params, port model) on the same fp32 tiny
    weights."""
    jm = JaxLlama(JaxLlamaConfig.tiny(lora_rank=lora_rank, dtype=jnp.float32,
                                      use_flash=False))
    params = meta.unbox(jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(lora_rank=lora_rank, dtype=torch.float32,
                                           use_flash=False), device="cpu")
    load_weights(tm, from_jax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("donate", [False, True])
def test_quantize_params_int4_picks_reference_leaves_and_sets_telemetry(donate):
    jm, params, tm = _tiny_pair()
    j_reg, t_reg = jtelemetry.get_registry(), get_registry()
    j0 = j_reg.counter("quant/packed_leaves").value
    t0 = t_reg.counter("quant/packed_leaves").value
    jp = jq.quantize_params_int4(params, fmt="nf4", min_size=1024)
    got = tq.quantize_params_int4(tm, fmt="nf4", min_size=1024, donate=donate)
    assert (got is tm) == donate
    j_packed = {"/".join(str(p.key) for p in path if hasattr(p, "key")): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jp, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor4))[0]
                if isinstance(leaf, jq.QuantizedTensor4)}
    t_packed = dict(tq.named_quantized_weights(got))
    assert all(isinstance(v, tq.QuantizedTensor4) for v in t_packed.values())
    assert {"params/" + n.replace(".", "/") for n in t_packed} == set(j_packed)
    for n, v in t_packed.items():
        ref = j_packed["params/" + n.replace(".", "/")]
        np.testing.assert_array_equal(v.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(v.scale.numpy(), np.asarray(ref.scale))
    assert (t_reg.gauge("quant/base_bytes").value
            == j_reg.gauge("quant/base_bytes").value
            == sum(v.data.numel() + 4 * v.scale.numel() for v in t_packed.values()))
    assert (t_reg.counter("quant/packed_leaves").value - t0
            == j_reg.counter("quant/packed_leaves").value - j0 == len(t_packed))
    if not donate:  # the caller's model keeps its full-precision kernels
        assert isinstance(tm.lm_head, torch.nn.Parameter)
    assert tq.tree_bytes(got) == (
        sum(p.numel() * 4 for p in got.parameters())
        + sum(v.data.numel() + 4 * v.scale.numel() for v in t_packed.values()))


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_from_jax_params_carries_packed_leaves(fmt):
    """Both packages fed the same packed bytes give the same logits (f32,
    within 1e-4 of the largest logit)."""
    jm, params, tm = _tiny_pair()
    jp = jq.quantize_params_int4(params, fmt=fmt, min_size=1024)
    load_weights(tm, from_jax_params(_quant_leaves_to_numpy(jp)))
    q = tm.layer_0.mlp.gate_proj.kernel
    assert isinstance(q, tq.QuantizedTensor4) and q.fmt == fmt and q.shape == (64, 128)
    toks = np.random.default_rng(3).integers(0, 256, size=(2, 9))
    want = np.asarray(jm.apply(jp, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _frozen_cases():
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32))
    return {"int8": tq.quantize_int8(w, mode="dequant"),
            "int4": tq.quantize_int4(w, fmt="int4"),
            "nf4": tq.quantize_int4(w, fmt="nf4")}


@pytest.mark.parametrize("kind", ["int8", "int4", "nf4"])
@pytest.mark.parametrize("x_dtype,dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                           ("bfloat16", "bfloat16")])
def test_frozen_base_function_dx_equals_autograd_of_plain_formula(kind, x_dtype, dtype):
    """The Function's forward and dx against autograd through the formula
    it replaces: exactly, bit for bit."""
    q = _frozen_cases()[kind]
    rng = np.random.default_rng(10)
    xt, dt = getattr(torch, x_dtype), getattr(torch, dtype)
    x0 = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32)).to(xt)
    x1 = x0.clone().requires_grad_(True)
    x2 = x0.clone().requires_grad_(True)
    ct = torch.promote_types(xt, dt)
    if kind == "int8":
        plain = (x1.to(ct) @ q.data.to(dt).to(ct)) * q.scale.to(dt)
    else:
        plain = x1.to(ct) @ q.dequantize(dt).to(ct)
    ours = tq.matmul_maybe_quantized(x2, q, dt)
    assert ours.dtype == plain.dtype
    assert torch.equal(ours, plain)
    dy = torch.from_numpy(rng.normal(size=tuple(plain.shape)).astype(np.float32)).to(ct)
    (g_plain,) = torch.autograd.grad(plain, x1, dy)
    (g_ours,) = torch.autograd.grad(ours, x2, dy)
    assert g_ours.dtype == g_plain.dtype == xt
    assert torch.equal(g_ours, g_plain)


def test_serving_modes_give_no_gradient():
    rng = np.random.default_rng(13)
    w = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    x = torch.randn(3, 128, requires_grad=True)
    for mode in ("w8a8", "kernel"):
        y = tq.matmul_maybe_quantized(x, tq.quantize_int8(w, mode=mode), torch.float32)
        with pytest.raises(RuntimeError, match="no gradient"):
            y.sum().backward()


def test_shallow_copy_and_staging_share_packed_tensors():
    """A model holding 4-bit weights, copied for a transform or staged by
    ModelSlots, shares the packed bytes and scales: nothing is copied."""
    _, _, tm = _tiny_pair()
    packed = tq.quantize_params_int4(tm, fmt="nf4", min_size=1024, donate=True)
    copy_ = tq._shallow_module_copy(packed)
    assert copy_ is not packed
    assert copy_.lm_head is packed.lm_head
    assert copy_.embed_tokens is packed.embed_tokens
    seen = []

    def transform(m):
        seen.append(m)
        return tq.quantize_params_int4(m, fmt="nf4", min_size=1024, donate=True)

    slots = ModelSlots(packed, transform=transform)
    assert slots.publish_payload(packed, round_idx=1)
    staged = slots.live_params
    assert seen[0] is not packed and staged is not packed
    for name in ("lm_head",):
        assert getattr(staged, name).data.data_ptr() == getattr(packed, name).data.data_ptr()
    assert (staged.layer_1.attn.o_proj.kernel.scale.data_ptr()
            == packed.layer_1.attn.o_proj.kernel.scale.data_ptr())
    assert staged.embed_tokens.data_ptr() == packed.embed_tokens.data_ptr()


def test_serving_hot_swap_with_int4_resident_base():
    """Twin of the reference's test: the engine packs its base to int4,
    serves, hot-swaps a new round through the same packing transform, and
    the post-swap generation matches a static int4 deployment of that
    round, and the reference engine's tokens for the same round."""
    jm, params, tm = _tiny_pair(lora_rank=0)
    bumped_j = jax.tree.map(lambda x: x + 0.02, params)
    bumped = LlamaForCausalLM(tm.cfg, device="cpu")
    load_weights(bumped, from_jax_params(jax.tree.map(np.asarray, bumped_j)))
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 256, size=5).tolist()

    def static_tokens(model):
        eng = ContinuousBatchingEngine(model, batch_slots=2, max_len=32, quantize="int4",
                                       quantize_min_size=1024, device="cpu").start()
        try:
            return eng.generate(prompt, max_new_tokens=6)
        finally:
            eng.stop()

    expected_r1 = static_tokens(bumped)
    j_eng = JaxEngine(jm, bumped_j, batch_slots=2, max_len=32, quantize="int4",
                      quantize_min_size=1024).start()
    try:
        assert j_eng.generate(prompt, max_new_tokens=6) == expected_r1
    finally:
        j_eng.stop()

    eng = ContinuousBatchingEngine(tm, batch_slots=2, max_len=32, quantize="int4",
                                   quantize_min_size=1024, device="cpu").start()
    try:
        assert isinstance(eng.model_slots.live_params.lm_head, tq.QuantizedTensor4)
        out0 = eng.generate(prompt, max_new_tokens=6)
        assert len(out0) == 6
        # hot swap: the transform packs the staged round to int4
        assert eng.model_slots.publish_payload(bumped, 1)
        out1 = eng.generate(prompt, max_new_tokens=6)
    finally:
        eng.stop()
    assert eng.failure is None
    assert eng.model_slots.live_round == 1
    assert out1 == expected_r1
    assert isinstance(bumped.lm_head, torch.nn.Parameter)  # the publisher's model
