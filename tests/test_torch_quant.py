"""Int8 quantization of the port (``fedml_tpu_torch/ops/quant.py``) against
the reference (``fedml_tpu/ops/quant.py``), on the CPU.

The reference's Pallas dequant-matmul runs in interpret mode here, as its
own tests run it; the port's wrapper takes its plain version because the
tensors lie on the CPU. Inputs are drawn with numpy and fed to both."""
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
from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import quant as tq


def _bf16_np(a):
    """A jax bf16 array as f32 numpy (exact)."""
    return np.array(jnp.asarray(a, jnp.float32))


def _ulp_bf16(v):
    """One bf16 ulp at the magnitude of each element of ``v``."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape", [(256, 512), (64, 32), (128, 100)])
def test_quantize_int8_codes_and_scales_identical(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the scale-1 branch
    ref = jq.quantize_int8(w)
    got = tq.quantize_int8(torch.from_numpy(w))
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


@pytest.mark.parametrize("x_shape", [(8, 256), (2, 4, 256)])
def test_plain_version_matches_pallas_kernel(x_shape):
    """dequant_matmul_reference vs the interpret-mode Pallas kernel, within
    one bf16 ulp (both add exact products in f32 and round once)."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    x = rng.normal(size=x_shape).astype(np.float32)
    q = jq.quantize_int8(w)
    x_j = jnp.asarray(x, jnp.bfloat16)
    want = _bf16_np(jq.pallas_dequant_matmul(x_j, q.data, q.scale, jnp.bfloat16))
    qt = torch.from_numpy(np.array(q.data))
    st = torch.from_numpy(np.array(q.scale))
    xt = torch.from_numpy(_bf16_np(x_j)).to(torch.bfloat16)
    plain = tq.dequant_matmul_reference(xt, qt, st, torch.bfloat16)
    routed = tq.dequant_matmul(xt, qt, st, torch.bfloat16)  # CPU → plain version
    assert routed.shape == x_shape[:-1] + (512,)
    for got in (plain, routed):
        got = got.float().numpy()
        assert np.all(np.abs(got - want) <= _ulp_bf16(want))


@pytest.mark.parametrize("case", ["fp32", "rows_gt_128", "f_not_128_aligned"])
def test_fallback_conditions_reproduce_reference_formula(case):
    rng = np.random.default_rng(3)
    h, f, rows, dtype = 256, 384, 8, "bf16"
    if case == "fp32":
        dtype = "f32"
    elif case == "rows_gt_128":
        rows = 130
    else:
        f = 100
    w = rng.normal(size=(h, f)).astype(np.float32)
    x = rng.normal(size=(rows, h)).astype(np.float32)
    q = jq.quantize_int8(w)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    x_j = jnp.asarray(x, jdt)
    want = np.asarray(jnp.asarray(
        jq.pallas_dequant_matmul(x_j, q.data, q.scale, jdt), jnp.float32))
    qt = torch.from_numpy(np.array(q.data))
    st = torch.from_numpy(np.array(q.scale))
    xt = torch.from_numpy(np.array(jnp.asarray(x_j, jnp.float32))).to(tdt)
    got = tq.dequant_matmul(xt, qt, st, tdt)
    assert got.dtype == tdt
    # the port takes the same formula (not its kernel's plain version)
    formula = (xt @ qt.to(tdt)) * st.to(tdt)
    torch.testing.assert_close(got, formula, rtol=0, atol=0)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    else:
        # bf16 product rounded before a bf16 scale: two bf16 roundings each
        # side, summed by two different CPU backends
        got = got.float().numpy()
        assert np.all(np.abs(got - want) <= 4 * _ulp_bf16(want) + 1e-2)


def _names(tree, is_q):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_q)[0]
    return {"/".join(str(p.key) for p in path if hasattr(p, "key")): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("donate", [False, True])
def test_quantize_params_int8_picks_reference_leaves(donate):
    jcfg = JaxLlamaConfig.tiny(lora_rank=4, use_flash=False, dtype=jnp.float32)
    params = meta.unbox(JaxLlama(jcfg).init(jax.random.key(0),
                                           jnp.zeros((1, 8), jnp.int32)))
    jqp = jq.quantize_params_int8(params, min_size=1024)
    is_q = lambda v: isinstance(v, jq.QuantizedTensor)  # noqa: E731
    want = sorted(n.removeprefix("params/").replace("/", ".")
                  for n, v in _names(jqp, is_q).items() if is_q(v))
    assert want and any("lm_head" in n for n in want)

    model = LlamaForCausalLM(LlamaConfig.tiny(lora_rank=4, use_flash=False,
                                              dtype=torch.float32), device="cpu")
    load_weights(model, from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    before = {n: p for n, p in model.named_parameters()}
    qm = tq.quantize_params_int8(model, min_size=1024, mode="kernel", donate=donate)
    got = sorted(n for n, m in _quantized(qm))
    assert got == want
    left = {n for n, _ in qm.named_parameters()}
    assert not left & set(want)
    assert any("lora_a" in n for n in left) and "embed_tokens" in left
    if donate:
        assert qm is model
    else:  # the source model keeps every full-precision kernel
        assert qm is not model
        assert {n for n, _ in model.named_parameters()} == set(before)
        assert all(qm.get_parameter(n) is before[n] for n in left)
    # identical codes to the reference's
    jleaves = _names(jqp, is_q)
    for n, qt in _quantized(qm):
        ref = jleaves["params/" + n.replace(".", "/")]
        np.testing.assert_array_equal(qt.data.numpy(), np.asarray(ref.data))
    assert tq.tree_bytes(qm) < tq.tree_bytes(model) or donate


def _quantized(model):
    for mod_name, mod in model.named_modules():
        for k, v in vars(mod).items():
            if isinstance(v, tq.QuantizedTensor):
                yield (f"{mod_name}.{k}" if mod_name else k), v


def test_kernel_wrapper_routes_by_device_and_counts_only_launches():
    rng = np.random.default_rng(4)
    qt = tq.quantize_int8(torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32)),
                          mode="kernel")
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32)).to(torch.bfloat16)
    before = tq.DEQUANT_MATMUL_LAUNCHES
    out = qt.matmul(x, torch.bfloat16)
    assert out.shape == (4, 256) and out.dtype == torch.bfloat16
    assert tq.DEQUANT_MATMUL_LAUNCHES == before  # the plain version is no launch
    # a kernel-eligible call on a device that is neither CPU nor CUDA raises
    with pytest.raises(ValueError):
        tq.dequant_matmul(x.to("meta"), qt.data.to("meta"), qt.scale.to("meta"),
                          torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.dequant_matmul_cuda(x, qt.data, qt.scale)
    assert tq.DEQUANT_MATMUL_LAUNCHES == before


def test_deferred_formats_raise_not_implemented():
    """The w8a8 mode, deferred until the quantized formats landed, now
    constructs (its codes stored column-major, the same values); the
    reference's own name for the kernel mode still raises."""
    w = torch.arange(32, dtype=torch.int8).reshape(4, 8)
    qt = tq.QuantizedTensor(w, torch.ones(8), mode="w8a8")
    assert qt.mode == "w8a8" and qt.data.stride() == (1, 4)
    assert torch.equal(qt.data, w)
    with pytest.raises(ValueError):
        tq.QuantizedTensor(w, torch.ones(8), mode="pallas")


def test_build_names_sm90a_and_source_hash(tmp_path, monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    lib = _build.library_path("dequant_matmul")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libdequant_matmul-")
    assert _build.BUILD_DIR.parts[-2:] == ("build", "fedml_tpu_torch")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_signatures_match_the_c_interface():
    """The ctypes argument lists follow the extern "C" declarations of
    csrc/dequant_matmul.cu, the split count included."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tq.__file__).parent / "csrc" / "dequant_matmul.cu").read_text()
    assert set(tq._SIGNATURES) == set(re.findall(r"^int (fedml_\w+)\(", src, re.M))
    for name, argtypes in tq._SIGNATURES.items():
        decl = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        params = [p.strip() for p in decl.split(",")]
        assert len(params) == len(argtypes), name
        for p, a in zip(params, argtypes):
            want = {"int": ctypes.c_int, "float": ctypes.c_float}.get(
                p.split()[0], ctypes.c_void_p)
            assert a is want, (name, p)


# every Llama-3-8B projection: q/o, k/v, gate/up, down, the LM head
LLAMA3_8B_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                    (4096, 128256)]


@pytest.mark.parametrize("h,f", LLAMA3_8B_SHAPES)
def test_dequant_splits_fill_the_card_without_splitting_below_a_tile(h, f):
    """The cluster's split count: a power of two up to 8 that divides H into
    whole 128-row chunks, at least STAGES of them a block (never below the
    pipeline's depth), and enough blocks for the H100's 132 SMs, except
    where F = 1024 leaves 8 column blocks: the cap of 8 gives 64 blocks."""
    c = tq.dequant_splits(h, f)
    blocks = f // tq.BLOCK_COLS * c
    assert c in tq.SPLITS
    assert h % (tq.CHUNK_ROWS * c) == 0 and h // (tq.CHUNK_ROWS * c) >= tq.STAGES
    if f == 1024:
        assert c == max(tq.SPLITS) and blocks == 64
    else:
        assert blocks >= tq.H100_SMS
        # the fewest splits that do: half as many would not fill the card
        assert c == 1 or f // tq.BLOCK_COLS * (c // 2) < tq.H100_SMS


@pytest.mark.parametrize("h,f,want", [(128, 128, 1), (384, 1024, 1), (1024, 1024, 2),
                                      (2048, 256, 4), (8192, 128, 8), (1536, 4096, 2)])
def test_dequant_splits_small_and_odd_depths(h, f, want):
    """Depths of few chunks split no further than STAGES chunks a block, and
    only into counts that divide them."""
    assert tq.dequant_splits(h, f) == want
