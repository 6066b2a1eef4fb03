"""Tests that need the card: the port's CUDA kernels against their plain
versions, and the training path through them, held by the same checks as
``chip_smoke.py`` (imported from the repo root). They import only torch,
the port and that script, so they run on the card's machine, which has no
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Elsewhere they skip (no CUDA device)."""
import types

import pytest
import torch

from fedml_tpu_torch.ops import flash_attention as tfa
from fedml_tpu_torch.ops import quant as tq


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", [1, 3, 8, 128])
def test_kernel_matches_plain_version_on_cuda(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(rows)
    w = torch.randn(512, 1024, device="cuda", generator=gen)
    qt = tq.quantize_int8(w, mode="kernel")
    x = torch.randn(rows, 512, device="cuda", generator=gen).to(torch.bfloat16)
    before = tq.DEQUANT_MATMUL_LAUNCHES
    got = tq.dequant_matmul(x, qt.data, qt.scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert tq.DEQUANT_MATMUL_LAUNCHES == before + 1
    want = tq.dequant_matmul_reference(x, qt.data, qt.scale, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("t,s,causal,d", [(128, 128, True, 128), (100, 100, True, 64),
                                          (64, 128, False, 128), (96, 160, True, 64)])
def test_kernels_match_plain_versions_on_cuda(t, s, causal, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from chip_smoke import LSE_TOL, ROW_TOL, row_rel_err

    gen = torch.Generator(device="cuda").manual_seed(t + s)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

    q, k, v, do = randn(2, 8, t, d), randn(2, 2, s, d), randn(2, 2, s, d), randn(2, 8, t, d)
    out, lse = tfa.flash_forward_cuda(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    got = (out, lse, tfa.flash_dq_cuda(q, k, v, do, lse, delta, causal),
           *tfa.flash_dkv_cuda(q, k, v, do, lse, delta, causal))
    want = (*tfa.flash_forward_reference(q, k, v, causal),
            tfa.flash_dq_reference(q, k, v, do, lse, delta, causal),
            *tfa.flash_dkv_reference(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w.dtype == torch.float32:  # lse
            assert (g - w).abs().max().item() <= LSE_TOL
        else:
            assert row_rel_err(g, w) <= ROW_TOL
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_forward_cuda(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_forward_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                               v[..., :32].contiguous())


def _backward_inputs(h, hkv, t, s, causal, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

    q, k, v, do = randn(2, h, t, d), randn(2, hkv, s, d), randn(2, hkv, s, d), randn(2, h, t, d)
    out, lse = tfa.flash_forward_cuda(q, k, v, causal)
    return q, k, v, do, lse, tfa.attention_delta(do, out)


# GQA groups 1, 3, 4 and 8: the dk/dv launch puts a group's query heads in a
# cluster of 1, 1 (each block loops over 3 heads), 4 and 8 blocks
@pytest.mark.requires_cuda
@pytest.mark.parametrize("t,s,causal", [(200, 200, True), (136, 264, True), (264, 136, False)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(8, 8), (6, 2), (8, 2), (16, 2)])
def test_backward_kernels_match_plain_versions_over_groups_on_cuda(h, hkv, d, t, s, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from chip_smoke import ROW_TOL, row_rel_err

    q, k, v, do, lse, delta = _backward_inputs(h, hkv, t, s, causal, d, seed=h * t + d)
    got = (tfa.flash_dq_cuda(q, k, v, do, lse, delta, causal),
           *tfa.flash_dkv_cuda(q, k, v, do, lse, delta, causal))
    want = (tfa.flash_dq_reference(q, k, v, do, lse, delta, causal),
            *tfa.flash_dkv_reference(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert row_rel_err(g, w) <= ROW_TOL, name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,hkv", [(6, 2), (32, 8)])
def test_backward_kernels_are_bit_identical_on_cuda(h, hkv):
    """No atomics and a fixed order of every sum, the cluster's group sum
    included: two launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, do, lse, delta = _backward_inputs(h, hkv, 512, 512, True, 128, seed=h)
    first = (tfa.flash_dq_cuda(q, k, v, do, lse, delta),
             *tfa.flash_dkv_cuda(q, k, v, do, lse, delta))
    second = (tfa.flash_dq_cuda(q, k, v, do, lse, delta),
              *tfa.flash_dkv_cuda(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_fedllm_round_trains_through_the_kernels_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from chip_smoke import LOSS_REL_TOL, plain_flash_route
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2, lora_rank=4)  # bf16, head_dim 64
    args = types.SimpleNamespace(
        max_seq_length=100, vocab_size=cfg.vocab_size, train_size=16, test_size=2,
        client_num_in_total=4, client_num_per_round=2, local_steps_per_round=2,
        comm_round=1, per_device_batch_size=2, on_device_round=True, random_seed=0,
        learning_rate=1e-3)
    api = FedLLMAPI(args, None, load_synthetic_lm(args), cfg=cfg)
    assert api.client.engine.device.type == "cuda"
    tfa.FLASH_FWD_LAUNCHES = tfa.FLASH_DQ_LAUNCHES = tfa.FLASH_DKV_LAUNCHES = 0
    out = api.train()
    layers, steps = cfg.num_hidden_layers, 2 * 2
    assert (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_DQ_LAUNCHES, tfa.FLASH_DKV_LAUNCHES) == (
        layers * (steps + 1), layers * steps, layers * steps)
    assert torch.isfinite(torch.tensor(out["test_loss"]))
    engine = api.client.engine
    x, y = (torch.as_tensor(a, device="cuda").long() for a in api.dataset.test_data_global)
    m = torch.ones(x.shape[0], device="cuda")
    with torch.no_grad():
        got = float(engine._loss_fn(engine.model, x, y, m)[0])
        with plain_flash_route():
            want = float(engine._loss_fn(engine.model, x, y, m)[0])
    assert abs(got - want) <= LOSS_REL_TOL * abs(want)
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_attention(*(torch.zeros(1, 4, 8, 64, device="cuda") for _ in range(3)))


# The forward over the GQA groups and T/S cases of the backward's group test,
# at head_dim 64 and 128: ragged tiles, T != S (top-left alignment) and two
# or more KV tiles, where a register hazard once showed at head_dim 64
@pytest.mark.requires_cuda
@pytest.mark.parametrize("t,s,causal", [(200, 200, True), (136, 264, True), (264, 136, False)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(8, 8), (6, 2), (8, 2), (16, 2), (32, 8)])
def test_forward_kernel_matches_plain_version_over_groups_on_cuda(h, hkv, d, t, s, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from chip_smoke import LSE_TOL, ROW_TOL, row_rel_err

    gen = torch.Generator(device="cuda").manual_seed(h * t + d + s)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

    q, k, v = randn(2, h, t, d), randn(2, hkv, s, d), randn(2, hkv, s, d)
    out, lse = tfa.flash_forward_cuda(q, k, v, causal)
    out_p, lse_p = tfa.flash_forward_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.shape == out_p.shape and out.dtype == torch.bfloat16
    assert row_rel_err(out, out_p) <= ROW_TOL
    assert (lse - lse_p).abs().max().item() <= LSE_TOL


@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,hkv,d", [(6, 2, 64), (32, 8, 128)])
def test_forward_kernel_is_bit_identical_on_cuda(h, hkv, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(h + d)
    q, k, v = (torch.randn(1, n, 520, d, device="cuda", generator=gen).to(torch.bfloat16)
               for n in (h, hkv, hkv))
    first, second = tfa.flash_forward_cuda(q, k, v), tfa.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


_INT8_WEIGHTS = {}


def _int8_weight(h, f):
    """Random int8 codes and f32 scales of an [h, f] weight, one per shape."""
    if (h, f) not in _INT8_WEIGHTS:
        _INT8_WEIGHTS.clear()  # keep one (up to 0.5 GB) on the card at a time
        gen = torch.Generator(device="cuda").manual_seed(h + f)
        q = torch.randint(-127, 128, (h, f), device="cuda", generator=gen, dtype=torch.int8)
        scale = torch.rand(f, device="cuda", generator=gen) * 0.02 + 1e-3
        _INT8_WEIGHTS[(h, f)] = (q, scale)
    return _INT8_WEIGHTS[(h, f)]


# every prefill bucket and decode width, ragged row counts between them, at
# the split-K shapes of Llama-3-8B (8 splits: k/v and down) and the LM head
# (one split, 1002 column blocks)
@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,f", [(4096, 1024), (14336, 4096), (4096, 128256)])
@pytest.mark.parametrize("rows", [1, 2, 5, 8, 16, 17, 32, 64, 100, 128])
def test_dequant_kernel_matches_plain_version_row_by_row_on_cuda(rows, h, f):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from chip_smoke import DEQUANT_ROW_TOL, row_rel_err

    q, scale = _int8_weight(h, f)
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.dequant_matmul_cuda(x, q, scale)
    want = tq.dequant_matmul_reference(x, q, scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (rows, f) and got.dtype == torch.bfloat16
    assert row_rel_err(got, want) <= DEQUANT_ROW_TOL


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", [8, 128])
def test_dequant_kernel_is_bit_identical_on_cuda(rows):
    """The cluster adds the split partial sums in rank order: two launches
    on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, scale = _int8_weight(14336, 4096)
    x = torch.randn(rows, 14336, device="cuda").to(torch.bfloat16)
    first, second = tq.dequant_matmul_cuda(x, q, scale), tq.dequant_matmul_cuda(x, q, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    # an int8 weight 8 bytes off the 16-byte grid the kernel's copies need
    shifted = q.view(-1)[8:8 + 128 * 4096].view(128, 4096)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tq.dequant_matmul_cuda(x[:, :128].contiguous(), shifted, scale)


# -- quantized formats: w8a8 and 4-bit on the card against the CPU ----------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,f", [(4096, 1024), (14336, 4096)])
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 128])
def test_w8a8_matches_cpu_plain_version_on_cuda(rows, h, f):
    """w8a8 through ``torch._int_mm`` (fewer than 32 rows padded) against
    the same formula on the CPU: activation codes and int32 accumulators
    bit for bit, outputs row by row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm's CUDA path")
    from chip_smoke import DEQUANT_ROW_TOL, row_rel_err

    gen = torch.Generator(device="cuda").manual_seed(rows + h)
    qt = tq.quantize_int8(torch.randn(h, f, device="cuda", generator=gen), mode="w8a8")
    assert qt.data.stride() == (1, h)
    x = torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
    xq, xs = tq.quantize_rows_int8(x)
    xq_c, xs_c = tq.quantize_rows_int8(x.cpu())
    assert torch.equal(xq.cpu(), xq_c) and torch.equal(xs.cpu(), xs_c)
    acc = tq.int8_product(xq, qt.data)
    acc_c = tq.int8_product(xq_c, qt.data.cpu())
    assert acc.shape == (rows, f) and acc.dtype == torch.int32
    assert torch.equal(acc.cpu(), acc_c)
    got = qt.matmul(x, torch.bfloat16)
    want = tq.w8a8_matmul(x.cpu(), qt.data.cpu(), qt.scale.cpu(), torch.bfloat16)
    assert row_rel_err(got.cpu(), want) <= DEQUANT_ROW_TOL


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fmt", ["int4", "nf4"])
@pytest.mark.parametrize("h,f", [(4096, 1024), (14336, 4096)])
def test_4bit_quantize_and_dequant_bit_identical_to_cpu_on_cuda(fmt, h, f):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(h + f)
    w = (torch.randn(h, f, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    q = tq.quantize_int4(w, fmt=fmt)
    q_c = tq.quantize_int4(w.cpu(), fmt=fmt)
    assert torch.equal(q.data.cpu(), q_c.data) and torch.equal(q.scale.cpu(), q_c.scale)
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(q.dequantize(dtype).cpu(), q_c.dequantize(dtype))
    x = torch.randn(8, h, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.matmul_maybe_quantized(x, q, torch.bfloat16)
    assert torch.equal(got, x @ q.dequantize(torch.bfloat16))


@pytest.mark.requires_cuda
def test_qlora_nf4_round_trains_through_the_kernels_on_cuda():
    """A tiny QLoRA round on the card: nf4 base, bf16, head_dim 64; the
    flash kernels run on every layer, the packed base stays bit-frozen and
    the adapters move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2, lora_rank=4)
    args = types.SimpleNamespace(
        max_seq_length=100, vocab_size=cfg.vocab_size, train_size=16, test_size=2,
        client_num_in_total=4, client_num_per_round=2, local_steps_per_round=2,
        comm_round=1, per_device_batch_size=2, on_device_round=True, random_seed=0,
        learning_rate=1e-3, base_quantize="nf4", base_quantize_min_size=4096)
    api = FedLLMAPI(args, None, load_synthetic_lm(args), cfg=cfg)
    model = api.client.engine.model
    packed = [v for m in model.modules() for v in vars(m).values()
              if isinstance(v, tq.QuantizedTensor4)]
    assert len(packed) == 2 * 7 + 1 and packed[0].data.device.type == "cuda"
    before = [q.data.clone() for q in packed]
    lora0 = {k: v.clone() for k, v in api.global_exchange.items()}
    tfa.FLASH_FWD_LAUNCHES = tfa.FLASH_DQ_LAUNCHES = tfa.FLASH_DKV_LAUNCHES = 0
    out = api.train()
    layers, steps = cfg.num_hidden_layers, 2 * 2
    assert (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_DQ_LAUNCHES, tfa.FLASH_DKV_LAUNCHES) == (
        layers * (steps + 1), layers * steps, layers * steps)
    assert torch.isfinite(torch.tensor(out["test_loss"]))
    assert all(torch.equal(q.data, b) for q, b in zip(packed, before))
    assert any(not torch.equal(api.global_exchange[k], v) for k, v in lora0.items())


# -- the single-process simulation: codecs and a FedAvg round on the card ----

def _sp_delta(seed=0):
    """A ResNet-20-shaped delta tree (the port's init, scaled), on the CPU."""
    from fedml_tpu_torch.models.cv.resnet import resnet20
    from fedml_tpu_torch.models.layers import init

    params = init(resnet20(10, 2), torch.zeros(1, 32, 32, 3), seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    delta = {k: torch.randn(v.shape, generator=gen) * 1e-3 for k, v in params.items()}
    delta["params/Dense_0/bias"][:5] = 0.0  # exact zeros: top-k ties
    return delta


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spec", ["identity", "bf16", "int8", "topk", "int4", "nf4",
                                  "int4@32", "nf4@16"])
def test_codec_wire_bits_on_cuda_match_cpu(spec):
    """Every codec's wire arrays for the same leaves and ``derive_key`` are
    byte-identical on the card and the CPU; so is their decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import derive_key, get_codec

    delta = _sp_delta()
    codec, key = get_codec(spec), derive_key(3, 7, 11)
    ct_c = codec.encode(delta, key=key, is_delta=True)
    ct_g = codec.encode({k: v.cuda() for k, v in delta.items()}, key=key, is_delta=True)
    assert ct_g.meta == ct_c.meta and ct_g.structure == ct_c.structure
    for pg, pc in zip(ct_g.arrays, ct_c.arrays):
        for a, b in zip(pg, pc):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)
    dec_c, dec_g = codec.decode(ct_c), codec.decode(ct_g)
    assert all(torch.equal(dec_g[k].cpu(), dec_c[k]) for k in dec_c)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spec", ["int8", "topk", "nf4"])
def test_fused_weighted_sum_on_cuda_matches_decode_and_sum(spec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import SP_FUSED_REL_TOL

    from fedml_tpu_torch.compression import derive_key, fused_weighted_sum, get_codec

    codec = get_codec(spec)
    cts = [codec.encode({k: v.cuda() for k, v in _sp_delta(i).items()},
                        key=derive_key(0, 1, i), is_delta=True) for i in range(4)]
    w = torch.tensor([0.1, 0.2, 0.3, 0.4])
    fused = fused_weighted_sum(cts, w)
    decoded = [codec.decode(ct) for ct in cts]
    for k, v in fused.items():
        ref = sum(float(wi) * d[k].double() for wi, d in zip(w, decoded))
        assert v.is_cuda
        assert float((v.double() - ref).abs().max()) <= SP_FUSED_REL_TOL * max(
            float(ref.abs().max()), 1e-30)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("compression", ["", "int8"])
def test_fedavg_round_of_resnet20_on_cuda_matches_cpu(compression):
    """One FedAvg round of ResNet-20 (2 of 4 clients, one local step each,
    int8 uplinks or none) from the same weights on the card in FP32, on the
    CPU in FP32 and on the CPU in float64: the same clients, every parameter
    on the card, the card's parameters within 1e-5 of each leaf's magnitude
    of both (plus one int8 step, the leaf's largest update / 127, where
    float32 rounding crosses a code's boundary), and the test loss within
    5e-5 of the float64 run's. One step per client keeps float32's own
    distance from float64 far below those limits; longer rounds amplify
    rounding through the steps (see chip_smoke's SP_PARAM_TOL). The images
    are ``synthetic_image``'s, whose seed is fixed (the CIFAR stand-in's is
    salted per process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    args = load_arguments_from_dict({
        "data_args": {"dataset": "synthetic_image", "image_size": 32,
                      "image_channels": 3, "train_size": 64, "test_size": 64},
        "model_args": {"model": "resnet20"},
        "train_args": {"client_num_in_total": 4, "client_num_per_round": 2,
                       "comm_round": 1, "batch_size": 16, "learning_rate": 0.02,
                       "compression": compression}})
    ds = load_federated(args)
    model = create(args, ds.class_num)
    runs = {"cpu": ("cpu", torch.float32), "cuda": ("cuda", torch.float32),
            "float64": ("cpu", torch.float64)}
    apis = {name: FedAvgAPI(args, dev, ds, model) for name, (dev, _) in runs.items()}
    start = {k: v.clone() for k, v in apis["cpu"].global_params.items()}
    for name, (dev, dt) in runs.items():
        apis[name].global_params = {k: v.to(dev, dt) for k, v in start.items()}
    reps = {name: api.train_one_round(0) for name, api in apis.items()}
    assert reps["cuda"]["clients"] == reps["cpu"]["clients"] == reps["float64"]["clients"]
    card = apis["cuda"].global_params
    assert all(v.is_cuda for v in card.values())
    for ref in ("cpu", "float64"):
        for k, v in apis[ref].global_params.items():
            v = v.double()
            step = (float((v - start[k].double()).abs().max()) / 127) if compression else 0.0
            err = float((card[k].cpu().double() - v).abs().max())
            assert err <= step + 1e-5 * max(1.0, float(v.abs().max())), (ref, k)
    assert abs(reps["cuda"]["test_loss"] - reps["float64"]["test_loss"]) <= (
        5e-5 * abs(reps["float64"]["test_loss"]))


def test_run_simulation_refuses_missing_cuda_here(monkeypatch):
    """Held on the CPU side, without JAX: the sp entry points default to
    ``cuda`` and raise without it rather than fall back to the CPU."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.simulator import create_simulator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = load_arguments_from_dict({"train_args": {"comm_round": 1},
                                     "data_args": {"train_size": 64, "test_size": 16}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fedml_tpu_torch.run_simulation(args)
    ds = load_federated(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_simulator(args, "cuda", ds, create(args, ds.class_num))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_safe_dumps_and_loads_of_cuda_trees_round_trip_bit_for_bit(dtype):
    """A tree on the card goes to bytes through one pinned staging pass and
    comes back on the card (or the CPU) with the same bits; the bytes are
    those of the same tree on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import derive_key, get_codec
    from fedml_tpu_torch.utils.serialization import safe_dumps, safe_loads

    gen = torch.Generator(device="cuda").manual_seed(7)
    conv = torch.randn(64, 32, 3, 3, device="cuda", generator=gen).to(dtype)
    tree = {"params": {"conv": conv.permute(2, 3, 1, 0),  # a strided view
                       "bias": torch.randn(64, device="cuda", generator=gen).to(dtype),
                       "empty": torch.zeros(0, 5, device="cuda", dtype=dtype)},
            "steps": torch.arange(5, device="cuda"), "round": 3,
            "ct": get_codec("int8").encode({"w": conv.float()}, key=derive_key(0, 1, 2))}
    wire = safe_dumps(tree)
    cpu = {"params": {k: v.cpu() for k, v in tree["params"].items()},
           "steps": tree["steps"].cpu(), "round": 3,
           "ct": get_codec("int8").encode({"w": conv.float().cpu()}, key=derive_key(0, 1, 2))}
    assert wire == safe_dumps(cpu)
    for dev in ("cuda", "cpu"):
        back = safe_loads(wire, dev)
        for k, v in tree["params"].items():
            got = back["params"][k]
            assert got.device.type == dev and got.dtype == v.dtype and got.shape == v.shape
            assert torch.equal(got.cpu().view(torch.int16) if dtype == torch.bfloat16
                               else got.cpu(),
                               v.cpu().view(torch.int16) if dtype == torch.bfloat16
                               else v.cpu())
        assert back["round"] == 3 and torch.equal(back["steps"].cpu(), tree["steps"].cpu())
        assert all(torch.equal(a.cpu(), b.cpu()) for pa, pb in
                   zip(back["ct"].arrays, tree["ct"].arrays) for a, b in zip(pa, pb))


@pytest.mark.requires_cuda
def test_inproc_cross_silo_federation_on_cuda():
    """Two rounds of the in-process cross-silo federation (LR, 3 silos,
    int8 uplinks) on the card: it finishes, and the global model stays
    finite and on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    args = load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "run_id": "cuda_cs"},
        "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                      "class_num": 5, "feature_dim": 16},
        "model_args": {"model": "lr"},
        "train_args": {"client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 2, "learning_rate": 0.3, "compression": "int8"}})
    ds = load_federated(args)
    LocalBroker.destroy("cuda_cs")
    server, clients = build_cross_silo_inproc(args, ds, create(args, ds.class_num))
    result = run_managers_to_completion([server.manager] + [c.manager for c in clients],
                                        "cuda_cs", MyMessage.MSG_TYPE_CONNECTION_IS_READY,
                                        timeout=300)
    assert result["rounds"] == 2 and 0.0 <= result["test_acc"] <= 1.0
    final = server.fedml_aggregator.get_global_model_params()
    assert all(v.is_cuda and bool(torch.isfinite(v).all()) for v in final.values())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grpc_message_of_a_cuda_tree_arrives_equal(dtype):
    """A port gRPC message carrying a tree from the card arrives on the
    receiver's card with the same bits, and the bytes on the wire are those
    of the same tree on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket
    import threading
    import time

    from fedml_tpu_torch.core.distributed.communication.grpc_comm import GRPCCommManager
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.utils.serialization import safe_dumps

    with socket.socket() as s0, socket.socket() as s1:
        s0.bind(("127.0.0.1", 0))
        base = s0.getsockname()[1]
        s1.bind(("127.0.0.1", base + 1))  # OSError: the next port is taken
    gen = torch.Generator(device="cuda").manual_seed(11)
    tree = {"conv": torch.randn(64, 32, 3, 3, device="cuda", generator=gen).to(dtype),
            "bias": torch.randn(64, device="cuda", generator=gen).to(dtype)}
    tx = GRPCCommManager(client_id=0, client_num=1, base_port=base, device="cuda")
    rx = GRPCCommManager(client_id=1, client_num=1, base_port=base, device="cuda")
    got = []

    class Obs:
        def receive_message(self, t, m):
            got.append(m)

    rx.add_observer(Obs())
    threading.Thread(target=rx.handle_receive_message, daemon=True).start()
    try:
        msg = Message("M", 0, 1).add_params("model_params", tree)
        tx.send_message(msg)
        end = time.monotonic() + 30
        while not got and time.monotonic() < end:
            time.sleep(0.01)
    finally:
        rx.stop_receive_message()
        tx.stop_receive_message()
    assert got, "the message did not arrive"
    assert safe_dumps(msg.get_params()) == safe_dumps(
        {**msg.get_params(), "model_params": {k: v.cpu() for k, v in tree.items()}})
    for k, v in tree.items():
        back = got[0].get("model_params")[k]
        assert back.is_cuda and back.dtype == v.dtype
        assert torch.equal(back.view(torch.int16) if dtype == torch.bfloat16 else back,
                           v.view(torch.int16) if dtype == torch.bfloat16 else v)


# -- the trust stack on the card -------------------------------------------------
def _trust_deltas(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return [{"params/Conv_0/kernel": torch.randn(16, 8, 3, 3, generator=gen) * 1e-2,
             "params/Dense_0/bias": torch.randn(10, generator=gen) * 1e-2,
             "params/Dense_0/kernel": torch.randn(10, 300, generator=gen) * 1e-2}
            for _ in range(n)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("codec", ["identity", "int8", "nf4"])
@pytest.mark.parametrize("spec", ["median", "trimmed_mean@0.2"])
@pytest.mark.parametrize("n", [4, 5])
def test_fused_robust_sum_and_screen_on_cuda_match_cpu(codec, spec, n):
    """The card's ``fused_robust_sum`` within 1e-6 of the CPU's on the same
    wire trees (bit-identical wire: the same keys), and ``screen_stats``
    within 1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch import compression as tc
    from fedml_tpu_torch import integrity as ti

    c = tc.get_codec(codec)
    cpu = [c.encode(d, key=tc.derive_key(0, 1, i), is_delta=True)
           for i, d in enumerate(_trust_deltas(n, n))]
    gpu = [c.encode({k: v.cuda() for k, v in d.items()}, key=tc.derive_key(0, 1, i),
                    is_delta=True) for i, d in enumerate(_trust_deltas(n, n))]
    mode, trim = ti.parse_robust_spec(spec)
    want = ti.fused_robust_sum(cpu, mode, trim)
    got = ti.fused_robust_sum(gpu, mode, trim)
    for k in want:
        assert got[k].device.type == "cuda"
        assert (got[k].cpu() - want[k]).abs().max().item() <= 1e-6 * max(
            1e-2, want[k].abs().max().item()), k
    for a, b in zip(gpu, cpu):
        sa, sb = ti.screen_stats(a), ti.screen_stats(b)
        assert sa.finite and sb.finite
        assert abs(sa.norm - sb.norm) <= 1e-6 * sb.norm


@pytest.mark.requires_cuda
@pytest.mark.parametrize("block", [1000, 1 << 22])
def test_blockwise_krum_on_cuda_matches_cpu(block):
    """The streamed gram and krum's choice on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from fedml_tpu_torch.core.security.defense import blockwise as bw
    from fedml_tpu_torch.core.security.defense.krum import select_krum

    trees = _trust_deltas(6, 7)
    trees[0] = {k: v * 50.0 for k, v in trees[0].items()}
    want = bw.pairwise_sq_dists_blockwise(bw.iter_blocks(bw.flatten_clients(trees), block), 6)
    gpu = [{k: v.cuda() for k, v in t.items()} for t in trees]
    got = bw.pairwise_sq_dists_blockwise(bw.iter_blocks(bw.flatten_clients(gpu), block), 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    assert select_krum(got, 1, 1) == select_krum(want, 1, 1) != [0]


# -- secure aggregation on the card ----------------------------------------------
@pytest.mark.requires_cuda
@pytest.mark.parametrize("mod_bits", [4, 8, 16])
def test_masked_encode_and_unmask_on_cuda_match_cpu_bit_for_bit(mod_bits):
    """The masked words, the residual and the unmasked aggregate (with and
    without recovery) are the CPU's bits on the card; with DP noise the
    aggregate is the CPU's within 2e-5·σ (``erfinv`` differs by device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch import compression as tc
    from fedml_tpu_torch.compression.codecs import _tree_meta
    from fedml_tpu_torch.privacy import secagg as ts
    from fedml_tpu_torch.utils.tree import tree_flatten

    n = 3
    codec = tc.get_codec(f"secagg_int8@0.1/{ts.client_bound(n, mod_bits)}/{mod_bits}")
    deltas = _trust_deltas(n, mod_bits)
    meta = _tree_meta(tree_flatten(deltas[0])[0])
    secret = {(1, 2): 11, (1, 3): 22, (2, 3): 33}

    def seeds(i):
        return {j: ts.pair_round_seed(secret[min(i, j), max(i, j)], 4)
                for j in range(1, n + 1) if j != i}

    cts = {"cpu": [], "cuda": []}
    for i, d in enumerate(deltas, start=1):
        mask = ts.net_mask_leaves(i, seeds(i), meta, mod_bits)
        res = {k: v * 0.5 for k, v in d.items()}
        for dev in cts:
            ct, new_res = ts.masked_encode(
                {k: v.to(dev) for k, v in d.items()}, mask, codec, tc.derive_key(0, 4, i),
                residual={k: v.to(dev) for k, v in res.items()},
                sa={"round": 4, "rank": i, "roster": [1, 2, 3]})
            cts[dev].append((ct, new_res))
    for (a, ra), (b, rb) in zip(cts["cuda"], cts["cpu"]):
        assert all(torch.equal(x[0].cpu(), y[0]) for x, y in zip(a.arrays, b.arrays))
        assert all(torch.equal(ra[k].cpu(), rb[k]) for k in rb)
    base = {k: v * 10.0 for k, v in deltas[0].items()}
    rec = ts.recovery_adjustment([(1, 3, seeds(1)[3]), (2, 3, seeds(2)[3])], meta, mod_bits)
    for which, recovery, sigma in (([0, 1, 2], None, 0.0), ([0, 1], rec, 0.0),
                                   ([0, 1, 2], None, 0.25)):
        out = {}
        for dev in cts:
            out[dev] = ts.unmask_finalize(
                [cts[dev][i][0] for i in which], {k: v.to(dev) for k, v in base.items()},
                codec, recovery=recovery, dp_sigma=sigma,
                dp_key_data=tc.derive_key_data(0, 4, 0))
        for k in base:
            assert out["cuda"][k].is_cuda
            err = (out["cuda"][k].cpu() - out["cpu"][k]).abs().max().item()
            assert err <= (2e-5 * sigma if sigma else 0.0), (which, k, err)


@pytest.mark.requires_cuda
def test_secagg_int8_federation_on_cuda():
    """Two masked rounds of LR over 3 silos on the card: every upload the
    server holds is masked, the run finishes and the model stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    args = load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "run_id": "cuda_secagg"},
        "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                      "class_num": 5, "feature_dim": 16},
        "model_args": {"model": "lr"},
        "train_args": {"client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 2, "learning_rate": 0.3, "secagg": "int8",
                       "secagg_clip": 0.2}})
    ds = load_federated(args)
    LocalBroker.destroy("cuda_secagg")
    server, clients = build_cross_silo_inproc(args, ds, create(args, ds.class_num))
    agg = server.fedml_aggregator
    seen, add = [], agg.add_local_trained_result
    agg.add_local_trained_result = lambda i, p, n, local_steps=None: (
        seen.append((p.codec, p.version)), add(i, p, n, local_steps))[1]
    result = run_managers_to_completion([server.manager] + [c.manager for c in clients],
                                        "cuda_secagg", MyMessage.MSG_TYPE_CONNECTION_IS_READY,
                                        timeout=300)
    assert result["rounds"] == 2 and seen == [("secagg_int8", 2)] * 6
    final = agg.get_global_model_params()
    assert all(v.is_cuda and bool(torch.isfinite(v).all()) for v in final.values())


# -- round checkpoints and the reconstruction attacks on the card -------------
@pytest.mark.requires_cuda
def test_dlg_double_backward_on_cuda_matches_cpu():
    """DLG's gradient of a gradient on the card: twenty iterations on a small
    MLP land within 1e-4 of the CPU's (the dummies' normals differ by
    ``erfinv``'s rounding across devices, within 2e-5), and the flash
    kernels' backward refuses a create_graph backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.core.security.attack.dlg import DLGAttack

    gen = torch.Generator().manual_seed(0)
    cpu_params = {"w1": torch.randn(8, 16, generator=gen) * 0.5,
                  "b1": torch.randn(16, generator=gen) * 0.1,
                  "w2": torch.randn(16, 4, generator=gen) * 0.5,
                  "b2": torch.randn(4, generator=gen) * 0.1}
    x = torch.randn(1, 8, generator=gen)
    y = torch.eye(4)[[2]]

    def loss_grad_fn(p, x_, y_soft):
        keys = sorted(p)
        h = torch.tanh(x_ @ p["w1"] + p["b1"])
        loss = -torch.mean(torch.sum(y_soft * torch.log_softmax(h @ p["w2"] + p["b2"], -1), -1))
        return torch.autograd.grad(loss, [p[k] for k in keys], create_graph=True)

    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in cpu_params.items()}
        observed = [g.detach() for g in loss_grad_fn(p, x.to(dev), y.to(dev))]
        attack = DLGAttack(types.SimpleNamespace(random_seed=3, dlg_iters=20, dlg_lr=0.1))
        rx, ry = attack.reconstruct_data(observed, {
            "loss_grad_fn": loss_grad_fn, "params": p, "x_shape": (1, 8), "num_classes": 4})
        assert rx.device.type == dev and float(attack.losses[-1]) < float(attack.losses[0])
        out[dev] = (rx.cpu(), ry.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4
    q = torch.randn(1, 4, 128, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    o = tfa.flash_attention(q, q, q)
    (g,) = torch.autograd.grad(o.float().sum(), [q], create_graph=False)
    assert g.shape == q.shape
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(tfa.flash_attention(q, q, q).float().sum(), [q],
                            create_graph=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_of_a_card_tree(tmp_path, dtype):
    """A round state on the card saves as CPU tensors in the reference's
    layout and restores onto the card (``map_location``) bit for bit, in the
    port's layout; the same file restores onto the CPU with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.core import checkpoint as ck

    gen = torch.Generator(device="cuda").manual_seed(1)
    params = {"params/Conv_0/kernel": torch.randn(8, 3, 3, 3, device="cuda", generator=gen),
              "params/Dense_0/kernel": torch.randn(10, 32, device="cuda", generator=gen),
              "params/Dense_0/bias": torch.randn(10, device="cuda", generator=gen)}
    params = {k: v.to(dtype) for k, v in params.items()}
    state = {"global_params": params, "server_opt": {"0": {"trace": {
        k: v * 0.5 for k, v in params.items()}}}, "dp_counter": 7, "next_round": 3}
    saver = ck.RoundCheckpointer(str(tmp_path / "ck"))
    saver.save(2, state)
    on_disk = ck.read_round_dir(str(tmp_path / "ck" / "round_2"))
    assert all(t.device.type == "cpu" for t in on_disk.values())
    assert torch.equal(on_disk["global_params/params/Dense_0/kernel"],
                       params["params/Dense_0/kernel"].cpu().T)
    for dev in ("cuda", "cpu"):
        r, got = saver.restore_latest(state, device=dev)
        assert r == 2 and int(got["next_round"]) == 3 and int(got["dp_counter"]) == 7
        for k, v in params.items():
            g = got["global_params"][k]
            assert g.device.type == dev and g.dtype == dtype and g.is_contiguous()
            assert torch.equal(g.cpu(), v.cpu())
            assert torch.equal(got["server_opt"]["0"]["trace"][k].cpu(), (v * 0.5).cpu())


@pytest.mark.requires_cuda
def test_host_loop_round_checkpoint_reloads_on_cuda(tmp_path):
    """A tiny host-loop FedLLM round on the card through the kernels with a
    checkpoint: a fresh engine loaded from it gives the round's test loss
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    from fedml_tpu_torch.train.llm.trainer import LLMTrainer

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2, lora_rank=4)  # bf16, head_dim 64
    args = types.SimpleNamespace(
        max_seq_length=100, vocab_size=cfg.vocab_size, train_size=8, test_size=2,
        client_num_in_total=4, client_num_per_round=2, comm_round=1,
        per_device_batch_size=1, on_device_round=False, random_seed=0,
        learning_rate=1e-3, checkpoint_dir=str(tmp_path), save_every_rounds=1)
    api = FedLLMAPI(args, None, load_synthetic_lm(args), cfg=cfg)
    tfa.FLASH_FWD_LAUNCHES = tfa.FLASH_DQ_LAUNCHES = 0
    out = api.train()
    assert tfa.FLASH_DQ_LAUNCHES == cfg.num_hidden_layers * 2 * 2  # 2 clients x 2 steps
    fresh = LLMTrainer(cfg, args)
    fresh.init(seed=0)
    fresh.load_checkpoint(str(tmp_path / "round_0"))
    x, y = api.dataset.test_data_global
    assert fresh.evaluate(x[:2], y[:2])["eval_loss"] == out["test_loss"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("payload", ["int8", "identity", "plain"])
def test_journaled_cuda_upload_salvages_bit_for_bit(tmp_path, payload):
    """One upload of card tensors is journaled (staged to host bytes, fsynced),
    read back onto the card and salvaged: the same bits, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import CompressedTree, derive_key, get_codec
    from fedml_tpu_torch.models.convert import to_reference_layout, to_wire_params
    from fedml_tpu_torch.resilience.durability import RoundJournal, salvage_round

    gen = torch.Generator(device="cuda").manual_seed(5)
    tree = {"params/Conv_0/kernel": torch.randn(8, 3, 3, 3, device="cuda", generator=gen),
            "params/Dense_0/kernel": torch.randn(10, 32, device="cuda", generator=gen),
            "params/Dense_0/bias": torch.randn(10, device="cuda", generator=gen)}
    if payload == "plain":
        wire = to_wire_params(tree)
    else:
        wire = get_codec(payload).encode(to_reference_layout(tree),
                                         key=derive_key(0, 1, 2), is_delta=True)
    j = RoundJournal(str(tmp_path / "server_round.journal"))
    j.append("round_open", round=1, cohort=[1, 2], silo_index={1: 0, 2: 1}, seed=0,
             codec=None, secagg=False)
    j.append("upload_received", round=1, client=2, msg_id="m:2:1", n_samples=40,
             local_steps=None, payload=wire)
    j.close()
    sal = salvage_round(RoundJournal(j.path).records(device="cuda"), 1)
    assert sal.uploaded_clients == [2]
    got = sal.uploads[0]["payload"]
    if payload == "plain":
        for k in ("Conv_0", "Dense_0"):
            for leaf, want in wire["params"][k].items():
                g = got["params"][k][leaf]
                assert g.device.type == "cuda" and torch.equal(g, want)
    else:
        assert isinstance(got, CompressedTree) and got.structure == wire.structure
        for pg, pw in zip(got.arrays, wire.arrays):
            for g, w in zip(pg, pw):
                assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.requires_cuda
def test_async_fedbuff_federation_on_cuda():
    """The async server with FedBuff (K=3) and int8 deltas, in process on the
    card: the budget in whole-buffer flushes, and a loss below the cold one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    args = fedml_tpu_torch.init(load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "random_seed": 0,
                        "run_id": "cuda_fedbuff"},
        "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                      "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "async_aggregation": True,
                       "async_total_updates": 9, "async_buffer_size": 3,
                       "compression": "int8", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 3, "epochs": 1,
                       "batch_size": 32, "learning_rate": 0.3}}))
    ds = load_federated(args)
    res = run_cross_silo_inproc(args, ds, create(args, ds.class_num), timeout=120)
    assert res["updates"] == 9 and res["flushes"] == 3
    assert res["test_loss"] < 1.0, res


@pytest.mark.requires_cuda
def test_batched_threefry_on_cuda_matches_cpu_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import threefry

    keys = torch.randint(0, 2 ** 32, (8, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(0))
    ids, sizes = [0, 3, 7], [1000, 17, 1]
    for fn in (threefry.uniform_leaves, threefry.normal_leaves):
        got, want = fn(keys.cuda(), ids, sizes).cpu(), fn(keys, ids, sizes)
        assert torch.equal(got, want) if fn is threefry.uniform_leaves else (
            (got - want).abs().max().item() <= 2e-6)
    assert torch.equal(threefry.fold_in_batch(keys.cuda(), 5).cpu(),
                       threefry.fold_in_batch(keys, 5))
    assert torch.equal(threefry.uniform_batch(keys.cuda(), (33, 3)).cpu(),
                       threefry.uniform_batch(keys, (33, 3)))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("codec", ["int8", "identity"])
def test_leaf_chunk_on_cuda_matches_cpu_bit_for_bit(codec):
    """One leaf chunk (uniform deltas, EF, the encode, the weighted rows
    summed in the fixed pairwise order) on the card and on the CPU: the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import get_codec, threefry
    from fedml_tpu_torch.hierarchy.edge import leaf_chunk

    meta = (("float32", (64,)), ("float32", (3, 3, 16, 8)))
    sizes = [64, 3 * 3 * 16 * 8]

    def delta_fn(keys):
        flat = threefry.uniform_leaves(keys, [0, 1], sizes) - 0.5
        return (flat[:, :64], flat[:, 64:].reshape(keys.shape[0], 3, 3, 16, 8))

    keys = torch.randint(0, 2 ** 32, (8, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(1))
    w = torch.tensor([1.0, 2.0, 0.0, 1.0, 3.0, 1.0, 0.0, 1.0])
    res = tuple(torch.randn((8,) + sh, generator=torch.Generator().manual_seed(2)) * 0.01
                for _, sh in meta)
    out = {}
    for dev in ("cpu", "cuda"):
        summed, new_res = leaf_chunk(get_codec(codec), meta, delta_fn, True, "mean", 0.0,
                                     keys.to(dev), w.to(dev), tuple(r.to(dev) for r in res))
        out[dev] = [x.cpu() for x in (*summed, *new_res)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)



@pytest.mark.requires_cuda
@pytest.mark.parametrize("spec", ["cms@64/3", "csk@64/3", "votevec@4096/3", "bloom@512/2",
                                  "hist@32/0/10"])
def test_sketch_encode_on_cuda_matches_cpu_bit_for_bit(spec):
    """The sketch codecs' wire (one encode and the batched leaf encode, the
    dyadic scale from the exponent bits) and the fused merge on the card give
    the CPU's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import fused_weighted_sum, get_codec

    codec = get_codec(spec)
    shape = codec._expected_shape()
    g = torch.Generator().manual_seed(len(spec))
    x = torch.randint(-300 if not codec.nonneg else 0, 3000, (6,) + shape,
                      generator=g).float()
    x[1] /= 8.0  # a dyadic table
    x[2] = 0.0
    q, s = codec.encode_leaf_batch(x.cuda(), None)
    q0, s0 = codec.encode_leaf_batch(x, None)
    assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    cts = {d: [codec.encode({"table": x[c].to(d)}) for c in range(6)] for d in ("cpu", "cuda")}
    for a, b in zip(cts["cpu"], cts["cuda"]):
        assert all(torch.equal(p.cpu(), r) for p, r in zip(b.arrays[0], a.arrays[0]))
    w = [1.0 / 6] * 6
    assert torch.equal(fused_weighted_sum(cts["cuda"], w)["table"].cpu(),
                       fused_weighted_sum(cts["cpu"], w)["table"])


@pytest.mark.requires_cuda
def test_vote_delta_fn_on_cuda_matches_cpu_bit_for_bit():
    """The word stream (threefry ``uniform_batch`` + ``randint_batch``), the
    tensor hash and the ``bincount`` vote table of a chunk on the card equal
    the CPU's, and so does a whole federation's digest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import threefry
    from fedml_tpu_torch.fa.sketch import federation as fed

    keys = torch.randint(0, 2 ** 32, (128, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(3))
    for lo, hi in ((0, 12), (0, 512), (-5, 1000)):
        assert torch.equal(threefry.randint_batch(keys.cuda(), (32,), lo, hi).cpu(),
                           threefry.randint_batch(keys, (32,), lo, hi))
    x = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 12345], dtype=torch.int64)
    assert torch.equal(fed.hash_bucket(x.cuda(), 2 ** 32 - 1, 7, 4096).cpu(),
                       fed.hash_bucket(x, 2 ** 32 - 1, 7, 4096))
    fn = fed.make_vote_delta_fn(4096, 3, 0, "votevec", fed.make_word_stream(512, 12, 0.5, 32))
    (a,), (b,) = fn(keys.cuda()), fn(keys)
    assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert fed.last_sketch_trace()["client_sketch_traced"] is True
    kw = dict(n_clients=256, levels=(1, 16, 256), codec="votevec@1024/3", vocab=128)
    on_card = fed.run_sketch_federation(device="cuda", **kw)
    on_cpu = fed.run_sketch_federation(device="cpu", **kw)
    assert on_card["final_digest"] == on_cpu["final_digest"]
    assert on_card["heavy_hitters"] == on_card["ref_heavy_hitters"]


def _moe_card_and_cpu(**kw):
    """A small bf16 MoE Llama (head_dim 64, the flash kernels' width) drawn
    on the CPU from a seed and copied to the card."""
    from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
                           moe_group_size=64, **kw)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=5)
    card = LlamaForCausalLM(cfg, device="cuda", seed=5)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.requires_cuda
def test_moe_routing_and_logits_on_cuda_match_cpu(monkeypatch):
    """Routing on the card against the CPU on the same layer-0 input: at
    most 0.1% of tokens choose other experts (f32 router products summed in
    another order). Then the whole model, flash kernels against the CPU's
    plain versions: every layer's routing recorded, and the logits of the
    tokens routed alike in every layer within 2^-5 of each row's norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    from chip_smoke import row_rel_err
    from fedml_tpu_torch.models.llm import llama as tl

    cfg, cpu, card = _moe_card_and_cpu()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    h = torch.randn(2 * 100 // 64 + 1, 64, cfg.hidden_size, generator=gen)
    with torch.no_grad():
        idx_cpu = cpu.layer_0.moe.route(h)[2]
        idx_card = card.layer_0.moe.route(h.cuda())[2].cpu()
    differ = int((idx_cpu != idx_card).any(-1).sum())
    assert differ <= 0.001 * h.shape[0] * h.shape[1]
    routes = {"cpu": [], "cuda": []}
    orig = tl.LlamaMoE.route

    def route(mod, xg):
        out = orig(mod, xg)
        routes[xg.device.type].append(out[2].reshape(-1, cfg.num_experts_per_tok).cpu())
        return out

    monkeypatch.setattr(tl.LlamaMoE, "route", route)
    tfa.FLASH_FWD_LAUNCHES = 0
    with torch.no_grad():
        want = cpu(tokens)
        got = card(tokens.cuda()).cpu()
    assert tfa.FLASH_FWD_LAUNCHES == cfg.num_hidden_layers
    same = torch.ones(tokens.numel(), dtype=torch.bool)
    for a, b in zip(routes["cpu"], routes["cuda"]):
        same &= (a == b).all(-1)[: tokens.numel()]
    assert int((~same).sum()) <= max(1, 0.01 * tokens.numel())
    rows = same.reshape(tokens.shape)
    assert torch.isfinite(got).all()
    assert row_rel_err(got[rows], want[rows]) <= 2.0 ** -5


@pytest.mark.requires_cuda
def test_full_ft_step_on_cuda_matches_cpu():
    """One full-parameter step (bf16 compute over f32 weights, every
    parameter trained) through the flash kernels on the card against the
    CPU from the same weights: the loss within 2e-3 relative, and at least
    99% of every parameter's elements within 2e-3 of the CPU's (Adam's first
    step moves each element by about the learning rate, 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    import numpy as np

    from fedml_tpu_torch.models.llm.convert import ref_path
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm.trainer import LLMTrainer

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2)
    args = types.SimpleNamespace(max_seq_length=100, per_device_batch_size=2,
                                 learning_rate=1e-2)
    trainers = {}
    for dev in ("cpu", "cuda"):
        tr = LLMTrainer(cfg, args, device=dev)
        tr.init(seed=0)
        trainers[dev] = tr
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    assert not trainers["cuda"].lora_only
    rng = np.random.default_rng(0)
    x = rng.integers(0, 12, size=(2, 100))  # repeated tokens
    y = (x + 1) % cfg.vocab_size
    m = np.ones(2, np.float32)
    losses = {dev: tr.step(x, y, m) for dev, tr in trainers.items()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-3 * abs(losses["cpu"])
    cpu = {ref_path(n): p for n, p in trainers["cpu"].model.named_parameters()}
    for n, p in trainers["cuda"].model.named_parameters():
        close = ((p.detach().cpu() - cpu[ref_path(n)].detach()).abs() <= 2e-3).float().mean()
        assert float(close) >= 0.99, n


@pytest.mark.requires_cuda
def test_moe_and_embedding_backward_are_bit_identical_on_cuda():
    """Two forward + backward passes of the small MoE model (bf16, the
    flash kernels, every parameter trained, repeated tokens) give the same
    bits: the one-hot dispatch and combine are products, not scatters, and
    the embedding's backward (the bf16 table's, as the reference's order
    takes it) is deterministic on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    cfg, _, card = _moe_card_and_cpu()
    for p in card.parameters():
        p.requires_grad_(True)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 12, (2, 100), generator=gen).cuda()  # repeated tokens
    runs = []
    for _ in range(2):
        logits = card(tokens)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), tokens.reshape(-1))
        runs.append(torch.autograd.grad(loss, list(card.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert float(runs[0][0].abs().sum()) > 0  # the embedding got a gradient


@pytest.mark.requires_cuda
def test_cuda_round_capture_names_the_flash_forward_kernel(tmp_path):
    """A trace controller capture around one flash forward on the card
    holds the hand-written kernel's launch (CUPTI sees kernels launched
    through ctypes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    import json
    import os

    from fedml_tpu_torch.telemetry.profiling import TraceController

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 256, 128, generator=gen).to("cuda", torch.bfloat16)
    k = torch.randn(1, 2, 256, 128, generator=gen).to("cuda", torch.bfloat16)
    v = torch.randn(1, 2, 256, 128, generator=gen).to("cuda", torch.bfloat16)
    tfa.flash_attention(q, k, v)  # builds and loads the kernels first
    torch.cuda.synchronize()
    tc = TraceController(trace_dir=str(tmp_path))
    tc.arm_rounds([0])
    assert tc.on_round_start(0) and tc.unavailable is None
    tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    marker = tc.on_round_end(0)
    assert marker["ok"] and marker["trace_bytes"] > 0
    with open(os.path.join(marker["trace_dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("flash_fwd_kernel" in n for n in kernels) == 1, kernels


@pytest.mark.requires_cuda
def test_cataloged_call_peak_agrees_with_the_allocator():
    """``peak_hbm_bytes`` of a cataloged first call is the allocator's
    high-water mark (within 1%), and the catalog leaves the caller's peak
    statistics as they are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.telemetry.profiling import get_catalog, reset_catalog, wrap_program

    reset_catalog()
    f = wrap_program("test/peak", lambda x: (x @ x).relu().sum())
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rec = f.record
    assert abs(rec.peak_hbm_bytes - peak) <= 0.01 * peak, (rec.peak_hbm_bytes, peak)
    assert rec.flops == 2 * 2048 ** 3 and rec.argument_bytes == 4 * 2048 ** 2
    big = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # raise the peak
    del big
    high = torch.cuda.max_memory_allocated()
    f(x[:1024, :1024].contiguous())  # a new variant, below the caller's peak
    assert torch.cuda.max_memory_allocated() == high  # not reset behind the caller
    assert rec.n_signatures == 2
    reset_catalog()


@pytest.mark.requires_cuda
def test_int8_update_norm_on_cuda_matches_cpu():
    """The health tracker's norm of an int8 delta, read off its blocks on the
    card, equals the CPU's within 1e-6 relative (the same codes and scales;
    only the f32 sum's order differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fedml_tpu_torch.compression import derive_key, get_codec
    from fedml_tpu_torch.telemetry.health import update_norm

    gen = torch.Generator().manual_seed(7)
    delta = {"params/Conv_0/kernel": 0.01 * torch.randn(3, 3, 64, 64, generator=gen),
             "params/Dense_0/kernel": 0.02 * torch.randn(512, 10, generator=gen),
             "params/Dense_0/bias": 0.05 * torch.randn(10, generator=gen)}
    codec = get_codec("int8")
    ct_cpu = codec.encode(delta, key=derive_key(0, 1, 2), is_delta=True)
    ct_gpu = codec.encode({k: v.cuda() for k, v in delta.items()},
                          key=derive_key(0, 1, 2), is_delta=True)
    assert all(p.is_cuda for parts in ct_gpu.arrays for p in parts
               if isinstance(p, torch.Tensor))
    want, got = update_norm(ct_cpu), update_norm(ct_gpu)
    assert abs(got - want) <= 1e-6 * want, (got, want)


@pytest.mark.requires_cuda
def test_live_straggler_alert_captures_the_next_round_on_cuda(tmp_path):
    """The live plane over LOCAL on the card (LR, 3 silos, 4 rounds, silo 1
    slowed): the online doctor's straggler alert at round 2 arms a capture of
    round 3, and that capture holds CUDA kernel events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy
    import json
    import os
    import time

    from fedml_tpu_torch import telemetry
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.client.client import Client
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
    from fedml_tpu_torch.cross_silo.server.server import Server
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.telemetry.profiling import get_trace_controller

    class SlowTrainer(ClassificationTrainer):
        def train(self, params, train_data, device, a):
            time.sleep(0.35)
            return super().train(params, train_data, device, a)

    for reset in (telemetry.reset_live_plane, telemetry.reset_registry,
                  telemetry.reset_tracer, telemetry.reset_trace_controller):
        reset()
    args = load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "run_id": "cuda_live",
                        "log_file_dir": str(tmp_path)},
        "data_args": {"dataset": "synthetic", "train_size": 300, "test_size": 60,
                      "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 4, "learning_rate": 0.3, "live_telemetry": True}})
    ds = load_federated(args)
    model = create(args, ds.class_num)
    LocalBroker.destroy("cuda_live")
    try:
        server = Server(args, "cuda", ds, model)
        clients = []
        for rank in (1, 2, 3):
            cargs = copy.copy(args)
            cargs.rank = rank
            clients.append(Client(cargs, "cuda", ds, model,
                                  SlowTrainer(model, cargs) if rank == 1 else None))
        result = run_managers_to_completion(
            [server.manager] + [c.manager for c in clients], "cuda_live",
            MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=300)
        assert result["rounds"] == 4
        alerts = [a for a in server.manager._live.doctor.alerts if a["rule"] == "straggler"]
        assert [(a["client"], a["round"]) for a in alerts] == [("1", 2)]
        caps = get_trace_controller().captures
        assert [(c["round"], c["rule"], c["ok"]) for c in caps] == [(3, "straggler", True)]
        with open(os.path.join(caps[0]["trace_dir"], "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("cat") == "kernel" for e in events)
    finally:
        telemetry.reset_live_plane()
        telemetry.reset_trace_controller()
