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
