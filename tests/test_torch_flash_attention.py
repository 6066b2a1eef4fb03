"""The port's flash attention (``fedml_tpu_torch/ops/flash_attention.py``)
against the reference's Pallas kernels run in interpret mode on the CPU.

The port's CPU path is the kernels' plain versions; they are held to the
JAX ``_fwd`` (out and lse) and to ``jax.vjp`` through the interpret-mode
custom VJP (dq, dk, dv), fp32, within 1e-4. The CUDA kernels themselves
are held to the same plain versions on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase d)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import flash_attention as jfa
from fedml_tpu_torch.ops import flash_attention as tfa

# name: (H, Hkv, T, S, causal, block)
CASES = {
    "gqa_causal": (4, 2, 64, 64, True, 32),
    "gqa_full": (4, 2, 64, 64, False, 32),
    "mha_causal": (2, 2, 64, 64, True, 64),
    "mha_full": (2, 2, 64, 64, False, 64),
    "ragged_causal": (4, 2, 100, 100, True, 32),
    "ragged_full": (2, 2, 100, 100, False, 32),
    "t_lt_s_causal": (4, 2, 48, 96, True, 32),
    "t_gt_s_causal": (2, 1, 96, 48, True, 32),
}
D = 32
TOL = 1e-4


def _inputs(h, hkv, t, s, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, h, t, D)).astype(np.float32)
    k = rng.normal(size=(1, hkv, s, D)).astype(np.float32)
    v = rng.normal(size=(1, hkv, s, D)).astype(np.float32)
    do = rng.normal(size=(1, h, t, D)).astype(np.float32)
    return q, k, v, do


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_pallas_kernel(case):
    h, hkv, t, s, causal, block = CASES[case]
    q, k, v, _ = _inputs(h, hkv, t, s)
    j_out, j_lse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5,
                            causal, block, block, True)
    out, lse = tfa.flash_forward_reference(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), causal, D ** -0.5)
    assert lse.shape == (1, h, t) and lse.dtype == torch.float32
    _close(out.numpy(), j_out)
    _close(lse.numpy(), np.asarray(j_lse)[..., 0])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_kernels(case):
    h, hkv, t, s, causal, block = CASES[case]
    q, k, v, do = _inputs(h, hkv, t, s, seed=1)

    def jf(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True,
                                   block_q=block, block_k=block)

    _, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tfa.flash_forward_reference(tq, tk, tv, causal, D ** -0.5)
    grads = tfa.flash_backward_reference(tq, tk, tv, out, lse, tdo, causal, D ** -0.5)
    for got, want, ref in zip(grads, j_grads, (tq, tk, tv)):
        assert got.shape == ref.shape
        _close(got.numpy(), want)


def test_top_left_alignment_differs_from_reference_attention():
    """With T != S the kernels' top-left causal mask is not the plain
    reference's bottom-right one; the port follows the kernels."""
    q, k, v, _ = _inputs(2, 1, 24, 48, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kernel_like = tfa.flash_attention(tq, tk, tv, causal=True)
    bottom_right = tfa.reference_attention(tq, tk, tv, causal=True)
    assert (kernel_like - bottom_right).abs().max() > 1e-2
    j_out, _ = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5,
                        True, 16, 16, True)
    _close(kernel_like.numpy(), j_out)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 2), (2, 2)])
def test_autograd_function_matches_autograd_through_reference(causal, heads):
    """``_Flash`` on the CPU (plain forward and backward) against autograd
    through ``reference_attention`` (T == S, where the masks agree)."""
    h, hkv = heads
    q, k, v, do = _inputs(h, hkv, 40, 40, seed=3)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out_a = tfa.flash_attention(*a, causal=causal)
    out_b = tfa.reference_attention(*b, causal=causal)
    _close(out_a.detach().numpy(), out_b.detach().numpy())
    out_a.backward(torch.from_numpy(do))
    out_b.backward(torch.from_numpy(do))
    for x, y in zip(a, b):
        _close(x.grad.numpy(), y.grad.numpy())


def test_wrappers_count_only_kernel_launches_and_refuse_cpu():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, 2, 16, 16))
    before = (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_DQ_LAUNCHES, tfa.FLASH_DKV_LAUNCHES)
    qg = q.clone().requires_grad_()
    tfa.flash_attention(qg, k, v).float().sum().backward()  # plain versions on the CPU
    assert qg.grad.dtype == torch.bfloat16
    lse = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_forward_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_dq_cuda(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_dkv_cuda(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_DQ_LAUNCHES,
            tfa.FLASH_DKV_LAUNCHES) == before


def test_kernel_signatures_match_the_c_interface():
    """The ctypes argument lists follow the extern "C" declarations."""
    import re
    from pathlib import Path

    src = (Path(tfa.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    for name, argtypes in tfa._SIGNATURES.items():
        decl = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        params = [p.strip() for p in decl.split(",")]
        assert len(params) == len(argtypes), name
        for p, a in zip(params, argtypes):
            want = {"int": tfa.ctypes.c_int, "float": tfa.ctypes.c_float}.get(
                p.split()[0], tfa.ctypes.c_void_p)
            assert a is want, (name, p)
