"""Flash attention — counterpart of ``fedml_tpu/ops/flash_attention.py``.

Causal (or full) online-softmax attention, ``q [B, H, T, D]`` against
``k, v [B, Hkv, S, D]`` with grouped-query heads (kv head = ``h // (H /
Hkv)``), scores in f32, masked scores at ``DEFAULT_MASK_VALUE``, a
**top-left** causal mask (``row >= col``, as the Pallas kernels; the plain
``reference_attention`` is bottom-right, and the two agree when T == S, as
in training) and an f32 per-row logsumexp.

On a CUDA tensor :func:`flash_attention` runs three hand-written Hopper
kernels (``csrc/flash_attention.cu``): the forward, dq and dk/dv, which
replace ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. They
take bf16 q/k/v/dO and head_dim 64 or 128 and raise on anything else; no
code on CUDA falls back to the plain versions. On a CPU tensor the same
``_Flash`` autograd function runs the kernels' plain versions
(:func:`flash_forward_reference`, :func:`flash_backward_reference`),
which is what the CPU tests hold against the JAX kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.telemetry.profiling.catalog import kernel_cost

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (64, 128)

# Launches of each CUDA kernel in this process. Only the launch in the
# matching *_cuda wrapper adds to a count; callers may reset them to 0.
FLASH_FWD_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's yardstick of correctness)
# ---------------------------------------------------------------------------
def reference_attention(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """Plain attention, [B, H, T, D] layout — a copy of the reference's
    ``reference_attention`` (bottom-right causal mask, f32 softmax)."""
    b, h, t, d = q.shape
    _, hkv, s_len, _ = k.shape
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = torch.tril(torch.ones((t, s_len), dtype=torch.bool,
                                     device=q.device), diagonal=s_len - t)
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs,
                        v.to(torch.float32)).to(q.dtype)


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    hkv = x.shape[1]
    return torch.repeat_interleave(x, h // hkv, dim=1) if hkv != h else x


def _masked_scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """f32 ``q k^T * scale`` [B, H, T, S] with the kernels' top-left mask."""
    t, s_len = q.shape[2], k.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                     _expand_kv(k, q.shape[1]).to(torch.float32)) * sm_scale
    if causal:
        mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    return s


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, H, S, D] per-q-head sums → [B, Hkv, S, D] per kv head."""
    b, h, s_len, d = x.shape
    return x.reshape(b, hkv, h // hkv, s_len, d).sum(dim=2)


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * out)`` in f32, [B, H, T] — computed outside the kernels,
    as the reference computes it outside Pallas."""
    return (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)


def flash_forward_reference(q, k, v, causal: bool = True,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(out, lse)``, out in q's
    dtype, lse f32 [B, H, T]."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    s = _masked_scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p @ _expand_kv(v, q.shape[1]).to(torch.float32)) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s = _masked_scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = do.to(torch.float32) @ _expand_kv(v, q.shape[1]).to(torch.float32).transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool = True,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the dq kernel: ``dq = ds k`` in q's dtype."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    return (ds @ _expand_kv(k, q.shape[1]).to(torch.float32)).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: ``dk = ds^T q``, ``dv = p^T dO``,
    summed over each kv head's query heads, in k's dtype."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    hkv = k.shape[1]
    dk = _group_sum(ds.transpose(-1, -2) @ q.to(torch.float32), hkv)
    dv = _group_sum(p.transpose(-1, -2) @ do.to(torch.float32), hkv)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, out, lse, do, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """Plain version of the backward: ``(dq, dk, dv)``."""
    delta = attention_delta(do, out)
    dq = flash_dq_reference(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *flash_dkv_reference(q, k, v, do, lse, delta, causal, sm_scale))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fedml_flash_fwd_bf16": [_PTR] * 5 + [_INT] * 7 + [_FLOAT, _PTR],
    "fedml_flash_bwd_dq_bf16": [_PTR] * 7 + [_INT] * 7 + [_FLOAT, _PTR],
    "fedml_flash_bwd_dkv_bf16": [_PTR] * 8 + [_INT] * 7 + [_FLOAT, _PTR],
    "fedml_flash_smem_bytes": [_INT, _INT],
}
_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def kernel_smem_bytes() -> dict:
    """Dynamic shared memory of each kernel's launch, keyed as ptxas names
    the instances (``flash_bwd_dq_kernel<128>``). Builds the library."""
    lib = _kernel_lib()
    return {f"{n}<{d}>": lib.fedml_flash_smem_bytes(i, d)
            for i, n in enumerate(_KERNEL_NAMES) for d in HEAD_DIMS}


def _check_kernel_inputs(what: str, q, k, *rest) -> Tuple[int, ...]:
    """Raise on anything the kernels do not take; return the dims."""
    tensors = (q, k, *rest)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{what} needs CUDA tensors on one device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{what} takes bf16 q/k/v/dO, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what} takes [B, H, T, D] q and [B, Hkv, S, D] k/v")
    b, h, t, d = q.shape
    _, hkv, s_len, dk = k.shape
    if d not in HEAD_DIMS or dk != d:
        raise ValueError(f"{what} takes head_dim in {HEAD_DIMS}, got {d} / {dk}")
    if k.shape[0] != b or hkv == 0 or h % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not form grouped-query heads")
    for t_ in tensors:
        if not t_.is_contiguous() or t_.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous, 16-byte aligned tensors")
    return b, h, hkv, t, s_len, d


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_forward_cuda(q, k, v, causal: bool = True,
                       sm_scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: ``(out bf16 [B,H,T,D], lse f32 [B,H,T])``."""
    global FLASH_FWD_LAUNCHES
    dims = _check_kernel_inputs("flash forward", q, k, v)
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    lib = _kernel_lib()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.fedml_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *dims, int(causal), scale, _stream(q.device))
    _build.check(lib, code, "flash forward launch")
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def _check_rows(q, *rows):
    for r in rows:
        if (r.dtype != torch.float32 or tuple(r.shape) != tuple(q.shape[:3])
                or not r.is_contiguous() or r.device != q.device):
            raise ValueError("lse/delta must be contiguous f32 [B, H, T] on q's device")


def flash_dq_cuda(q, k, v, do, lse, delta, causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dq kernel: ``dq`` bf16 [B, H, T, D]."""
    global FLASH_DQ_LAUNCHES
    dims = _check_kernel_inputs("flash dq", q, k, v, do)
    _check_rows(q, lse, delta)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    lib = _kernel_lib()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.fedml_flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
            int(causal), scale, _stream(q.device))
    _build.check(lib, code, "flash dq launch")
    FLASH_DQ_LAUNCHES += 1
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True,
                   sm_scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel: ``(dk, dv)`` bf16 [B, Hkv, S, D], already
    summed over each kv head's query heads."""
    global FLASH_DKV_LAUNCHES
    dims = _check_kernel_inputs("flash dk/dv", q, k, v, do)
    _check_rows(q, lse, delta)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    lib = _kernel_lib()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = lib.fedml_flash_bwd_dkv_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, int(causal), scale, _stream(q.device))
    _build.check(lib, code, "flash dk/dv launch")
    FLASH_DKV_LAUNCHES += 1
    return dk, dv


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------
def kernel_costs(q: torch.Tensor, k: torch.Tensor, causal: bool
                 ) -> Dict[str, Tuple[float, float]]:
    """Each kernel's ``(FLOPs, bytes)`` at these shapes, as the program
    catalog books them: products of 4 (forward: q k^T, p v), 6 (dq) and 8
    (dk/dv) FLOPs per (query, key) pair and head dim under the top-left
    causal mask, and every input read once, every output written once."""
    b, h, t, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    n = min(t, s_len)
    pairs = n * (n + 1) // 2 + (t - n) * s_len if causal else t * s_len
    per = b * h * d * pairs
    q_bytes = q.element_size() * b * h * t * d
    kv_bytes = k.element_size() * b * hkv * s_len * d
    rows = 4 * b * h * t
    return {
        "fwd": (4.0 * per, 2 * q_bytes + 2 * kv_bytes + rows),
        "dq": (6.0 * per, 3 * q_bytes + 2 * kv_bytes + 2 * rows),
        "dkv": (8.0 * per, 2 * q_bytes + 4 * kv_bytes + 2 * rows),
    }


def _device_type(q: torch.Tensor) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    return q.device.type


class _Flash(torch.autograd.Function):
    """Forward and backward of flash attention: the CUDA kernels on a CUDA
    tensor, their plain versions on a CPU tensor. Saves q, k, v, out, lse;
    the backward launches dq, then dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        with kernel_cost(*kernel_costs(q, k, causal)["fwd"]):
            if _device_type(q) == "cuda":
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                out, lse = flash_forward_cuda(q, k, v, causal, sm_scale)
            else:
                out, lse = flash_forward_reference(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():  # a create_graph=True backward
            raise NotImplementedError(
                "flash attention has no second derivative: its backward (the "
                "kernels', like the reference's custom_vjp) is not differentiable, "
                "so a gradient of a gradient (DLG's match) needs the plain attention")
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.sm_scale
        costs = kernel_costs(q, k, causal)
        cuda = _device_type(q) == "cuda"
        if cuda:
            do = do.contiguous()
        delta = attention_delta(do, out)
        with kernel_cost(*costs["dq"]):
            dq = (flash_dq_cuda if cuda else flash_dq_reference)(
                q, k, v, do, lse, delta, causal, scale)
        with kernel_cost(*costs["dkv"]):
            dk, dv = (flash_dkv_cuda if cuda else flash_dkv_reference)(
                q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Tiled online-softmax attention. q: [B, H, T, D]; k/v: [B, Hkv, S, D].

    Dispatches on the tensor's device only: CUDA runs the Hopper kernels
    (bf16, head_dim 64 or 128, else it raises), CPU runs their plain
    versions. Differentiable in q, k and v.
    """
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _Flash.apply(q, k, v, bool(causal), scale)
