"""Int8 weight-only quantization for serving — counterpart of
``fedml_tpu/ops/quant.py``.

Kernels are quantized to per-output-channel symmetric int8 and swapped
into the model as :class:`QuantizedTensor` attributes; ``LoRADense`` and
the LM head consume them through :func:`matmul_maybe_quantized`.

Two matmul modes, as in the reference:

* ``"dequant"`` — ``(x @ q.to(dtype)) * scale.to(dtype)``: plain PyTorch,
  which materializes the converted weight;
* ``"kernel"`` — :func:`dequant_matmul`, the fused dequant-matmul. For
  bf16 compute, at most 128 rows and 128-aligned dims (the reference's
  dispatch conditions) a CUDA tensor goes through the hand-written Hopper
  kernel ``csrc/dequant_matmul.cu``, which streams the weight as int8 and
  converts it on chip; a CPU tensor takes :func:`dequant_matmul_reference`,
  the kernel's plain version. Everything else takes the reference's
  fallback formula. (The reference calls this mode ``"pallas"``.)

Activation quantization (``w8a8``) and 4-bit residency wait for ROADMAP
item A6: the ``w8a8`` mode and the engine's 4-bit modes raise
``NotImplementedError``.
"""
from __future__ import annotations

import copy
import ctypes
import math

import torch
from torch import nn

from fedml_tpu_torch.ops import _build

MODES = ("dequant", "kernel")
_DEFERRED = ("w8a8 activation quantization and 4-bit residency are not "
             "ported yet (ROADMAP A6)")

# Launches of the CUDA dequant-matmul kernel in this process. Only the
# launch in dequant_matmul_cuda adds to it; callers may reset it to 0.
DEQUANT_MATMUL_LAUNCHES = 0


class QuantizedTensor:
    """Per-output-channel symmetric int8 weight: ``w ≈ data * scale``.

    ``data`` is int8 ``[in, out]`` (the JAX kernel layout), ``scale`` f32
    ``[out]``; ``mode`` is ``"dequant"`` or ``"kernel"`` (module docstring).
    """

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 mode: str = "dequant"):
        if mode == "w8a8":
            raise NotImplementedError(_DEFERRED)
        if mode not in MODES:
            raise ValueError(f"unknown QuantizedTensor mode {mode!r}; "
                             f"expected one of {MODES}")
        self.data = data    # int8 [in, out]
        self.scale = scale  # f32  [out]
        self.mode = mode

    def matmul(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x @ W`` under the tensor's mode."""
        if self.mode == "kernel":
            return dequant_matmul(x, self.data, self.scale, dtype)
        return _dequant_formula(x, self.data, self.scale, dtype)


def _dequant_formula(x, q, scale, dtype):
    """``(x @ q.astype(dtype)) * scale.astype(dtype)`` with JAX's type
    promotion: the product rounds to ``dtype`` before the scale."""
    ct = torch.promote_types(x.dtype, dtype)
    return (x.to(ct) @ q.to(dtype).to(ct)) * scale.to(dtype)


def quantize_int8(w: torch.Tensor, mode: str = "dequant") -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization of an ``[in, out]``
    kernel: the reference's formula, in f32, rounding half to even."""
    w = w.detach().to(torch.float32)
    amax = w.abs().amax(dim=0)                                   # [out]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale, mode=mode)


def _is_quantizable(name: str, t: torch.Tensor, min_size: int) -> bool:
    """The reference's leaf filter over a flax-style path: the last key is
    ``kernel`` or ``lm_head``, 2-D, large, and neither LoRA nor embedding."""
    keys = name.split(".")
    return (keys[-1] in ("kernel", "lm_head") and t.ndim == 2
            and t.numel() >= min_size
            and "lora" not in name and "embed" not in name)


def _shallow_module_copy(model: nn.Module) -> nn.Module:
    """A new module tree that shares every tensor with ``model``."""
    memo = {id(t): t for t in model.parameters()}
    memo.update({id(t): t for t in model.buffers()})
    for m in model.modules():
        for v in vars(m).values():
            if isinstance(v, QuantizedTensor):
                memo[id(v)] = v
    return copy.deepcopy(model, memo)


def quantize_params_int8(model: nn.Module, min_size: int = 65536,
                         mode: str = "dequant",
                         donate: bool = False) -> nn.Module:
    """Swap every large 2-D non-LoRA kernel for a :class:`QuantizedTensor`.

    Parameter names are the reference's param paths with ``.`` for ``/``
    (``layer_0.attn.q_proj.kernel``), so the same leaves are chosen. LoRA
    adapters stay f32, the embedding stays full precision and norms are 1-D.

    ``donate=True`` quantizes ``model`` in place and drops each source
    tensor as soon as its int8 twin exists, so the full-precision and int8
    copies are never both resident; the caller's model IS the result.
    Otherwise the result is a new module tree that shares every tensor it
    does not quantize, and ``model`` is untouched.
    """
    if not donate:
        model = _shallow_module_copy(model)
    # names only: a list of the parameters themselves would keep every
    # source tensor alive until the loop ends
    for name in [n for n, _ in model.named_parameters()]:
        if not _is_quantizable(name, model.get_parameter(name), min_size):
            continue
        q = quantize_int8(model.get_parameter(name), mode=mode)
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        delattr(owner, leaf)  # the module's reference to the source goes
        setattr(owner, leaf, q)
    return model


# -- fused dequant-matmul ----------------------------------------------------

def dequant_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """The kernel's plain version: bf16 activations times the int8 codes,
    summed in f32, scaled in f32, one rounding to ``dtype``."""
    return ((x.to(torch.bfloat16).float() @ q.float()) * scale.float()).to(dtype)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fedml_dequant_matmul_bf16": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "fedml_dequant_smem_bytes": [_INT],
}
# the kernel's tiles: 128 output columns a block, 128 H-rows a pipeline
# stage, 4 stages; a cluster of at most 8 blocks splits H
BLOCK_COLS, CHUNK_ROWS, STAGES, SPLITS = 128, 128, 4, (1, 2, 4, 8)
H100_SMS = 132


def dequant_splits(h: int, f: int) -> int:
    """Blocks of the kernel's cluster for an ``[H, F]`` weight, each summing
    ``H / splits`` rows: the fewest of 1, 2, 4, 8 that give the launch at
    least one block per SM of an H100 (``F / 128 * splits >= 132``), never
    splitting below the 4-stage pipeline (``STAGES`` chunks of 128 H-rows
    per block). Where the cap of 8 leaves fewer blocks (F = 1024 gives 64)
    it takes 8."""
    cols, best = f // BLOCK_COLS, 1
    for c in SPLITS:
        if h % (CHUNK_ROWS * c) or h // (CHUNK_ROWS * c) < STAGES:
            break
        best = c
        if cols * c >= H100_SMS:
            break
    return best


def _kernel_lib():
    lib = _build.load("dequant_matmul")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def kernel_smem_bytes() -> dict:
    """Dynamic shared memory of each kernel instance's launch, keyed as
    ptxas names them (``dequant_matmul_kernel<1,1>``). Builds the library."""
    lib = _kernel_lib()
    # the largest row count of each instance -> its kernel and template
    # arguments, as csrc/dequant_matmul.cu dispatches them
    instances = {8: "kernel<128,8,1,1>", 16: "kernel<128,8,2,1>",
                 32: "kernel<128,4,4,1>", 64: "wgmma_kernel<64>", 128: "wgmma_kernel<128>"}
    return {f"dequant_matmul_{args}": lib.fedml_dequant_smem_bytes(r)
            for r, args in instances.items()}


def dequant_matmul_cuda(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel: x bf16 ``[rows, H]``, q int8 ``[H, F]``,
    scale f32 ``[F]`` → bf16 ``[rows, F]``. Raises on anything it does
    not take, and if the launch is refused."""
    global DEQUANT_MATMUL_LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul_cuda needs CUDA tensors, got {x.device}")
    rows, h = x.shape
    f = q.shape[1]
    if (x.dtype != torch.bfloat16 or q.dtype != torch.int8
            or scale.dtype != torch.float32):
        raise TypeError(f"dequant_matmul_cuda takes bf16/int8/f32, got "
                        f"{x.dtype}/{q.dtype}/{scale.dtype}")
    if q.shape[0] != h or scale.shape != (f,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not (1 <= rows <= 128 and h % 128 == 0 and f % 128 == 0):
        raise ValueError(f"kernel takes 1..128 rows and 128-aligned dims, got "
                         f"rows={rows} H={h} F={f}")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("x, q and scale must be on one device")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_matmul_cuda needs contiguous tensors")
    if x.data_ptr() % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("x, the int8 weight and scale must be 16-byte aligned "
                         "(the kernel copies them in 16-byte chunks)")
    lib = _kernel_lib()
    out = torch.empty((rows, f), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.fedml_dequant_matmul_bf16(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            rows, h, f, dequant_splits(h, f), stream)
    _build.check(lib, code, "dequant_matmul launch")
    DEQUANT_MATMUL_LAUNCHES += 1
    return out


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``(x @ dequant(q)) * scale`` — the dispatch of the reference's
    ``pallas_dequant_matmul``. x: ``[..., H]``, q: int8 ``[H, F]``,
    scale: f32 ``[F]``.

    The kernel path applies for bf16 compute, at most 128 rows and H, F
    multiples of 128. On it a CUDA tensor launches the kernel (or raises)
    and a CPU tensor takes the plain version; no other device is taken.
    Every other call takes the reference's fallback formula.
    """
    lead = tuple(x.shape[:-1])
    h, f = q.shape
    rows = math.prod(lead)
    if dtype != torch.bfloat16 or rows > 128 or h % 128 or f % 128:
        return _dequant_formula(x.reshape(*lead, h), q, scale, dtype)
    x2 = x.reshape(-1, h).to(torch.bfloat16).contiguous()
    if x2.device.type == "cpu":
        out = dequant_matmul_reference(x2, q, scale, dtype)
    elif x2.device.type == "cuda":
        out = dequant_matmul_cuda(x2, q, scale)
    else:
        raise ValueError(f"dequant_matmul runs on cuda or cpu, got {x2.device}")
    return out.reshape(*lead, f)


def matmul_maybe_quantized(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` for a plain kernel or a QuantizedTensor — the one dispatch
    point the model code uses."""
    if isinstance(w, QuantizedTensor):
        return w.matmul(x, dtype)
    ct = torch.promote_types(x.dtype, dtype)
    return x.to(ct) @ w.to(dtype).to(ct)


def tree_bytes(model: nn.Module) -> int:
    """Bytes the (possibly quantized) weights of ``model`` occupy."""
    total = sum(t.numel() * t.element_size() for t in model.parameters())
    for m in model.modules():
        for v in vars(m).values():
            if isinstance(v, QuantizedTensor):
                total += v.data.numel() * v.data.element_size()
                total += v.scale.numel() * v.scale.element_size()
    return total
