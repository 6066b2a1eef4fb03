"""Int8 and 4-bit weight-only quantization — counterpart of
``fedml_tpu/ops/quant.py``.

Large 2-D kernels are swapped into the model as :class:`QuantizedTensor`
(per-output-channel symmetric int8) or :class:`QuantizedTensor4`
(blockwise int4 or NF4 codes, two per byte, one f32 absmax scale per
block — the layout of the ``int4``/``nf4`` wire codecs) attributes;
``LoRADense`` and the LM head consume them through
:func:`matmul_maybe_quantized`.

Three int8 matmul modes, as in the reference:

* ``"dequant"`` — ``(x @ q.to(dtype)) * scale.to(dtype)``: plain PyTorch,
  which materializes the converted weight;
* ``"w8a8"`` — :func:`w8a8_matmul`: each activation row quantized to int8
  on the fly, an exact int8 × int8 → int32 product (``torch._int_mm`` on
  CUDA, whose operand layout the tensor takes once, at construction), and
  the two scales applied in f32;
* ``"kernel"`` — :func:`dequant_matmul`, the fused dequant-matmul. For
  bf16 compute, at most 128 rows and 128-aligned dims (the reference's
  dispatch conditions) a CUDA tensor goes through the hand-written Hopper
  kernel ``csrc/dequant_matmul.cu``, which streams the weight as int8 and
  converts it on chip; a CPU tensor takes :func:`dequant_matmul_reference`,
  the kernel's plain version. Everything else takes the reference's
  fallback formula. (The reference calls this mode ``"pallas"``.)

A 4-bit weight is dequantized per call, in chunks, and multiplied in
``dtype`` (the reference does the same as an XLA temporary): no
full-precision copy of the whole base is ever built.

Every quantized product runs through one ``torch.autograd.Function``
(:func:`matmul_maybe_quantized`), which treats the weight as frozen: it
saves nothing for backward but the reference to the quantized tensor, and
its backward dequantizes again and returns only ``dy @ Wᵀ``. Autograd
through the plain formula would instead keep every layer's dequantized
weight alive until backward.
"""
from __future__ import annotations

import copy
import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.compression.codecs import _NF4_MIDPOINTS, NF4_CODEBOOK
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.telemetry import get_registry

MODES = ("dequant", "w8a8", "kernel")

# Launches of the CUDA dequant-matmul kernel in this process. Only the
# launch in dequant_matmul_cuda adds to it; callers may reset it to 0.
DEQUANT_MATMUL_LAUNCHES = 0


class QuantizedTensor:
    """Per-output-channel symmetric int8 weight: ``w ≈ data * scale``.

    ``data`` is int8 ``[in, out]`` (the JAX kernel layout), ``scale`` f32
    ``[out]``; ``mode`` is one of :data:`MODES` (module docstring). In
    ``w8a8`` mode ``data`` is stored column-major (strides ``(1, in)``):
    ``torch._int_mm`` on an H100 reads it several times faster than the
    row-major layout, and the copy is made here, once.
    """

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 mode: str = "dequant"):
        if mode not in MODES:
            raise ValueError(f"unknown QuantizedTensor mode {mode!r}; "
                             f"expected one of {MODES}")
        if mode == "w8a8" and data.stride(0) != 1:
            data = data.t().contiguous().t()
        self.data = data    # int8 [in, out]
        self.scale = scale  # f32  [out]
        self.mode = mode

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.data.to(dtype) * self.scale.to(dtype)[None, :]

    def matmul(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x @ W`` under the tensor's mode, as a frozen weight."""
        return _FrozenBaseMatmul.apply(x, self, dtype)

    def _forward(self, x, dtype):
        if self.mode == "w8a8":
            return w8a8_matmul(x, self.data, self.scale, dtype)
        if self.mode == "kernel":
            return dequant_matmul(x, self.data, self.scale, dtype)
        return _dequant_formula(x, self.data, self.scale, dtype)

    def _input_grad(self, dy, dtype):
        """dx of :func:`_dequant_formula` for the output gradient ``dy``."""
        if self.mode != "dequant":
            raise RuntimeError(
                f"no gradient through the {self.mode!r} lowering (a serving "
                f"mode, as in the reference); a frozen int8 base trains in "
                f"mode 'dequant'")
        return (dy * self.scale.to(dtype)) @ self.data.to(dtype).to(dy.dtype).T


def _dequant_formula(x, q, scale, dtype):
    """``(x @ q.astype(dtype)) * scale.astype(dtype)`` with JAX's type
    promotion: the product rounds to ``dtype`` before the scale."""
    ct = torch.promote_types(x.dtype, dtype)
    return (x.to(ct) @ q.to(dtype).to(ct)) * scale.to(dtype)


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` rounded once, as the reference's eager division: a
    tensor divisor, because CUDA divides by a Python scalar as a product
    with its f32 reciprocal, which can differ in the last bit."""
    return amax / torch.full_like(amax, 127.0)


def quantize_int8(w: torch.Tensor, mode: str = "dequant") -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization of an ``[in, out]``
    kernel: the reference's formula, in f32, rounding half to even."""
    w = w.detach().to(torch.float32)
    amax = w.abs().amax(dim=0)                                   # [out]
    scale = torch.where(amax > 0, _div127(amax), torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale, mode=mode)


def _is_quantizable(name: str, t: torch.Tensor, min_size: int) -> bool:
    """The reference's leaf filter over a flax-style path: the last key is
    ``kernel`` or ``lm_head``, 2-D, large, and neither LoRA nor embedding."""
    keys = name.split(".")
    return (keys[-1] in ("kernel", "lm_head") and t.ndim == 2
            and t.numel() >= min_size
            and "lora" not in name and "embed" not in name)


def named_quantized_weights(model: nn.Module):
    """``(name, weight)`` of every quantized weight ``model`` holds as a
    module attribute, named as the parameter it replaced
    (``layer_0.attn.q_proj.kernel``)."""
    for mod_name, m in model.named_modules():
        for k, v in vars(m).items():
            if isinstance(v, (QuantizedTensor, QuantizedTensor4)):
                yield (f"{mod_name}.{k}" if mod_name else k), v


def _shallow_module_copy(model: nn.Module) -> nn.Module:
    """A new module tree that shares every tensor and every quantized
    weight with ``model``."""
    memo = {id(t): t for t in model.parameters()}
    memo.update({id(t): t for t in model.buffers()})
    memo.update({id(v): v for _, v in named_quantized_weights(model)})
    return copy.deepcopy(model, memo)


def _swap_params(model: nn.Module, min_size: int, donate: bool, quantize):
    """Replace every parameter :func:`_is_quantizable` picks by
    ``quantize(tensor)``; ``donate`` as in :func:`quantize_params_int8`.
    Returns ``(model, [new weights])``."""
    if not donate:
        model = _shallow_module_copy(model)
    made = []
    # names only: a list of the parameters themselves would keep every
    # source tensor alive until the loop ends
    for name in [n for n, _ in model.named_parameters()]:
        if not _is_quantizable(name, model.get_parameter(name), min_size):
            continue
        q = quantize(model.get_parameter(name))
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        delattr(owner, leaf)  # the module's reference to the source goes
        setattr(owner, leaf, q)
        made.append(q)
    return model, made


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
    return _swap_params(model, min_size, donate,
                        lambda t: quantize_int8(t, mode=mode))[0]


# -- activation quantization (w8a8) -------------------------------------------

# torch._int_mm on CUDA refuses 16 rows or fewer (checked on an H100,
# torch 2.11): shorter inputs are padded with zero rows to this count
INT_MM_MIN_ROWS = 32


def quantize_rows_int8(x: torch.Tensor):
    """Dynamic symmetric per-row int8 quantization of activations:
    ``(codes int8, scale f32 [..., 1])`` with the f32 absmax over the last
    dim, ``xs = amax / 127`` (1 where amax is 0), rounding half to even."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(amax > 0, _div127(amax), torch.ones_like(amax))
    return torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8), xs


def int8_product_reference(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``xq @ q`` of int8 ``[m, k]`` and ``[k, n]``
    in plain PyTorch, through a float64 product: every partial sum is an
    integer below ``k * 127^2 < 2^53``, so each is exact, in any order."""
    return (xq.to(torch.float64) @ q.to(torch.float64)).to(torch.int32)


def int8_product_cuda(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(xq, q)`` on CUDA tensors, with fewer than
    :data:`INT_MM_MIN_ROWS` rows padded with zero rows (sliced off again)."""
    if xq.device.type != "cuda":
        raise ValueError(f"int8_product_cuda needs CUDA tensors, got {xq.device}")
    m, k = xq.shape
    if k % 8 or q.shape[1] % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got "
                         f"K={k} N={q.shape[1]}")
    if m < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, q)[:m]


def int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq @ q``: ``torch._int_mm`` for CUDA tensors, the
    plain version for CPU ones."""
    if xq.device.type == "cuda":
        return int8_product_cuda(xq, q)
    if xq.device.type == "cpu":
        return int8_product_reference(xq, q)
    raise ValueError(f"int8_product runs on cuda or cpu, got {xq.device}")


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``_matmul_w8a8``: per-row activation codes, an exact
    int32 product, then ``(acc * xs * scale).to(dtype)`` in f32, in that
    order. x ``[..., H]``, q int8 ``[H, F]``, scale f32 ``[F]``."""
    xq, xs = quantize_rows_int8(x)
    lead = tuple(x.shape[:-1])
    acc = int8_product(xq.reshape(-1, q.shape[0]), q).reshape(*lead, q.shape[1])
    return w8a8_rescale(acc, xs, scale, dtype)


def w8a8_rescale(acc: torch.Tensor, xs: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``(acc * xs * scale).to(dtype)``: the int32 accumulators times the
    row scales, then the column scales, each product rounded in f32."""
    return (acc.to(torch.float32) * xs * scale).to(dtype)


# -- 4-bit residency (QLoRA-style int4/NF4 base weights) ----------------------
#
# The packed layout of the int4/nf4 wire codecs: two codes per uint8
# (element 2i in the low nibble of byte i) and one f32 absmax scale per
# block, quantized once with deterministic round-to-nearest.

DEFAULT_BLOCK4 = 64  # QLoRA convention for base-weight residency
FORMATS4 = ("int4", "nf4")
# int4's scale is amax * f32(1/7), not amax / 7: the reference quantizes in
# a jitted program, where XLA turns the division by the constant into a
# product with its f32 reciprocal (the two differ in the last bit)
INV7 = float(np.float32(1.0) / np.float32(7.0))
# elements a quantize or dequantize step handles at once: bounds the f32
# and index temporaries (the LM head's 525M elements take 8 steps)
CHUNK_ELEMS = 1 << 26


def _unpack4(packed: torch.Tensor) -> torch.Tensor:
    """``[..., k]`` uint8 → ``[..., 2k]`` int32 codes; element 2i is the
    low nibble of byte i (the wire codec's layout)."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


def _codes_to_vals(codes: torch.Tensor, fmt: str) -> torch.Tensor:
    """Codes → f32 values before the block scale: the NF4 codebook entry,
    or ``code - 8`` for int4. (A uint8 index would be a mask: index with
    int64.)"""
    if fmt == "nf4":
        return torch.from_numpy(NF4_CODEBOOK).to(codes.device)[codes.long()]
    return codes.to(torch.float32) - 8.0


@functools.lru_cache(maxsize=None)
def _byte_table(fmt: str, device: torch.device) -> torch.Tensor:
    """f32 ``[256, 2]``: the two values (before the scale) that byte b
    packs, ``_codes_to_vals(_unpack4(b))``."""
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8)[:, None]
    return _codes_to_vals(_unpack4(b), fmt).to(device)


def _check_fmt_block(fmt: str, block: int) -> int:
    if fmt not in FORMATS4:
        raise ValueError(
            f"4-bit base format must be 'int4' or 'nf4', got {fmt!r}")
    block = int(block)
    if block < 2 or block > (1 << 20) or block & (block - 1):
        raise ValueError(
            f"4-bit block must be a power of two in [2, 2^20], got {block}")
    return block


def _quantize4_blocks(w: torch.Tensor, fmt: str, block: int):
    """Flatten row-major → pad with zeros to a block multiple → absmax per
    block → codes → packed nibbles: ``(data uint8 [n_blocks, block // 2],
    scale f32 [n_blocks])``, bit-identical to the reference. int4 codes are
    ``clip(round(x / s), -7, 7) + 8`` with ``s = amax * INV7``; NF4 codes
    count the codebook midpoints strictly below ``x / amax``
    (``torch.bucketize``, no ``[..., 15]`` comparison temporary)."""
    flat = w.detach().reshape(-1)
    size = flat.numel()
    n_blocks = -(-size // block)
    data = torch.empty((n_blocks, block // 2), dtype=torch.uint8, device=w.device)
    scale = torch.empty((n_blocks,), dtype=torch.float32, device=w.device)
    mids = torch.from_numpy(_NF4_MIDPOINTS).to(w.device)
    per = max(1, CHUNK_ELEMS // block)
    for b0 in range(0, n_blocks, per):
        b1 = min(n_blocks, b0 + per)
        xb = flat[b0 * block:b1 * block].to(torch.float32)
        # padding encodes to exact 0 in both formats (int4 code 8, nf4
        # code 7): it adds no mass and dequantizes to zero
        xb = F.pad(xb, (0, (b1 - b0) * block - xb.numel())).reshape(b1 - b0, block)
        amax = xb.abs().amax(dim=1)
        if fmt == "nf4":
            s = torch.where(amax > 0, amax, torch.ones_like(amax))
            codes = torch.bucketize(xb / s[:, None], mids, out_int32=True)
        else:
            s = torch.where(amax > 0, amax * INV7, torch.ones_like(amax))
            codes = torch.clamp(torch.round(xb / s[:, None]), -7, 7).to(torch.int32) + 8
        data[b0:b1] = (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8)
        scale[b0:b1] = s
    return data, scale


class QuantizedTensor4:
    """Blockwise 4-bit weight: ``w ≈ lookup(codes) * scale`` per block.

    ``data`` holds two codes per uint8 (``[n_blocks, block // 2]``),
    ``scale`` one f32 per block; ``fmt`` is ``"int4"`` (uniform, codes − 8)
    or ``"nf4"`` (the normal-float codebook of Dettmers et al. 2023).
    :meth:`matmul` dequantizes per call and multiplies; the dequantized
    matrix lives only for that call.
    """

    def __init__(self, data: torch.Tensor, scale: torch.Tensor, shape,
                 fmt: str = "int4", block: int = DEFAULT_BLOCK4):
        self.data = data              # uint8 [n_blocks, block // 2]
        self.scale = scale            # f32   [n_blocks]
        self.orig_shape = tuple(int(d) for d in shape)
        self.fmt = fmt
        self.block = int(block)

    @property
    def shape(self):
        return self.orig_shape

    @property
    def size(self) -> int:
        return math.prod(self.orig_shape)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The weight in ``dtype``: each value times its block's scale in
        f32, rounded once to ``dtype``. Built chunk by chunk into the
        output, so the f32 temporaries stay at :data:`CHUNK_ELEMS`."""
        n_blocks, block = self.data.shape[0], self.block
        table = _byte_table(self.fmt, self.data.device)
        out = torch.empty(n_blocks * block, dtype=dtype, device=self.data.device)
        per = max(1, CHUNK_ELEMS // block)
        for b0 in range(0, n_blocks, per):
            b1 = min(n_blocks, b0 + per)
            vals = table.index_select(0, self.data[b0:b1].reshape(-1).to(torch.int32))
            vals = vals.view(b1 - b0, block).mul_(self.scale[b0:b1, None])
            out[b0 * block:b1 * block].view(b1 - b0, block).copy_(vals)
        return out[:self.size].view(self.orig_shape)

    def matmul(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x @ dequant(W)``, as a frozen weight."""
        return _FrozenBaseMatmul.apply(x, self, dtype)

    def _forward(self, x, dtype):
        ct = torch.promote_types(x.dtype, dtype)
        return x.to(ct) @ self.dequantize(dtype).to(ct)

    def _input_grad(self, dy, dtype):
        return dy @ self.dequantize(dtype).to(dy.dtype).T


def quantize_int4(w: torch.Tensor, fmt: str = "int4",
                  block: int = DEFAULT_BLOCK4) -> QuantizedTensor4:
    """Blockwise 4-bit quantization of a kernel (round-to-nearest)."""
    block = _check_fmt_block(fmt, block)
    data, scale = _quantize4_blocks(w, fmt, block)
    return QuantizedTensor4(data, scale, w.shape, fmt=fmt, block=block)


def quantize_params_int4(model: nn.Module, fmt: str = "int4",
                         min_size: int = 65536, block: int = DEFAULT_BLOCK4,
                         donate: bool = False) -> nn.Module:
    """Swap every large 2-D non-LoRA kernel for a :class:`QuantizedTensor4`.

    Same leaf filter and ``donate`` contract as :func:`quantize_params_int8`.
    Sets the ``quant/base_bytes`` gauge to the packed footprint (codes and
    scales) and adds the packed leaves to the ``quant/packed_leaves``
    counter of the port's registry.
    """
    model, made = _swap_params(model, min_size, donate,
                               lambda t: quantize_int4(t, fmt=fmt, block=block))
    reg = get_registry()
    reg.gauge("quant/base_bytes").set(
        sum(q.data.numel() + 4 * q.scale.numel() for q in made))
    if made:
        reg.counter("quant/packed_leaves").inc(len(made))
    return model


# -- the frozen-base product ---------------------------------------------------

class _FrozenBaseMatmul(torch.autograd.Function):
    """``x @ W`` for a quantized ``W`` that gets no gradient. Saves only the
    reference to the quantized tensor (its codes and scales, which the
    model holds anyway); backward dequantizes again and returns
    ``dy @ Wᵀ`` as autograd through the plain formula would."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        ctx.w, ctx.dtype, ctx.x_dtype = w, dtype, x.dtype
        return w._forward(x, dtype)

    @staticmethod
    def backward(ctx, dy):
        return ctx.w._input_grad(dy, ctx.dtype).to(ctx.x_dtype), None, None


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
    """``x @ w`` for a plain kernel, a :class:`QuantizedTensor` or a
    :class:`QuantizedTensor4` — the one dispatch point the model code uses."""
    if isinstance(w, (QuantizedTensor, QuantizedTensor4)):
        return w.matmul(x, dtype)
    ct = torch.promote_types(x.dtype, dtype)
    return x.to(ct) @ w.to(dtype).to(ct)


def tree_bytes(model: nn.Module) -> int:
    """Bytes the (possibly quantized) weights of ``model`` occupy."""
    total = sum(t.numel() * t.element_size() for t in model.parameters())
    for _, v in named_quantized_weights(model):
        total += v.data.numel() * v.data.element_size()
        total += v.scale.numel() * v.scale.element_size()
    return total
