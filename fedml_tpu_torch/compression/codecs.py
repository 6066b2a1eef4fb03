"""Wire codecs — counterpart of ``fedml_tpu/compression/codecs.py``.

Each codec encodes a parameter tree (a flat ``{path: tensor}`` dict, leaves
in the reference's order: ``utils/tree.leaf_order``) leaf by leaf on the
tensors' own device, so what crosses the wire is the compressed form —
int8 blocks and f32 scales, bf16 halves, top-k (value, index) pairs or
packed 4-bit codes — never the f32 tree:

  identity   tagged passthrough — bit-exact
  bf16       f32→bf16 cast — 2×, deterministic
  int8       per-leaf stochastic uniform quantization — ~4×, unbiased,
             |err| ≤ max|leaf|/127 per element
  topk       per-leaf top-k by magnitude — exact kept entries, ties broken
             by the lowest index as ``jax.lax.top_k`` does
  int4       blockwise stochastic 4-bit, two codes a byte + one f32 absmax
             scale per block (``int4@128`` sets the block)
  nf4        blockwise NF4 (QLoRA's normal-float codebook), same packing

Integer and bool leaves pass through raw. For the same leaves and key the
wire arrays equal the reference's byte for byte: the stochastic codecs
draw their noise from :mod:`.threefry`, the twin of JAX's PRNG, and each
scale is computed as the reference's jitted program rounds it — inside
``jax.jit`` XLA turns a division by a constant into a product with its f32
reciprocal (``amax / 127`` → ``amax * f32(1/127)``), while a division by a
traced value stays a division, which here is a tensor / tensor division on
every device (CUDA turns a division by a Python scalar into a product).

``secagg_int8``, the masked secure-aggregation codec, lives in
``privacy/secagg/codec.py`` and registers here on first use; it decodes
nothing by itself (masked trees resolve only in aggregate) and no generic
weighted sum takes it. The federated-analytics sketch codecs are legal wire
tags but come with ROADMAP A10.5; resolving one raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.utils.tree import Tree, tree_flatten

WIRE_VERSION = 1
# the masked secure-aggregation wire: v1's framing plus a validated "sa"
# metadata field, for maskable codecs only
WIRE_VERSION_MASKED = 2

# meta entry per original leaf: (dtype string, shape tuple)
LeafMeta = Tuple[str, Tuple[int, ...]]

_F32_1_OVER_127 = float(np.float32(1.0) / np.float32(127.0))
_F32_1_OVER_7 = float(np.float32(1.0) / np.float32(7.0))

# NF4: the 16-entry normal-float codebook of Dettmers et al. 2023 —
# quantiles of N(0,1) rescaled so the range is exactly [-1, 1] and zero
# is representable. Codes are indices into this table.
NF4_CODEBOOK = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], np.float32)
# nearest-codeword binning: code = #{midpoints below v}
_NF4_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2.0


def _dtype_str(dt: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"``: the reference's meta spelling."""
    return str(dt).replace("torch.", "")


def _dtype_from_str(s: str) -> torch.dtype:
    dt = getattr(torch, s, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown leaf dtype {s!r} in a wire tree")
    return dt


def _is_float_meta(dt: str) -> bool:
    return _dtype_from_str(dt).is_floating_point


def _numel(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


class CompressedTree:
    """A tree encoded by a named codec, ready for the wire.

    ``arrays`` is a flat list over the original leaves, each entry the
    codec's positional list of tensors for that leaf (``[q, scale]`` for
    int8). ``structure`` is the tuple of the tree's keys in leaf order, so
    decode rebuilds the same dict. ``meta`` holds each leaf's (dtype,
    shape) in the same order. ``sa`` is the masked wire's (v2) metadata
    dict — round, rank and roster — and None on a plain (v1) tree.
    """

    __slots__ = ("codec", "version", "is_delta", "raw_nbytes", "meta",
                 "structure", "arrays", "sa")

    def __init__(self, codec: str, version: int, is_delta: bool,
                 raw_nbytes: int, meta: Sequence[LeafMeta],
                 structure: Sequence[str], arrays: List[List[Any]],
                 sa: Optional[dict] = None):
        self.codec = str(codec)
        self.version = int(version)
        self.is_delta = bool(is_delta)
        self.raw_nbytes = int(raw_nbytes)
        self.meta = tuple((str(dt), tuple(int(d) for d in sh))
                          for dt, sh in meta)
        self.structure = tuple(structure)
        self.arrays = arrays
        self.sa = dict(sa) if sa is not None else None

    def wire_nbytes(self) -> int:
        """Bytes of the encoded arrays: what the uplink carries."""
        return sum(int(np.asarray(p).nbytes) if not isinstance(p, torch.Tensor)
                   else p.numel() * p.element_size()
                   for parts in self.arrays for p in parts)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"CompressedTree(codec={self.codec}, v{self.version}, "
                f"delta={self.is_delta}, leaves={len(self.arrays)})")


def _tree_meta(leaves: Sequence[torch.Tensor]) -> Tuple[LeafMeta, ...]:
    return tuple((_dtype_str(x.dtype), tuple(int(d) for d in x.shape))
                 for x in leaves)


def _leaf_key(key: threefry.Key, i: int) -> threefry.Key:
    return threefry.fold_in(key, i)


def _is_host(a: Any) -> bool:
    """A wire array the check may read without a device sync: numpy, or a
    tensor on the CPU (the reference checks host arrays only)."""
    if isinstance(a, torch.Tensor):
        return a.device.type == "cpu"
    return isinstance(a, (np.ndarray, np.generic, float))


def _all_finite(a: Any) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.isfinite(a).all())
    return bool(np.all(np.isfinite(a)))


class Codec:
    """Base codec: per-leaf kernels and whole-tree entry points."""

    name: str = "base"
    lossless: bool = False
    # safe for a FULL-model broadcast (not just deltas): top-k is
    # upload-only
    broadcast_safe: bool = True
    maskable: bool = False

    @property
    def spec(self) -> str:
        """The negotiation-header form: name plus any parameter a peer must
        match for fused aggregation (``topk@0.05``)."""
        return self.name

    # -- per-leaf kernels --------------------------------------------------
    def encode_leaf(self, x: torch.Tensor, key: threefry.Key) -> List[torch.Tensor]:
        raise NotImplementedError

    def decode_leaf(self, parts: Sequence[torch.Tensor], dt: str,
                    shape: Tuple[int, ...]) -> torch.Tensor:
        raise NotImplementedError

    # -- tree-level helpers ------------------------------------------------
    def _encode_leaves(self, leaves, meta, key):
        out = []
        for i, (leaf, (dt, _)) in enumerate(zip(leaves, meta)):
            if _is_float_meta(dt):
                out.append(self.encode_leaf(leaf, _leaf_key(key, i)))
            else:
                out.append([leaf])  # raw passthrough for int/bool leaves
        return out

    def _decode_leaves(self, arrays, meta):
        return [self.decode_leaf(parts, dt, sh) if _is_float_meta(dt)
                else parts[0] for parts, (dt, sh) in zip(arrays, meta)]

    def qdq(self, tree: Tree, key: threefry.Key) -> Tree:
        """decode(encode(tree)): the simulated wire."""
        leaves, keys = tree_flatten(tree)
        meta = _tree_meta(leaves)
        enc = self._encode_leaves(leaves, meta, key)
        return dict(zip(keys, self._decode_leaves(enc, meta)))

    # -- batched forms: a chunk's clients stacked on axis 0 ---------------
    def encode_leaf_batch(self, x: torch.Tensor, keys: torch.Tensor) -> List[torch.Tensor]:
        """Encode ``[C, *shape]`` with key row ``c`` for row ``c``: part ``p``
        stacked ``[C, ...]``, row ``c`` equal to ``encode_leaf(x[c], keys[c])``.
        This default encodes row by row; the elementwise codecs and int8 do
        the whole chunk at once."""
        rows = [self.encode_leaf(x[c], keys[c].cpu()) for c in range(x.shape[0])]
        return [torch.stack([r[p] for r in rows]) for p in range(len(rows[0]))]

    def encode_batch(self, leaves: Sequence[torch.Tensor], meta,
                     keys: torch.Tensor) -> List[List[torch.Tensor]]:
        """The batched ``_encode_leaves``: leaves stacked ``[C, *shape]``,
        ``keys`` ``[C, 2]``; leaf ``i`` of row ``c`` is encoded under
        ``fold_in(keys[c], i)``, as ``jax.vmap`` of the reference's."""
        out = []
        for i, (leaf, (dt, _)) in enumerate(zip(leaves, meta)):
            if _is_float_meta(dt):
                out.append(self.encode_leaf_batch(leaf, threefry.fold_in_batch(keys, i)))
            else:
                out.append([leaf])
        return out

    def decode_leaf_batch(self, parts: Sequence[torch.Tensor], dt: str,
                          shape: Tuple[int, ...]) -> torch.Tensor:
        """``[C, *shape]``: row ``c`` is ``decode_leaf`` of the parts' row ``c``."""
        return torch.stack([self.decode_leaf([p[c] for p in parts], dt, shape)
                            for c in range(parts[0].shape[0])])

    def weighted_rows(self, parts: Sequence[torch.Tensor], w: torch.Tensor, dt: str,
                      shape: Tuple[int, ...]) -> torch.Tensor:
        """``[C, *shape]`` f32 rows ``w_c · decode(row c)``; the caller sums
        them in a fixed order (:func:`ordered_row_sum`)."""
        dec = self.decode_leaf_batch(parts, dt, shape).float()
        return dec * w.reshape((-1,) + (1,) * len(shape))

    # -- wire validation ---------------------------------------------------
    def check_wire(self, ct: CompressedTree) -> None:
        """Reject wire payloads whose scale-like parts are non-finite (a
        NaN scale poisons its whole block and every weighted sum it enters).
        Codecs with such parts override this. As in the reference it reads
        host arrays only — numpy or CPU tensors, what a peer sends — so an
        in-process encode on the card costs no sync. Raises ``ValueError``
        and counts ``integrity/nonfinite_wire``."""

    def _resolve_wire(self, ct: CompressedTree) -> "Codec":
        """The codec instance that matches a wire tree (the 4-bit codecs
        recover their block size from the packed arrays)."""
        return self

    def _reject_nonfinite_wire(self, what: str) -> None:
        from fedml_tpu_torch.telemetry import get_registry

        get_registry().counter("integrity/nonfinite_wire").inc()
        raise ValueError(
            f"non-finite {what} in a {self.name} wire payload — refusing "
            "to decode/aggregate a poisoned tree")

    # -- whole-tree entry points -------------------------------------------
    def encode(self, tree: Tree, key: Optional[threefry.Key] = None,
               is_delta: bool = False, residual: Optional[Tree] = None):
        """Encode a tree → :class:`CompressedTree`. With ``residual`` (error
        feedback) it also returns the new residual: ``(ct, new_residual)``.
        """
        leaves, keys = tree_flatten(tree)
        meta = _tree_meta(leaves)
        raw_nbytes = sum(_numel(sh) * _dtype_from_str(dt).itemsize
                         for dt, sh in meta)
        if key is None:
            key = threefry.key(0)
        new_residual = None
        with torch.no_grad():
            if residual is None:
                arrays = self._encode_leaves(leaves, meta, key)
            else:
                comp = [x + residual[k] for x, k in zip(leaves, keys)]
                arrays = self._encode_leaves(comp, meta, key)
                dec = self._decode_leaves(arrays, meta)
                new_residual = {
                    k: (c - d.to(c.dtype)) if _is_float_meta(dt)
                    else torch.zeros_like(c)
                    for k, c, d, (dt, _) in zip(keys, comp, dec, meta)}
        ct = CompressedTree(self.name, WIRE_VERSION, is_delta, raw_nbytes,
                            meta, keys, [list(p) for p in arrays])
        return ct if residual is None else (ct, new_residual)

    def decode(self, ct: CompressedTree) -> Tree:
        """Decode a :class:`CompressedTree` back to a full tree."""
        if ct.codec != self.name:
            raise ValueError(
                f"codec mismatch: {self.name} cannot decode {ct.codec!r}")
        if ct.version != WIRE_VERSION:
            raise ValueError(
                f"unsupported compression wire version {ct.version}")
        eff = self._resolve_wire(ct)
        if eff is not self:
            return eff.decode(ct)
        self.check_wire(ct)
        with torch.no_grad():
            flat = self._decode_leaves(ct.arrays, ct.meta)
        return dict(zip(ct.structure, flat))

    # -- dequant-fused weighted reduction ----------------------------------
    def weighted_sum_leaf(self, stacked: Sequence[torch.Tensor],
                          w: torch.Tensor, dt: str,
                          shape: Tuple[int, ...]) -> torch.Tensor:
        """Σ_i w_i · decode(leaf_i) with the client axis stacked; the default
        decodes per client, subclasses fold the dequant into the sum."""
        dec = torch.stack([self.decode_leaf([p[c] for p in stacked], dt, shape)
                           for c in range(w.shape[0])])
        return torch.einsum("c,c...->...", w, dec.float()).to(_dtype_from_str(dt))


def _raw_weighted_sum(leaf_stacked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # int/bool leaves: the weights take the leaf's dtype, as in
    # utils.tree.weighted_tree_sum
    wb = w.to(leaf_stacked.dtype).reshape((-1,) + (1,) * (leaf_stacked.ndim - 1))
    return torch.sum(leaf_stacked * wb, 0, dtype=leaf_stacked.dtype)


def ordered_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over axis 0 as a fixed pairwise tree of elementwise adds (halves,
    then halves of those), so the f32 rounding is the same on every device
    and in every run; ``torch.sum`` and ``einsum`` choose their order by
    device and shape."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = torch.cat([x[:h] + x[h:2 * h], x[2 * h:]]) if x.shape[0] % 2 else x[:h] + x[h:]
    return x[0]


def tree_delta(new: Tree, ref: Tree) -> Tree:
    """Delta of ``new`` against ``ref`` — float leaves only; int/bool leaves
    ride as absolute values (:func:`tree_undelta` is the inverse)."""
    return {k: (n - ref[k]) if n.is_floating_point() else n
            for k, n in new.items()}


def tree_undelta(ref: Tree, delta: Tree) -> Tree:
    """Apply a :func:`tree_delta` result back onto ``ref``."""
    return {k: (r + delta[k].to(r.dtype)) if r.is_floating_point() else delta[k]
            for k, r in ref.items()}


def fused_weighted_sum(cts: Sequence[CompressedTree], weights) -> Tree:
    """Σ_i w_i · decode(ct_i) over clients with the dequant folded into the
    sum: the per-client blocks are stacked on a client axis and reduced, so
    no decoded per-client f32 tree is built. ``weights`` should already be
    normalized. Refuses heterogeneous codecs, leaf-count mismatches and
    non-finite host scales, as the reference does."""
    if not cts:
        raise ValueError("empty compressed update list")
    first = cts[0]
    for ct in cts[1:]:
        if (ct.codec != first.codec or ct.version != first.version
                or ct.meta != first.meta or ct.is_delta != first.is_delta):
            raise ValueError(
                "cannot fuse heterogeneous compressed updates "
                f"({ct.codec}/v{ct.version} vs {first.codec}/v{first.version})")
    codec = get_codec(first.codec)._resolve_wire(first)
    if codec.maskable:
        raise ValueError(
            "masked (secure-aggregation) updates cannot ride the generic "
            "weighted sum — per-client float weights would break exact "
            "mask cancellation; use privacy.secagg.unmask_finalize")
    n_leaves = len(first.meta)
    if any(len(ct.arrays) != n_leaves for ct in cts):
        raise ValueError("compressed update leaf count mismatch")
    for ct in cts:
        codec.check_wire(ct)
    try:
        stacked = [[torch.stack([torch.as_tensor(ct.arrays[j][p]) for ct in cts])
                    for p in range(len(first.arrays[j]))]
                   for j in range(n_leaves)]
    except (RuntimeError, TypeError) as e:
        raise ValueError(
            f"compressed update block shapes differ across clients "
            f"({first.codec}); check that every peer uses the same codec "
            f"parameters (e.g. compression_topk_ratio): {e}") from None
    dev = stacked[0][0].device if stacked else None
    w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    with torch.no_grad():
        flat = [codec.weighted_sum_leaf(parts, w, dt, sh)
                if _is_float_meta(dt) else _raw_weighted_sum(parts[0], w)
                for parts, (dt, sh) in zip(stacked, first.meta)]
    return dict(zip(first.structure, flat))


class IdentityCodec(Codec):
    name = "identity"
    lossless = True

    def encode_leaf(self, x, key):
        return [x]

    def decode_leaf(self, parts, dt, shape):
        return parts[0]

    def encode_leaf_batch(self, x, keys):
        return [x]

    def decode_leaf_batch(self, parts, dt, shape):
        return parts[0]


class Bf16Codec(Codec):
    name = "bf16"

    def encode_leaf(self, x, key):
        return [x.to(torch.bfloat16)]

    def decode_leaf(self, parts, dt, shape):
        return parts[0].to(_dtype_from_str(dt))

    def encode_leaf_batch(self, x, keys):
        return [x.to(torch.bfloat16)]

    def decode_leaf_batch(self, parts, dt, shape):
        return parts[0].to(_dtype_from_str(dt))


class Int8Codec(Codec):
    """Per-leaf stochastic uniform int8 quantization (QSGD-style):
    scale = max|leaf| / 127 (as ``amax * f32(1/127)``, the reference's
    jitted rounding); q = ⌊x/scale + u⌋, u ~ U[0,1) from the threefry key —
    unbiased, per-element error within one step (= scale)."""

    name = "int8"

    def encode_leaf(self, x, key):
        q, scale = self._quantize_rows(
            x[None], threefry.uniform(key, (x.numel(),), x.device)[None])
        return [q[0], scale[0]]

    def decode_leaf(self, parts, dt, shape):
        q, scale = parts
        return (q.float() * scale).to(_dtype_from_str(dt))

    @staticmethod
    def _quantize_rows(x, u):
        """``[C, *shape]`` with its ``[C, size]`` uniform draws → ``[q, scale]``
        stacked: one scale a row, ``amax * f32(1/127)`` as the reference's
        jitted program rounds it, and a tensor / tensor division by it (a
        true division on every device)."""
        xf = x.float().reshape(x.shape[0], -1)
        amax = xf.abs().amax(1)
        scale = torch.where(amax > 0, amax * _F32_1_OVER_127, torch.ones_like(amax))
        q = torch.floor(xf / scale[:, None] + u)
        return [torch.clamp(q, -127.0, 127.0).to(torch.int8).reshape(x.shape), scale]

    def _encode_leaves(self, leaves, meta, key):
        # a whole tree as a chunk of one: one threefry hash draws every float
        # leaf's noise, the same bits as a draw a leaf under fold_in(key, i)
        if not leaves:
            return []
        rows = self.encode_batch([x[None] for x in leaves], meta,
                                 key.to(leaves[0].device)[None])
        return [[p[0] for p in parts] if _is_float_meta(dt) else [leaf]
                for parts, leaf, (dt, _) in zip(rows, leaves, meta)]

    def encode_batch(self, leaves, meta, keys):
        # one threefry hash draws the noise of every float leaf of the chunk
        ids = [i for i, (dt, _) in enumerate(meta) if _is_float_meta(dt)]
        sizes = [_numel(meta[i][1]) for i in ids]
        u = threefry.uniform_leaves(keys, ids, sizes) if ids else None
        out, off = [], 0
        for leaf, (dt, sh) in zip(leaves, meta):
            if not _is_float_meta(dt):
                out.append([leaf])
                continue
            n = _numel(sh)
            out.append(self._quantize_rows(leaf, u[:, off:off + n]))
            off += n
        return out

    def decode_leaf_batch(self, parts, dt, shape):
        q, scale = parts
        return (q.float() * scale.reshape((-1,) + (1,) * len(shape))).to(
            _dtype_from_str(dt))

    def weighted_rows(self, parts, w, dt, shape):
        # (w_c · s_c) folds the client's weight and its scale, as the fused sum
        q, scale = parts
        return q.float() * (w * scale).reshape((-1,) + (1,) * len(shape))

    def check_wire(self, ct):
        for parts, (dt, _) in zip(ct.arrays, ct.meta):
            if not _is_float_meta(dt) or len(parts) < 2:
                continue
            if _is_host(parts[1]) and not _all_finite(parts[1]):
                self._reject_nonfinite_wire("scale")

    def weighted_sum_leaf(self, stacked, w, dt, shape):
        # (w_i · s_i) folds the client's scale and its FedAvg weight, so
        # the int8 blocks reduce in one contraction
        q, scale = stacked  # [c, ...] int8, [c]
        return torch.einsum("c,c...->...", w * scale, q.float()).to(
            _dtype_from_str(dt))


class TopKCodec(Codec):
    """Per-leaf top-k by magnitude (DGC-style): ``ceil(ratio · size)``
    exact (value, index) pairs per leaf; the rest decodes to zero. Equal
    magnitudes are taken lowest index first, as ``jax.lax.top_k`` takes
    them (a stable sort; ``torch.topk`` promises no order), so the wire
    bytes match the reference's when many deltas are exactly zero."""

    name = "topk"
    broadcast_safe = False

    def __init__(self, ratio: float = 0.05):
        self.ratio = float(ratio)
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.ratio:g}"

    def _k(self, size: int) -> int:
        return max(1, int(np.ceil(self.ratio * size)))

    def encode_leaf(self, x, key):
        flat = x.float().reshape(-1)
        k = self._k(flat.numel())
        idx = torch.sort(-flat.abs(), stable=True).indices[:k]
        return [flat[idx], idx.to(torch.int32)]

    def decode_leaf(self, parts, dt, shape):
        v, idx = parts
        out = torch.zeros(_numel(shape), dtype=torch.float32, device=v.device)
        out[idx.long()] = v
        return out.reshape(shape).to(_dtype_from_str(dt))

    def weighted_sum_leaf(self, stacked, w, dt, shape):
        # one scatter-add of every client's kept pairs into a dense sum
        v, idx = stacked  # [c, k] each
        out = torch.zeros(_numel(shape), dtype=torch.float32, device=v.device)
        out.index_add_(0, idx.reshape(-1).long(), (w[:, None] * v).reshape(-1))
        return out.reshape(shape).to(_dtype_from_str(dt))

    def check_wire(self, ct):
        for parts, (dt, _) in zip(ct.arrays, ct.meta):
            if _is_float_meta(dt) and _is_host(parts[0]) and not _all_finite(parts[0]):
                self._reject_nonfinite_wire("top-k values")


class _Blockwise4BitCodec(Codec):
    """Shared 4-bit machinery: flatten → pad to a block multiple → per-block
    absmax scale → 4-bit codes packed two per uint8 (element ``2i`` of a
    block in the low nibble of byte ``i``). The wire per float leaf is
    ``[packed uint8 [n_blocks, block//2], scale f32 [n_blocks]]``."""

    DEFAULT_BLOCK = 128
    MAX_BLOCK = 1 << 20

    def __init__(self, block: int = DEFAULT_BLOCK):
        block = int(block)
        if block < 2 or block & (block - 1) or block > self.MAX_BLOCK:
            raise ValueError(
                f"{self.name} block size must be a power of two in "
                f"[2, {self.MAX_BLOCK}], got {block}")
        self.block = block

    def _resolve_wire(self, ct):
        # the packed part's last dim IS block/2
        for parts, (dt, _) in zip(ct.arrays, ct.meta):
            if _is_float_meta(dt) and len(parts) == 2:
                pshape = tuple(getattr(parts[0], "shape", ()) or ())
                if len(pshape) == 2 and 0 < pshape[1] <= self.MAX_BLOCK // 2:
                    cand = 2 * int(pshape[1])
                    if not cand & (cand - 1):
                        return get_codec(f"{self.name}@{cand}")
                break
        return self

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.block}"

    def _geometry(self, shape) -> Tuple[int, int]:
        size = _numel(shape)
        return size, -(-size // self.block)

    def _scale_from_amax(self, amax):
        raise NotImplementedError

    def _quantize(self, v, key):
        """Per-block-normalized values → int32 codes in [0, 15]."""
        raise NotImplementedError

    def _lookup(self, codes):
        """int32 codes in [0, 15] → pre-scale f32 values."""
        raise NotImplementedError

    def encode_leaf(self, x, key):
        size, n_blocks = self._geometry(tuple(x.shape))
        xf = x.float().reshape(-1)
        xf = torch.nn.functional.pad(xf, (0, n_blocks * self.block - size))
        xf = xf.reshape(n_blocks, self.block)
        amax = xf.abs().amax(1)
        scale = torch.where(amax > 0, self._scale_from_amax(amax),
                            torch.ones_like(amax))
        codes = self._quantize(xf / scale[:, None], key)
        packed = (codes[:, 0::2] | (codes[:, 1::2] << 4)).to(torch.uint8)
        return [packed, scale]

    @staticmethod
    def _unpack(packed):
        lo = (packed & 0xF).to(torch.int32)
        hi = (packed >> 4).to(torch.int32)
        return torch.stack([lo, hi], -1).reshape(
            packed.shape[:-1] + (2 * packed.shape[-1],))

    def decode_leaf(self, parts, dt, shape):
        packed, scale = parts
        size, _ = self._geometry(shape)
        vals = self._lookup(self._unpack(packed)) * scale[:, None]
        return vals.reshape(-1)[:size].reshape(shape).to(_dtype_from_str(dt))

    def weighted_sum_leaf(self, stacked, w, dt, shape):
        packed, scale = stacked  # [c, nb, block/2] uint8, [c, nb] f32
        vals = self._lookup(self._unpack(packed))  # [c, nb, block]
        out = torch.einsum("cb,cbk->bk", w[:, None] * scale, vals)
        size, _ = self._geometry(shape)
        return out.reshape(-1)[:size].reshape(shape).to(_dtype_from_str(dt))

    def check_wire(self, ct):
        # structure first (a truncated pack mis-frames every later block),
        # then the per-block scales
        for parts, (dt, sh) in zip(ct.arrays, ct.meta):
            if not _is_float_meta(dt):
                continue
            if len(parts) != 2:
                raise ValueError(
                    f"{self.name} wire leaf must carry [packed, scale] "
                    f"(got {len(parts)} parts)")
            packed, scale = parts
            size, n_blocks = self._geometry(sh)
            want = (n_blocks, self.block // 2)
            pshape = tuple(getattr(packed, "shape", ()))
            if pshape != want:
                raise ValueError(
                    f"{self.name} packed nibble shape {pshape} does not "
                    f"cover leaf {sh} at block={self.block} (expected "
                    f"{want}) — truncated or odd-length pack")
            pdt = getattr(packed, "dtype", None)
            if pdt is not None and pdt not in (torch.uint8, np.dtype(np.uint8)):
                raise ValueError(
                    f"{self.name} packed nibbles must be uint8, got {pdt}")
            if tuple(getattr(scale, "shape", ())) != (n_blocks,):
                raise ValueError(
                    f"{self.name} scale shape "
                    f"{tuple(getattr(scale, 'shape', ()))} does not match "
                    f"{n_blocks} blocks for leaf {sh}")
            if _is_host(scale) and not _all_finite(scale):
                self._reject_nonfinite_wire("block scale")


class Int4Codec(_Blockwise4BitCodec):
    """Blockwise stochastic uniform int4: scale = blockmax|x| / 7 (as
    ``amax * f32(1/7)``); q = ⌊x/scale + u⌋ clipped to [-7, 7], stored as
    q+8 ∈ [1, 15]."""

    name = "int4"

    def _scale_from_amax(self, amax):
        return amax * _F32_1_OVER_7

    def _quantize(self, v, key):
        q = torch.floor(v + threefry.uniform(key, v.shape, v.device))
        return (torch.clamp(q, -7.0, 7.0) + 8.0).to(torch.int32)

    def _lookup(self, codes):
        return codes.float() - 8.0


class Nf4Codec(_Blockwise4BitCodec):
    """Blockwise NF4: scale = blockmax|x|; codes index the 16-entry
    codebook by nearest codeword (deterministic)."""

    name = "nf4"

    def _scale_from_amax(self, amax):
        return amax

    def _quantize(self, v, key):
        mids = torch.from_numpy(_NF4_MIDPOINTS).to(v.device)
        # bucketize(right=False) counts the midpoints strictly below v
        return torch.bucketize(v, mids).to(torch.int32)

    def _lookup(self, codes):
        return torch.from_numpy(NF4_CODEBOOK).to(codes.device)[codes.long()]


_CODEC_CLASSES: Dict[str, type] = {
    IdentityCodec.name: IdentityCodec,
    Bf16Codec.name: Bf16Codec,
    Int8Codec.name: Int8Codec,
    TopKCodec.name: TopKCodec,
    Int4Codec.name: Int4Codec,
    Nf4Codec.name: Nf4Codec,
}

_INSTANCES: Dict[Tuple, Codec] = {}

_SECAGG_NAME = "secagg_int8"
MASKABLE_CODECS = (_SECAGG_NAME,)
# the federated-analytics sketch family: legal wire tags that come with
# ROADMAP A10.5
_SKETCH_NAMES = ("cms", "csk", "votevec", "bloom", "hist")


def _load_secagg_codec() -> type:
    """Register the maskable codec on first use (``privacy.secagg`` imports
    this module, so the import cannot run at import time)."""
    if _SECAGG_NAME not in _CODEC_CLASSES:
        from fedml_tpu_torch.privacy.secagg.codec import SecAggInt8Codec

        _CODEC_CLASSES[SecAggInt8Codec.name] = SecAggInt8Codec
    return _CODEC_CLASSES[_SECAGG_NAME]


def available_codecs() -> Tuple[str, ...]:
    # the masked codec and the sketch family are legal wire tags, loaded or
    # not, as in the reference
    return tuple(sorted(set(_CODEC_CLASSES) | {_SECAGG_NAME} | set(_SKETCH_NAMES)))


def register_codec(cls: type) -> type:
    """Register a third-party codec class (``cls.name`` becomes its tag)."""
    _CODEC_CLASSES[str(cls.name)] = cls
    return cls


def get_codec(name: str, args: Any = None) -> Optional[Codec]:
    """Resolve a codec by tag or spec; '' / 'none' / 'off' → None.

    A spec's parameter (``topk@0.05``, ``int4@64``) overrides ``args``
    (``compression_topk_ratio``, ``compression_block_size``). Instances are
    cached per (name, parameter)."""
    name = str(name or "").lower()
    if name in ("", "none", "off"):
        return None
    base, _, param = name.partition("@")
    if base == _SECAGG_NAME:
        cls = _load_secagg_codec()
        # a bare tag (wire validation, maskable checks) gets a default
        # instance; every real round negotiates explicit parameters
        clip, bound, mod_bits = cls.parse_param(param) if param else (0.1, 42, 8)
        cache_key: Tuple = (base, clip, bound, mod_bits)
        if cache_key not in _INSTANCES:
            _INSTANCES[cache_key] = cls(clip, bound, mod_bits)
        return _INSTANCES[cache_key]
    if base in _SKETCH_NAMES and base not in _CODEC_CLASSES:
        raise NotImplementedError(
            f"codec {base!r} comes with federated analytics (ROADMAP A10.5); "
            "the port has not ported it yet")
    if base not in _CODEC_CLASSES:
        raise ValueError(
            f"unknown compression codec {base!r}; "
            f"available: {', '.join(available_codecs())}")
    cls = _CODEC_CLASSES[base]
    if param and base not in (TopKCodec.name, Int4Codec.name, Nf4Codec.name):
        raise ValueError(f"codec {base!r} takes no parameter ({name!r})")
    if base in (Int4Codec.name, Nf4Codec.name):
        if param:
            try:
                block = int(param)
            except ValueError:
                raise ValueError(
                    f"malformed {base} block size in codec spec {name!r}"
                ) from None
        else:
            block = int(getattr(args, "compression_block_size",
                                _Blockwise4BitCodec.DEFAULT_BLOCK)
                        if args is not None else _Blockwise4BitCodec.DEFAULT_BLOCK)
        cache_key = (base, block)
        if cache_key not in _INSTANCES:
            _INSTANCES[cache_key] = cls(block)
        return _INSTANCES[cache_key]
    if base == TopKCodec.name:
        if param:
            try:
                ratio = float(param)
            except ValueError:
                raise ValueError(
                    f"malformed topk ratio in codec spec {name!r}") from None
        else:
            ratio = float(getattr(args, "compression_topk_ratio", 0.05)
                          if args is not None else 0.05)
        cache_key = (base, ratio)
        if cache_key not in _INSTANCES:
            _INSTANCES[cache_key] = TopKCodec(ratio)
        return _INSTANCES[cache_key]
    if (base,) not in _INSTANCES:
        _INSTANCES[(base,)] = cls()
    return _INSTANCES[(base,)]


def derive_key(seed: int, round_idx: int, client_id: int) -> threefry.Key:
    """Deterministic stochastic-rounding key for (run, round, client): the
    reference's ``fold_in`` chain, bit for bit."""
    key = threefry.key(int(seed) & 0x7FFFFFFF)
    key = threefry.fold_in(key, int(round_idx))
    return threefry.fold_in(key, int(client_id) & 0x7FFFFFFF)


def derive_key_data(seed: int, round_idx: int, client_id: int) -> np.ndarray:
    """Raw uint32 key data of :func:`derive_key`."""
    return threefry.key_data(derive_key(seed, round_idx, client_id))


def derive_key_data_batch(seed: int, round_idx: int,
                          client_ids: np.ndarray) -> np.ndarray:
    """:func:`derive_key_data` for a whole id array at once, ``[n, 2]``."""
    base = threefry.fold_in(threefry.key(int(seed) & 0x7FFFFFFF), int(round_idx))
    cids = torch.from_numpy(np.asarray(client_ids, np.int64).reshape(-1) & 0x7FFFFFFF)
    return threefry.fold_in_batch(base.expand(len(cids), 2), cids).numpy().astype(np.uint32)


__all__ = [
    "WIRE_VERSION", "WIRE_VERSION_MASKED", "MASKABLE_CODECS", "NF4_CODEBOOK", "Codec", "CompressedTree", "IdentityCodec",
    "Bf16Codec", "Int8Codec", "TopKCodec", "Int4Codec", "Nf4Codec",
    "available_codecs", "derive_key", "derive_key_data", "derive_key_data_batch",
    "fused_weighted_sum", "get_codec", "ordered_row_sum", "register_codec", "tree_delta",
    "tree_undelta",
]
