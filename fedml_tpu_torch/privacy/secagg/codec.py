"""The maskable int8-block codec and the unmask — counterpart of
``fedml_tpu/privacy/secagg/codec.py``, as PyTorch ops on the tensors' own
device.

Client side (:func:`masked_encode`): error feedback, clipping, shared-scale
stochastic quantization and the mask add run on the device, and what comes
back is already masked: no unmasked quantized update exists on the host.
The wire carries one mask-domain word per element (uint8 at ``mod_bits`` 8,
uint16 at 16, two nibbles a byte at 4) and no per-leaf scale: the scale is
``clip / bound``, shared by the cohort and named in the codec spec.

Server side (:func:`unmask_finalize`): the masked words are summed mod
``2^k`` (the masks cancel inside the sum), the dropout adjustment is
subtracted, the residue is re-centred, scaled to the cohort mean and added
to the broadcast base, and with central DP the seeded Gaussian noise is
added on the device before anything reaches the host.
:func:`last_finalize_trace` records where the pre-noise aggregate lived.

The arithmetic is the reference's bit for bit. The mod-``2^k`` words are
summed in int32 and masked with ``2^k - 1`` (exact for cohorts up to 255;
CUDA has few uint16 kernels): a uint16 word crosses to and from the
device as an int16 bit pattern. Inside the reference's jitted encode the
scale is a constant, and XLA turns ``x / scale`` into ``x * f32(1/scale)``
at every optimization level, so the port multiplies by that reciprocal
(``test_masked_encode_scale_is_the_jitted_rounding``). The stochastic
rounding draws ``uniform(fold_in(key, i))`` from the threefry twin, bit for
bit; the DP noise is the twin's ``normal``, within 2e-5·σ of the
reference's draw.

Trees here are in the reference's layout and leaf order
(``models/convert.to_reference_layout``): masks, uniform draws and noise
are sliced per leaf in that order and shape, so a port silo's masks cancel
against a JAX silo's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.compression.codecs import (
    WIRE_VERSION_MASKED,
    Codec,
    CompressedTree,
    _is_float_meta,
    _numel,
    _tree_meta,
)
from fedml_tpu_torch.privacy.secagg.masking import MOD_BITS_CHOICES
from fedml_tpu_torch.telemetry.profiling import wrap_program
from fedml_tpu_torch.utils.tree import Tree, tree_flatten

__all__ = [
    "SecAggInt8Codec",
    "WIRE_VERSION_MASKED",
    "last_finalize_trace",
    "masked_encode",
    "unmask_finalize",
]

# where the last unmask kept its pre-noise aggregate, and whether the noise
# was added there: the acceptance tests read it
_FINALIZE_TRACE: Dict[str, Any] = {"device": None, "pre_noise_on_device": None,
                                   "noised_in_program": None}


def last_finalize_trace() -> dict:
    return dict(_FINALIZE_TRACE)


class SecAggInt8Codec(Codec):
    """Masked int8-block codec: a legal wire tag, never a general codec.
    Encoding or decoding one tree, decoding one leaf and the generic
    weighted sum all raise — a masked tree resolves only in aggregate
    (:func:`unmask_finalize`), and per-client weights would break the
    cancellation."""

    name = "secagg_int8"
    lossless = False
    broadcast_safe = False  # upload-only, like topk
    maskable = True

    def __init__(self, clip: float = 0.1, bound: int = 42, mod_bits: int = 8):
        self.clip = float(clip)
        self.bound = int(bound)
        self.mod_bits = int(mod_bits)
        if not self.clip > 0:
            raise ValueError(f"secagg clip must be > 0, got {clip}")
        if self.mod_bits not in MOD_BITS_CHOICES:
            raise ValueError(f"secagg mod_bits must be one of {MOD_BITS_CHOICES}, "
                             f"got {mod_bits}")
        if not 1 <= self.bound <= (1 << (self.mod_bits - 1)) - 1:
            raise ValueError(f"secagg bound {bound} not representable mod "
                             f"2^{self.mod_bits}")

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.clip:g}/{self.bound}/{self.mod_bits}"

    @property
    def scale(self) -> float:
        return self.clip / float(self.bound)

    @classmethod
    def parse_param(cls, param: str) -> Tuple[float, int, int]:
        """``clip/bound/mod_bits`` — the ``@`` suffix of the spec."""
        parts = str(param).split("/")
        if len(parts) != 3:
            raise ValueError(f"malformed secagg_int8 spec param {param!r} "
                             "(want clip/bound/mod_bits)")
        try:
            return float(parts[0]), int(parts[1]), int(parts[2])
        except ValueError:
            raise ValueError(f"malformed secagg_int8 spec param {param!r}") from None

    # -- privacy guards: individual masked trees never decode -----------------
    def encode(self, tree, key=None, is_delta: bool = False, residual=None):
        raise ValueError("secagg_int8 updates are masked: use privacy.secagg."
                         "masked_encode (plain Codec.encode has no mask input)")

    def decode(self, ct: CompressedTree):
        raise ValueError("refusing to decode an individual masked update — masked "
                         "trees only resolve in aggregate (privacy.secagg."
                         "unmask_finalize)")

    def encode_leaf(self, x, key):
        raise ValueError("secagg_int8 has no per-leaf encode")

    def decode_leaf(self, parts, dt, shape):
        raise ValueError("refusing to decode an individual masked leaf")

    def weighted_sum_leaf(self, stacked, w, dt, shape):
        raise ValueError("masked updates cannot ride the generic weighted sum — "
                         "per-client weights would break mask cancellation")


def _check_float_meta(meta) -> None:
    bad = [dt for dt, _ in meta if not _is_float_meta(dt)]
    if bad:
        raise ValueError(
            "secure aggregation supports float-leaf trees only; non-float leaves "
            f"({', '.join(sorted(set(bad)))}) would ride the wire unmasked")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _words_to_device(words: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """Host mask-domain words (uint8 or uint16, one array a leaf) → int32
    tensors on ``device`` in ``[0, 2^k)``, through one host-to-device copy."""
    words = [np.asarray(w) for w in words]
    if not words:
        return []
    dtype = words[0].dtype
    flat = np.concatenate([w.reshape(-1) for w in words]).astype(dtype, copy=False)
    t = torch.from_numpy(flat.view(np.int16) if dtype == np.uint16 else flat)
    t = t.to(device).to(torch.int32)
    if dtype == np.uint16:
        t = t & 0xFFFF
    out, off = [], 0
    for w in words:
        out.append(t[off:off + w.size].reshape(w.shape))
        off += w.size
    return out


def _pack_nibbles(y: torch.Tensor) -> torch.Tensor:
    """mod-16 words → flat packed uint8 ``[(size + 1) // 2]``: element ``2i``
    in the low nibble of byte ``i``, ``2i + 1`` in the high one."""
    flat = y.reshape(-1)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.reshape(-1, 2)
    return (pairs[:, 0] | (pairs[:, 1] << 4)).to(torch.uint8)


def _unpack_nibbles(packed: torch.Tensor, size: int) -> torch.Tensor:
    """flat packed uint8 ``[..., n]`` → int32 words ``[..., size]`` in [0, 16)."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], -1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))[..., :size]


def _to_wire_word(y: torch.Tensor, mod_bits: int) -> torch.Tensor:
    """int32 words in ``[0, 2^k)`` → the wire dtype (uint16 by way of its
    int16 bit pattern: CUDA casts int32 to int16, not to uint16)."""
    if mod_bits == 16:
        return (y - ((y >= 1 << 15).to(torch.int32) << 16)).to(torch.int16).view(torch.uint16)
    return y.to(torch.uint8)


def _from_wire_word(w: torch.Tensor) -> torch.Tensor:
    """Wire words → int32 in ``[0, 2^k)``."""
    if w.dtype == torch.uint16:
        return w.view(torch.int16).to(torch.int32) & 0xFFFF
    return w.to(torch.int32)


def masked_encode(delta: Tree, net_mask: Sequence[np.ndarray], codec: SecAggInt8Codec,
                  key: threefry.Key, residual: Optional[Tree] = None,
                  sa: Optional[dict] = None) -> Tuple[CompressedTree, Tree]:
    """Encode one client's delta (reference layout) into a masked wire tree.

    ``net_mask`` is the client's folded pairwise mask
    (:func:`masking.net_mask_leaves`) over the same meta as ``delta``.
    Returns ``(CompressedTree, new_residual)``; the residual (clip error
    plus quantization error, re-sent next round) is the caller's per-identity
    error-feedback state."""
    leaves, keys = tree_flatten(delta)
    meta = _tree_meta(leaves)
    _check_float_meta(meta)
    if len(net_mask) != len(leaves):
        raise ValueError(f"net mask has {len(net_mask)} leaves for a {len(leaves)}-leaf "
                         "tree")
    if residual is None:
        res_leaves = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                      for x in leaves]
    else:
        res_leaves = [residual[k] for k in keys]
    device = leaves[0].device if leaves else torch.device("cpu")
    masks = _words_to_device(net_mask, device)
    from fedml_tpu_torch.telemetry.spans import get_tracer

    with get_tracer().span("compress/encode", codec=codec.name,
                           n_leaves=len(leaves)), torch.no_grad():
        masked, new_res = _masked_encode_program(
            codec.clip, codec.bound, codec.mod_bits, meta, tuple(leaves),
            tuple(res_leaves), tuple(masks), key)
    raw_nbytes = sum(_numel(sh) * 4 for _, sh in meta)
    ct = CompressedTree(codec.name, WIRE_VERSION_MASKED, True, raw_nbytes, meta, keys,
                        [[y] for y in masked], sa=sa)
    return ct, dict(zip(keys, new_res))


def _masked_encode_program(clip: float, bound: int, mod_bits: int, meta,
                           leaves, res_leaves, masks, key):
    """Compensate, clip, stochastically round and mask every leaf:
    ``(masked wire words, new residuals)``."""
    scale = _f32(clip / float(bound))
    inv_scale = _f32(np.float32(1.0) / np.float32(scale))
    wmask = (1 << mod_bits) - 1
    masked, new_res = [], []
    for i, (x, r, m) in enumerate(zip(leaves, res_leaves, masks)):
        comp = x.float() + r.float()
        xc = torch.clamp(comp, -clip, clip)
        u = threefry.uniform(threefry.fold_in(key, i), xc.shape, x.device)
        q = torch.clamp(torch.floor(xc * inv_scale + u), -bound, bound)
        y = (q.to(torch.int32) + m) & wmask
        masked.append(_pack_nibbles(y) if mod_bits == 4
                      else _to_wire_word(y, mod_bits).contiguous())
        # everything the server will not see for this client: re-sent
        new_res.append(comp - q * scale)
    return tuple(masked), tuple(new_res)


# cataloged (telemetry.profiling) under the reference's name
_masked_encode_program = wrap_program("secagg/masked_encode", _masked_encode_program,
                                      static_argnums=(0, 1, 2, 3), multi_shape=True)


def unmask_finalize(cts: Sequence[CompressedTree], base: Tree, codec: SecAggInt8Codec,
                    recovery: Optional[Sequence[np.ndarray]] = None,
                    dp_sigma: float = 0.0, dp_key_data: Optional[np.ndarray] = None,
                    mesh: Any = None) -> Tree:
    """Fuse the survivors' masked trees into the new global model (in the
    reference's layout, on ``base``'s device).

    ``recovery`` is the dropout adjustment
    (:func:`masking.recovery_adjustment`); ``dp_sigma`` > 0 adds Gaussian
    noise keyed by ``dp_key_data`` to the aggregate on the device. Raises
    ``ValueError`` on heterogeneous or unmasked inputs. A ``mesh`` of more
    than one device (the per-shard unmask) comes with the multi-GPU layer,
    ROADMAP A11."""
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        raise NotImplementedError(
            "unmask_finalize(mesh=...): the per-shard unmask comes with the "
            "multi-GPU layer (ROADMAP A11)")
    if not cts:
        raise ValueError("empty masked update list")
    first = cts[0]
    for ct in cts:
        if (ct.codec != SecAggInt8Codec.name or ct.version != WIRE_VERSION_MASKED
                or ct.meta != first.meta or not ct.is_delta):
            raise ValueError("unmask_finalize needs homogeneous masked delta trees "
                             f"(got {ct.codec}/v{ct.version})")
    base_leaves, keys = tree_flatten(base)
    if len(base_leaves) != len(first.meta) or any(len(ct.arrays) != len(first.meta)
                                                  for ct in cts):
        raise ValueError("broadcast base does not match the masked trees")
    device = base_leaves[0].device if base_leaves else torch.device("cpu")
    try:
        stacked = [torch.stack([torch.as_tensor(ct.arrays[j][0]).to(device) for ct in cts])
                   for j in range(len(first.meta))]
    except (RuntimeError, TypeError, IndexError) as e:
        raise ValueError(f"masked block shapes differ across clients: {e}") from None
    mod_bits = codec.mod_bits
    if recovery is None:
        rec = [None] * len(first.meta)
    else:
        if len(recovery) != len(first.meta):
            raise ValueError("recovery adjustment leaf count mismatch")
        rec = _words_to_device(recovery, device)
    with_noise = float(dp_sigma) > 0.0
    if with_noise:
        if dp_key_data is None:
            dp_key_data = threefry.key_data(threefry.key(0))
        dp_key = torch.tensor([int(w) for w in np.asarray(dp_key_data).reshape(-1)[:2]],
                              dtype=torch.int64)
        sigma = _f32(dp_sigma)
    from fedml_tpu_torch.telemetry.spans import get_tracer

    n_div = torch.tensor(float(len(cts)), dtype=torch.float32, device=device)
    with get_tracer().span("compress/decode", codec=codec.name,
                           n_leaves=len(first.meta)), torch.no_grad():
        out = _unmask_program(
            codec.clip, codec.bound, mod_bits, first.meta, with_noise,
            tuple(stacked), tuple(rec), tuple(base_leaves), n_div,
            sigma if with_noise else 0.0, dp_key if with_noise else None)
    on_device = all(a.device == device for a in out)
    _FINALIZE_TRACE.update(device=str(device), pre_noise_on_device=bool(on_device),
                           noised_in_program=with_noise)
    return dict(zip(keys, out))


def _unmask_program(clip: float, bound: int, mod_bits: int, meta, with_noise: bool,
                    stacked, rec, base_leaves, n_div, sigma, dp_key):
    """Sum the masked words mod 2^mod_bits, take the recovery adjustment
    off, centre, rescale onto the base (plus the DP noise): the new leaves."""
    scale = _f32(clip / float(bound))
    half = 1 << (mod_bits - 1)
    wmask = (1 << mod_bits) - 1
    out = []
    for i, (ys, r, b, (dt, sh)) in enumerate(zip(stacked, rec, base_leaves, meta)):
        if mod_bits == 4:
            # unpack each client's nibbles, then exact mod-16 arithmetic
            # in int32 (a packed-byte sum would carry between nibbles)
            words = _unpack_nibbles(ys, _numel(sh)).sum(0)
            if r is not None:
                words = words - r.reshape(-1)
            s = (words & wmask).reshape(sh)
        else:
            s = _from_wire_word(ys).sum(0, dtype=torch.int32)
            if r is not None:
                s = s - r
            s = s & wmask
        c = s - ((s >= half).to(torch.int32) << mod_bits)
        agg = b.float() + c.float() * scale / n_div
        if with_noise:
            z = threefry.normal(threefry.fold_in(dp_key, i), agg.shape, agg.device)
            agg = agg + sigma * z
        out.append(agg.to(b.dtype))
    return tuple(out)


# cataloged (telemetry.profiling) under the reference's name
_unmask_program = wrap_program("secagg/unmask_finalize", _unmask_program,
                               static_argnums=(0, 1, 2, 3, 4), multi_shape=True)
