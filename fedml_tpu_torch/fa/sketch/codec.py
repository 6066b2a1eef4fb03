"""Sketches as first-class compression codecs, the FA wire format —
counterpart of ``fedml_tpu/fa/sketch/codec.py``.

A client's sketch travels as a :class:`~fedml_tpu_torch.compression.codecs.
CompressedTree` under one of the tags registered here (``cms``, ``csk``,
``votevec``, ``bloom``, ``hist``), so an analytics round rides the training
stack unchanged: the dequant-fused weighted sum aggregates the integer
blocks, the tree's ``PartialSum``s carry them between tiers, SecAgg masks
them (the sketch leaves are plain f32 counter arrays), the journal keeps
them at wire size and the screen admits them in the compressed domain.

Wire form per leaf: ``[q int32, scale f32]`` with a power-of-two shared
scale, ``scale = 2^(⌈log2 max|x|⌉ − 23)``, computed from the f32 exponent
bits (``Tensor.view(torch.int32)``, no ``log2``/``exp2``). Integer counters
(and the dyadic cohort means a power-of-two fan-out produces) round-trip
bit for bit; non-dyadic values quantize to the nearest 2^-k step. For the
same leaves the wire bytes equal the reference's.

``check_wire`` is the hostile-geometry gate: a submission whose blocks
disagree with the negotiated sketch spec (wrong table shape, truncated
parts, a non-dyadic or non-finite scale, counters past 2^23, negative
counters in an unsigned family) raises ``ValueError`` before anything
aggregates it. As every codec check of the port, it reads host arrays
(numpy, or tensors on the CPU) only, so an in-process encode on the card
costs no sync.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression.codecs import (
    Codec,
    CompressedTree,
    _dtype_from_str,
    _is_float_meta,
    _is_host,
    ordered_row_sum,
    register_codec,
)

__all__ = [
    "BloomCodec",
    "CountMinCodec",
    "CountSketchCodec",
    "HistogramCodec",
    "SKETCH_CODEC_NAMES",
    "VoteVectorCodec",
    "sketch_spec_for_task",
]

# counters must stay exactly representable in f32 through fused sums
_COUNT_BOUND = float(1 << 23)


def _dyadic_scale(amax: torch.Tensor) -> torch.Tensor:
    """Smallest power-of-two scale that fits ``amax`` (any shape) in 23 bits,
    from the f32 exponent bits: ``exp2(ceil(log2 x))`` would lose the exact
    round trip to its last-ulp error."""
    a = torch.clamp_min(amax.float(), 1.0)
    bits = a.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127                      # floor(log2 a)
    pow_e = ((e + 127) << 23).view(torch.float32)
    e = e + (a > pow_e).to(torch.int32)                  # ceil(log2 a)
    return ((e + 104) << 23).view(torch.float32)         # 2^(e-23)


def _to_numpy(a: Any) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _dtype_name(a: Any) -> str:
    return str(a.dtype).replace("torch.", "")


def _bcast(v: torch.Tensor, shape) -> torch.Tensor:
    """A ``[C]`` per-row value broadcast over ``[C, *shape]``."""
    return v.reshape((-1,) + (1,) * len(shape))


class _SketchCodec(Codec):
    """Shared kernels for the sketch codec family.

    Subclasses fix ``name``, the unsigned/signed rule and the expected leaf
    geometry; the negotiation-header spec (``cms@1024/4``) carries every
    parameter a peer must match for the tables to merge cell for cell.
    """

    lossless = True   # exact on integer counters and dyadic means
    nonneg = True     # count-sketch overrides: its counters are signed

    def _expected_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    # -- per-leaf kernels --------------------------------------------------
    def encode_leaf(self, x, key):
        q, scale = self.encode_leaf_batch(x[None], None)
        return [q[0], scale[0]]

    def decode_leaf(self, parts, dt, shape):
        q, scale = parts
        return (q.float() * scale).to(_dtype_from_str(dt))

    # -- batched forms: one dyadic scale a row and leaf --------------------
    def encode_leaf_batch(self, x, keys):
        xf = x.float()
        scale = _dyadic_scale(xf.abs().reshape(xf.shape[0], -1).amax(1))
        q = torch.round(xf / _bcast(scale, xf.shape[1:])).to(torch.int32)
        return [q, scale]

    def decode_leaf_batch(self, parts, dt, shape):
        q, scale = parts
        return (q.float() * _bcast(scale, shape)).to(_dtype_from_str(dt))

    def weighted_rows(self, parts, w, dt, shape):
        # (w_c · s_c) folds the row's weight and its shared scale
        q, scale = parts
        return q.float() * _bcast(w * scale, shape)

    def weighted_sum_leaf(self, stacked, w, dt, shape):
        # the dequant fused into the reduction, summed in a fixed pairwise
        # order: the same f32 rounding on every device and in every run
        return ordered_row_sum(self.weighted_rows(stacked, w, dt, shape)).to(
            _dtype_from_str(dt))

    # -- hostile-wire gate -------------------------------------------------
    def check_wire(self, ct: CompressedTree) -> None:
        expected = self._expected_shape()
        if len(ct.arrays) != len(ct.meta):
            raise ValueError(
                f"{self.name} wire: {len(ct.arrays)} leaf blocks for "
                f"{len(ct.meta)} metadata entries — truncated payload")
        for parts, (dt, sh) in zip(ct.arrays, ct.meta):
            if not _is_float_meta(dt):
                continue
            if tuple(sh) != expected:
                raise ValueError(
                    f"{self.name} wire: leaf shape {tuple(sh)} does not "
                    f"match the negotiated sketch spec {self.spec!r} "
                    f"(expected {expected}) — refusing to merge a "
                    "foreign-geometry sketch")
            if len(parts) != 2:
                raise ValueError(
                    f"{self.name} wire: {len(parts)} block parts per leaf "
                    "(expected q + scale) — truncated payload")
            q, scale = parts
            q_host = _is_host(q)
            if q_host and tuple(q.shape) != expected:
                raise ValueError(
                    f"{self.name} wire: counter block shape "
                    f"{tuple(q.shape)} != {expected}")
            if q_host and _dtype_name(q) != "int32":
                raise ValueError(
                    f"{self.name} wire: counter block dtype {_dtype_name(q)} "
                    "(expected int32)")
            if _is_host(scale):
                s = _to_numpy(scale).astype(np.float64).reshape(-1)
                if not np.all(np.isfinite(s)):
                    self._reject_nonfinite_wire("scale")
                v = float(s[0]) if s.size else float("nan")
                if s.size != 1 or v <= 0.0 or np.frexp(v)[0] != 0.5:
                    raise ValueError(
                        f"{self.name} wire: scale {v:g} is not a "
                        "positive power of two — sketch counters must "
                        "ride the dyadic grid")
            if q_host:
                qn = _to_numpy(q)
                if np.abs(qn, dtype=np.int64).max(initial=0) > _COUNT_BOUND:
                    raise ValueError(
                        f"{self.name} wire: counter magnitude exceeds "
                        f"2^23 — not exactly representable in f32 sums")
                if self.nonneg and qn.min(initial=0) < 0:
                    raise ValueError(
                        f"{self.name} wire: negative counters in an "
                        "unsigned sketch family")

    def _resolve_wire(self, ct: CompressedTree) -> Codec:
        # tag-only callers (fused sums, screening) hold the default-parameter
        # instance; the wire's own leaf shape says which geometry framed it,
        # so check_wire checks the payload against ITS claimed geometry
        for dt, sh in ct.meta:
            if _is_float_meta(dt):
                eff = self._from_wire_shape(tuple(sh))
                if eff is not None:
                    return eff
                break
        return self

    def _from_wire_shape(self, shape) -> Optional[Codec]:
        return None


class _TableCodec(_SketchCodec):
    """(depth, width) counter-table families: cms / csk / votevec."""

    DEFAULT_WIDTH = 1024
    DEFAULT_DEPTH = 4
    _width_arg = "fa_sketch_width"
    _depth_arg = "fa_sketch_depth"

    def __init__(self, width: int = 0, depth: int = 0):
        self.width = int(width) or self.DEFAULT_WIDTH
        self.depth = int(depth) or self.DEFAULT_DEPTH
        if self.width < 2 or self.depth < 1:
            raise ValueError(
                f"bad {self.name} geometry width={width} depth={depth}")

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.width}/{self.depth}"

    @classmethod
    def parse_param(cls, param: str) -> Tuple[int, int]:
        try:
            w, _, d = param.partition("/")
            return int(w), int(d or cls.DEFAULT_DEPTH)
        except ValueError:
            raise ValueError(
                f"malformed {cls.name} spec parameter {param!r} "
                "(want width/depth)") from None

    @classmethod
    def default_param(cls, args: Any = None) -> Tuple[int, int]:
        def g(k, d):
            return int(getattr(args, k, d) or d) if args is not None else d

        return g(cls._width_arg, cls.DEFAULT_WIDTH), g(cls._depth_arg, cls.DEFAULT_DEPTH)

    def _expected_shape(self) -> Tuple[int, ...]:
        return (self.depth, self.width)

    def _from_wire_shape(self, shape):
        if len(shape) == 2 and shape != (self.depth, self.width):
            return type(self)(shape[1], shape[0])
        return None


@register_codec
class CountMinCodec(_TableCodec):
    name = "cms"


@register_codec
class CountSketchCodec(_TableCodec):
    name = "csk"
    nonneg = False  # signed counters by construction


@register_codec
class VoteVectorCodec(_TableCodec):
    name = "votevec"
    DEFAULT_WIDTH = 2048
    DEFAULT_DEPTH = 3
    _width_arg = "fa_vote_width"
    _depth_arg = "fa_vote_depth"


@register_codec
class BloomCodec(_SketchCodec):
    name = "bloom"
    DEFAULT_BITS = 4096
    DEFAULT_HASHES = 4

    def __init__(self, bits: int = 0, hashes: int = 0):
        self.bits = int(bits) or self.DEFAULT_BITS
        self.hashes = int(hashes) or self.DEFAULT_HASHES
        if self.bits < 8 or not (1 <= self.hashes <= 16):
            raise ValueError(
                f"bad bloom geometry bits={bits} hashes={hashes}")

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.bits}/{self.hashes}"

    @classmethod
    def parse_param(cls, param: str) -> Tuple[int, int]:
        try:
            b, _, h = param.partition("/")
            return int(b), int(h or cls.DEFAULT_HASHES)
        except ValueError:
            raise ValueError(
                f"malformed bloom spec parameter {param!r} "
                "(want bits/hashes)") from None

    @classmethod
    def default_param(cls, args: Any = None) -> Tuple[int, int]:
        def g(k, d):
            return int(getattr(args, k, d) or d) if args is not None else d

        return g("fa_bloom_bits", cls.DEFAULT_BITS), g("fa_bloom_hashes", cls.DEFAULT_HASHES)

    def _expected_shape(self) -> Tuple[int, ...]:
        return (self.bits,)

    def _from_wire_shape(self, shape):
        if len(shape) == 1 and shape != (self.bits,):
            return type(self)(shape[0], self.hashes)
        return None


@register_codec
class HistogramCodec(_SketchCodec):
    name = "hist"
    DEFAULT_BINS = 64
    DEFAULT_LO = 0.0
    DEFAULT_HI = 100.0

    def __init__(self, bins: int = 0, lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI):
        self.bins = int(bins) or self.DEFAULT_BINS
        self.lo = float(lo)
        self.hi = float(hi)
        if self.bins < 1 or not (self.hi > self.lo):
            raise ValueError(
                f"bad histogram geometry bins={bins} lo={lo} hi={hi}")

    @property
    def spec(self) -> str:
        return f"{self.name}@{self.bins}/{self.lo:g}/{self.hi:g}"

    @classmethod
    def parse_param(cls, param: str) -> Tuple[int, float, float]:
        try:
            fields = param.split("/")
            bins = int(fields[0])
            lo = float(fields[1]) if len(fields) > 1 else cls.DEFAULT_LO
            hi = float(fields[2]) if len(fields) > 2 else cls.DEFAULT_HI
            return bins, lo, hi
        except (ValueError, IndexError):
            raise ValueError(
                f"malformed hist spec parameter {param!r} "
                "(want bins/lo/hi)") from None

    @classmethod
    def default_param(cls, args: Any = None) -> Tuple[int, float, float]:
        if args is None:
            return cls.DEFAULT_BINS, cls.DEFAULT_LO, cls.DEFAULT_HI
        bins = int(getattr(args, "fa_hist_bins", cls.DEFAULT_BINS)
                   or cls.DEFAULT_BINS)
        lo = float(getattr(args, "fa_hist_lo", cls.DEFAULT_LO))
        hi = float(getattr(args, "fa_hist_hi", cls.DEFAULT_HI))
        return bins, lo, hi

    def _expected_shape(self) -> Tuple[int, ...]:
        return (self.bins,)

    def _from_wire_shape(self, shape):
        if len(shape) == 1 and shape != (self.bins,):
            return type(self)(shape[0], self.lo, self.hi)
        return None


SKETCH_CODEC_NAMES = (CountMinCodec.name, CountSketchCodec.name,
                      VoteVectorCodec.name, BloomCodec.name,
                      HistogramCodec.name)

# which sketch family answers which FA task (the round-config header
# advertises the full spec; this picks the default family per task)
_TASK_FAMILY = {
    "frequency_estimation": CountMinCodec.name,
    "heavy_hitter_triehh": VoteVectorCodec.name,
    "union": BloomCodec.name,
    "intersection": BloomCodec.name,
    "cardinality": BloomCodec.name,
    "histogram": HistogramCodec.name,
    "k_percentile_element": HistogramCodec.name,
}


def sketch_spec_for_task(task: str, args: Any = None) -> Optional[str]:
    """The negotiation-header sketch spec for an FA task (None when the task
    has no sketch form: ``avg`` stays a scalar pair)."""
    from fedml_tpu_torch.compression.codecs import _CODEC_CLASSES

    family = _TASK_FAMILY.get((task or "").strip().lower())
    if family is None:
        return None
    cls = _CODEC_CLASSES[family]
    return cls(*cls.default_param(args)).spec
