"""Ring 2 — Byzantine-robust aggregation fused into the compressed domain;
counterpart of ``fedml_tpu/integrity/robust_agg.py``.

Coordinate-wise trimmed mean and median (Yin et al., ICML'18) as drop-in
alternatives to the weighted mean of ``compression.fused_weighted_sum``:
the stacked client blocks are dequantized one leaf at a time on their
device, sorted along the client axis, trimmed and averaged, so no decoded
per-client f32 tree is ever built — the peak is the stacked wire arrays
plus one leaf's decoded stack plus the aggregated tree.

The statistics are shift-equivariant (``median_i(g + d_i) = g +
median_i(d_i)``), so the statistic of the deltas plus the global equals
the reference defenses' statistic of the full client models, up to
quantization; and they are deliberately unweighted. The spec
(``agg_robust: trimmed_mean@0.1 | median``) rides the round-config header
like the codec spec.

Even cohorts: ``jnp.median`` takes the mean of the two middle values, and
``torch.median`` the lower one, so the median here is a sort and the two
middle ranks. The trim count is the reference's host rule
(:func:`trim_k`); the masked twin adds the reference's ``+1e-4`` in f32.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from fedml_tpu_torch.compression.codecs import (
    CompressedTree,
    _dtype_from_str,
    _is_float_meta,
    get_codec,
)
from fedml_tpu_torch.telemetry.profiling import wrap_program
from fedml_tpu_torch.utils.tree import Tree

__all__ = [
    "ROBUST_MODES",
    "fused_robust_sum",
    "masked_robust_leaf",
    "parse_robust_spec",
    "resolve_agg_robust",
    "robust_reduce_leaf",
    "robust_spec_str",
    "trim_k",
]

ROBUST_MODES = ("trimmed_mean", "median")


def parse_robust_spec(spec: Any) -> Optional[Tuple[str, float]]:
    """``'trimmed_mean@0.1' | 'trimmed_mean' | 'median' | '' → None``:
    ``(mode, per-side trim)``. Unknown modes and bad fractions raise
    ``ValueError`` — a misheard header must fail loudly."""
    spec = str(spec or "").strip().lower()
    if spec in ("", "none", "off"):
        return None
    base, _, param = spec.partition("@")
    if base not in ROBUST_MODES:
        raise ValueError(f"unknown agg_robust mode {base!r}; "
                         f"available: {', '.join(ROBUST_MODES)}")
    if base == "median":
        if param:
            raise ValueError(f"agg_robust median takes no parameter ({spec!r})")
        return ("median", 0.0)
    trim = 0.1
    if param:
        try:
            trim = float(param)
        except ValueError:
            raise ValueError(f"malformed trim fraction in agg_robust spec {spec!r}") from None
    if not 0.0 < trim < 0.5:
        raise ValueError(f"agg_robust trim fraction must be in (0, 0.5), got {trim}")
    return ("trimmed_mean", trim)


def robust_spec_str(mode: str, trim: float) -> str:
    """The negotiation-header form (inverse of :func:`parse_robust_spec`)."""
    return "median" if mode == "median" else f"trimmed_mean@{trim:g}"


def trim_k(n: int, trim: float) -> int:
    """Per-side trim count for an ``n``-client cohort — the rule of
    ``TrimmedMeanDefense``, so the fused path and the defense agree."""
    return min(int(float(trim) * int(n)), (int(n) - 1) // 2)


def _middle_mean(s: torch.Tensor, lo, hi) -> torch.Tensor:
    return (torch.index_select(s, 0, lo) + torch.index_select(s, 0, hi))[0] * 0.5


def robust_reduce_leaf(dec: torch.Tensor, mode: str, k: int) -> torch.Tensor:
    """The robust statistic over axis 0 of ``[C, ...]`` values: the median
    as the mean of the two middle ranks, or the mean of ranks ``k..C-k-1``."""
    s = torch.sort(dec, dim=0).values
    n = dec.shape[0]
    if mode == "median":
        return (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.mean(s[k:n - k], dim=0)


def masked_robust_leaf(dec: torch.Tensor, valid: torch.Tensor, mode: str,
                       trim: float) -> torch.Tensor:
    """The statistic over axis 0 with a validity mask: invalid rows sort to
    the end behind a big sentinel, and the trim count is computed over the
    valid count in f32 with the reference's ``+1e-4`` guard."""
    nv = valid.to(torch.int32).sum()
    vcol = valid.reshape((-1,) + (1,) * (dec.ndim - 1))
    s = torch.sort(torch.where(vcol, dec, torch.full_like(dec, 3.0e38)), dim=0).values
    if mode == "median":
        lo = ((nv - 1) // 2).reshape(1).long()
        hi = (nv // 2).reshape(1).long()
        return _middle_mean(s, lo, hi)
    k = torch.minimum((torch.tensor(trim, dtype=torch.float32, device=dec.device)
                       * nv.float() + 1e-4).to(torch.int32), (nv - 1) // 2)
    rank = torch.arange(dec.shape[0], device=dec.device).reshape(vcol.shape)
    keep = (rank >= k) & (rank < nv - k)
    denom = torch.clamp_min(nv - 2 * k, 1).float()
    return torch.sum(torch.where(keep, s, torch.zeros_like(s)), dim=0) / denom


def _decode_stacked(codec, parts: List[torch.Tensor], dt: str,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    """``[C, *shape]`` f32 decoded values of one leaf's stacked wire parts."""
    n = parts[0].shape[0]
    if codec.name == "int8":
        q, scale = parts
        return q.float() * scale.float().reshape((n,) + (1,) * len(shape))
    if codec.name in ("int4", "nf4"):
        packed, scale = parts  # [C, nb, block/2], [C, nb]
        vals = codec._lookup(codec._unpack(packed)) * scale.float()[..., None]
        size = int(torch.tensor(shape).prod()) if shape else 1
        return vals.reshape(n, -1)[:, :size].reshape((n,) + tuple(shape))
    return torch.stack([codec.decode_leaf([p[c] for p in parts], dt, shape).float()
                        for c in range(n)])


def fused_robust_sum(cts: Sequence[CompressedTree], mode: str, trim: float = 0.1,
                     mesh: Any = None) -> Tree:
    """The coordinate-wise robust statistic of ``decode(ct_i)`` over
    clients, leaf by leaf on the blocks' device: the robust twin of
    ``fused_weighted_sum``, with the same refusals (heterogeneous trees,
    leaf-count mismatch, non-finite host scales) plus masked and top-k
    updates. Bit-deterministic for the same stacked blocks."""
    if mesh is not None:
        raise NotImplementedError(
            "fused_robust_sum(mesh=...): the sharded robust reduction comes with "
            "the multi-GPU layer (ROADMAP A11)")
    if mode not in ROBUST_MODES:
        raise ValueError(f"unknown robust aggregation mode {mode!r}")
    if not cts:
        raise ValueError("empty compressed update list")
    first = cts[0]
    for ct in cts[1:]:
        if (ct.codec != first.codec or ct.version != first.version
                or ct.meta != first.meta or ct.is_delta != first.is_delta):
            raise ValueError(
                "cannot robust-fuse heterogeneous compressed updates "
                f"({ct.codec}/v{ct.version} vs {first.codec}/v{first.version})")
    codec = get_codec(first.codec)._resolve_wire(first)
    if getattr(codec, "maskable", False):
        raise ValueError(
            "masked (secure-aggregation) updates cannot ride robust aggregation — "
            "per-coordinate sorting needs per-client values, which the masks hide")
    if codec.name == "topk":
        raise ValueError(
            "agg_robust needs dense per-coordinate values; topk updates leave most "
            "coordinates implicit-zero, which would let a sparse poisoner dominate "
            "every coordinate it keeps — use int8/bf16/identity with robust "
            "aggregation")
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
        raise ValueError("compressed update block shapes differ across clients "
                         f"({first.codec}): {e}") from None
    k = trim_k(len(cts), trim) if mode == "trimmed_mean" else 0
    with torch.no_grad():
        out = _robust_agg_program(codec, first.meta, mode, k, stacked)
    return dict(zip(first.structure, out))


def _robust_agg_program(codec, meta, mode: str, k: int, stacked):
    """Per-leaf decode, sort and trim over every leaf."""
    out = []
    for parts, (dt, sh) in zip(stacked, meta):
        if _is_float_meta(dt):
            dec = _decode_stacked(codec, parts, dt, sh)
        else:
            dec = parts[0].float()
        out.append(robust_reduce_leaf(dec, mode, k).to(_dtype_from_str(dt)))
    return tuple(out)


# cataloged (telemetry.profiling) under the reference's name
_robust_agg_program = wrap_program("integrity/robust_agg", _robust_agg_program,
                                   static_argnums=(0, 1, 2, 3), multi_shape=True)


def resolve_agg_robust(args: Any, codec: Any = None) -> Optional[str]:
    """The run's robust-aggregation spec, normalized: an explicit
    ``agg_robust``, else an active fused-capable defense (trimmed mean /
    coordinate-wise median) when ``codec`` is dense and broadcast-safe, else
    None — one definition for every caller."""
    parsed = parse_robust_spec(getattr(args, "agg_robust", ""))
    if parsed is not None:
        return robust_spec_str(*parsed)
    if (codec is None or not getattr(codec, "broadcast_safe", False)
            or getattr(codec, "maskable", False)):
        return None
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    defender = FedMLDefender.get_instance()
    if defender.is_fused_defense():
        return defender.fused_agg_spec()
    return None
