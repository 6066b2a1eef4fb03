"""Compressed update transport — counterpart of ``fedml_tpu/compression``.

Quick tour::

    from fedml_tpu_torch import compression

    codec = compression.get_codec("int8")          # None for ''/'none'
    ct = codec.encode(delta_tree, key=compression.derive_key(0, r, cid),
                      is_delta=True)
    tree = codec.decode(ct)

    ef = compression.ErrorFeedback(codec)          # per-client residual
    ct = ef.encode(delta_tree, key=...)

The codecs draw their noise from a bit-exact twin of JAX's threefry PRNG
(``threefry``), so for the same leaves and key the wire arrays equal the
reference's. The NF4 codebook is shared with the 4-bit weight format
(``ops/quant.QuantizedTensor4``).
"""
from typing import Any

from fedml_tpu_torch.compression.codecs import (
    NF4_CODEBOOK,
    WIRE_VERSION,
    Codec,
    CompressedTree,
    available_codecs,
    derive_key,
    derive_key_data,
    derive_key_data_batch,
    fused_weighted_sum,
    get_codec,
    register_codec,
    tree_delta,
    tree_undelta,
)
from fedml_tpu_torch.compression.error_feedback import ErrorFeedback

# The server-side trust stack of the reference (differential privacy, FHE,
# model attacks, defenses, integrity rings, robust aggregation, contribution
# assessment): the args that switch each part on, all ported with ROADMAP A10.2.
TRUST_STACK_ARGS = ("enable_dp", "enable_fhe", "enable_attack", "enable_defense",
                    "enable_contribution", "integrity", "integrity_screen",
                    "integrity_rollback", "agg_robust")


def check_trust_stack(args: Any) -> None:
    """Raise if ``args`` switches on any part of the trust stack: the port
    has none of it yet, and a run must not silently go without it."""
    on = [k for k in TRUST_STACK_ARGS if args is not None and getattr(args, k, None)]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: the trust stack (DP, FHE, attacks, defenses, "
            "integrity, robust aggregation, contribution assessment) comes "
            "with ROADMAP A10.2; the port has not ported it yet")


def requires_full_trees(codec=None, args: Any = None) -> bool:
    """True when a server-side hook needs every client's full model instead
    of the dequant-fused aggregate. In the reference that is the trust stack
    (FHE, model attacks, list defenses, central DP); the port has none of
    it, so a trust-stack argument raises (:func:`check_trust_stack`) and
    otherwise the fused path always serves."""
    check_trust_stack(args)
    return False


__all__ = [
    "NF4_CODEBOOK",
    "TRUST_STACK_ARGS",
    "WIRE_VERSION",
    "Codec",
    "CompressedTree",
    "ErrorFeedback",
    "available_codecs",
    "check_trust_stack",
    "derive_key",
    "derive_key_data",
    "derive_key_data_batch",
    "fused_weighted_sum",
    "get_codec",
    "register_codec",
    "requires_full_trees",
    "tree_delta",
    "tree_undelta",
]
