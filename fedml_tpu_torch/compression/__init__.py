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

# The parts of the reference's trust stack the port has not ported yet:
# the argument that switches each on → the ROADMAP item that brings it.
TRUST_STACK_ARGS = {
    "enable_fhe": "FHE aggregation (ROADMAP A13)",
}


def check_trust_stack(args: Any) -> None:
    """Raise if ``args`` switches on a part of the trust stack the port has
    not ported: a run must not silently go without it."""
    on = [k for k in TRUST_STACK_ARGS if args is not None and getattr(args, k, None)]
    if on:
        raise NotImplementedError("; ".join(
            f"{k}: {TRUST_STACK_ARGS[k]} is not ported yet" for k in on))


def requires_full_trees(codec=None, args: Any = None) -> bool:
    """True when a server-side hook needs every client's full model instead
    of the dequant-fused aggregate: a model attack, a list defense or
    central DP (the reference's answer). Norm-only defenses are exempt
    (their clip factors come off the compressed blocks), and so are the
    fused robust defenses when ``codec`` is dense and broadcast-safe.
    Contribution assessment also needs the client models; the engines ask
    for it beside this answer, as the reference's do. The parts still to
    port raise (:func:`check_trust_stack`)."""
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    check_trust_stack(args)
    dp = FedMLDifferentialPrivacy.get_instance()
    defender = FedMLDefender.get_instance()
    fused_capable = (codec is not None and getattr(codec, "broadcast_safe", False)
                     and not getattr(codec, "maskable", False))
    return (FedMLAttacker.get_instance().is_model_attack()
            or (defender.is_defense_enabled() and not defender.is_norm_only_defense()
                and not (defender.is_fused_defense() and fused_capable))
            or (dp.is_dp_enabled() and dp.is_global_dp_enabled()))


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
