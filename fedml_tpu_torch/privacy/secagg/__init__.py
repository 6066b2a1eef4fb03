"""Dropout-robust secure aggregation over the int8 block domain —
counterpart of ``fedml_tpu/privacy/secagg``.

Quick tour::

    # client
    session = SecAggClientSession.from_args(rank, args)   # None when off
    pk = session.pk                                       # rides status msgs
    session.begin_round(header, round_idx)                # from the broadcast
    ct = session.encode_update(delta_tree, key)           # masked on the device
    seeds = session.reveal_for(evicted, round_idx)        # dropout recovery

    # server
    session = SecAggServerSession.from_args(args, client_num)
    header = session.begin_round(round_idx, cohort)       # rides the broadcast
    session.validate_upload(sender, ct)
    new_global = session.aggregate(cts, base)             # unmask (+ DP noise)

Masks cancel exactly in integer arithmetic (mod ``2^k``), so the aggregate
equals the never-masked sum bit for bit; the wire carries one mask-domain
word per element. Trees are in the reference's layout and leaf order. The
per-edge-cohort mode of the aggregation tree is ``hierarchy.py``
(``SecAggLeafCohort``, ``TreeRunner(secagg=True)``).
"""
from fedml_tpu_torch.privacy.secagg.codec import (
    WIRE_VERSION_MASKED,
    SecAggInt8Codec,
    last_finalize_trace,
    masked_encode,
    unmask_finalize,
)
from fedml_tpu_torch.privacy.secagg.masking import (
    client_bound,
    mask_leaves,
    net_mask_leaves,
    pair_round_seed,
    recovery_adjustment,
)
from fedml_tpu_torch.privacy.secagg.protocol import (
    SecAggClientSession,
    SecAggMessage,
    SecAggServerSession,
    secagg_enabled,
)

__all__ = [
    "SecAggClientSession",
    "SecAggInt8Codec",
    "SecAggMessage",
    "SecAggServerSession",
    "WIRE_VERSION_MASKED",
    "client_bound",
    "last_finalize_trace",
    "mask_leaves",
    "masked_encode",
    "net_mask_leaves",
    "pair_round_seed",
    "recovery_adjustment",
    "secagg_enabled",
    "unmask_finalize",
]
