"""SecAgg session state machines, the protocol minus the transport —
counterpart of ``fedml_tpu/privacy/secagg/protocol.py``.

The cross-silo managers own the message flow; these sessions own each
round's mask state, the reveal bookkeeping and every privacy guard:

- the **key advertisement** rides the client's status messages (one X25519
  public key a process, 32 bytes);
- the **round header** rides the broadcast (roster, key directory, codec
  spec): no extra round trip on the happy path;
- **dropout recovery** rides the quorum close: the server asks each
  survivor for the pair seeds it shared with the evicted peers (one extra
  round trip a wave), never anything that would unmask a received upload.

The client's guards (it is the last line of defence against a lying
server): it reveals seeds with evicted peers only, never for itself; the
evicted set of a round is bounded by what the quorum could lose
(``roster − quorum``, and at least two survivors); one reveal per (round,
peer), ever. Malformed headers, keys, uploads and reveals raise
``ValueError`` (the server drops and counts them). Threat model: an
honest-but-curious server and honest clients (``docs/privacy.md``).

The ``secagg/*`` counters go to the port's metrics registry; the protocol
events and phase markers are logged (their flight-recorder records and
the doctor's secagg section come with the run-health slice, ROADMAP A12b).
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.compression.codecs import _tree_meta, get_codec
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.privacy.secagg import masking
from fedml_tpu_torch.privacy.secagg.codec import (
    SecAggInt8Codec,
    masked_encode,
    unmask_finalize,
)
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.tree import Tree, tree_flatten

logger = logging.getLogger(__name__)

__all__ = [
    "SecAggClientSession",
    "SecAggMessage",
    "SecAggServerSession",
    "secagg_enabled",
]


class SecAggMessage(MyMessage):
    """Protocol extensions riding the standard cross-silo flows."""

    # server → survivors: the round closed on quorum; reveal the pair seeds
    # shared with the evicted peers
    MSG_TYPE_S2C_SECAGG_RECOVER = "MSG_TYPE_S2C_SECAGG_RECOVER"
    # survivor → server: {evicted_rank: per-round pair seed}
    MSG_TYPE_C2S_SECAGG_REVEAL = "MSG_TYPE_C2S_SECAGG_REVEAL"

    MSG_ARG_KEY_SECAGG = "secagg"            # round header on broadcasts
    MSG_ARG_KEY_SECAGG_PK = "secagg_pk"      # key advert on status messages
    MSG_ARG_KEY_SECAGG_EVICTED = "secagg_evicted"
    MSG_ARG_KEY_SECAGG_REVEAL = "secagg_reveal"


def secagg_enabled(args: Any) -> bool:
    """``secagg: int8`` (the only masked domain) turns it on; an unknown
    mode raises, as in the reference."""
    mode = str(getattr(args, "secagg", "") or "").lower()
    if mode in ("", "0", "false", "none", "off"):
        return False
    if mode not in ("int8", "1", "true"):
        raise ValueError(f"unknown secagg mode {mode!r} (supported: int8)")
    return True


def _counter(name: str, **labels):
    return get_registry().counter(name, labels=labels or None)


def record_phase(phase: str, round_idx: int, **fields) -> None:
    """A phase marker of a masked round: no phase ever materializes an
    individual client's unmasked delta on the server."""
    _counter("secagg/phases", phase=phase).inc()
    logger.info("secagg phase %s round %d (masked, no individual plaintext) %s",
                phase, int(round_idx), fields)


def _validate_pk(pk: Any) -> bytes:
    if not isinstance(pk, (bytes, bytearray)) or len(pk) != 32:
        raise ValueError(
            f"secagg public key must be 32 bytes, got "
            f"{type(pk).__name__}[{len(pk) if hasattr(pk, '__len__') else '?'}]")
    return bytes(pk)


def _codec_from_spec(spec: str) -> SecAggInt8Codec:
    codec = get_codec(spec)
    if not isinstance(codec, SecAggInt8Codec):
        raise ValueError(f"not a secagg codec spec: {spec!r}")
    return codec


def _meta_of(tree: Tree):
    return _tree_meta(tree_flatten(tree)[0])


class SecAggClientSession:
    """One client's masking state across the run: the keys persist; the
    mask and reveal state is per round."""

    def __init__(self, rank: int, args: Any):
        from fedml_tpu_torch.privacy.secagg.keys import kx_agree, kx_keygen
        from fedml_tpu_torch.resilience import ResilienceConfig

        self.rank = int(rank)
        self._kx_agree = kx_agree
        self.sk, self.pk = kx_keygen()
        self._secret_cache: Dict[Tuple[int, bytes], int] = {}
        self.quorum_frac = ResilienceConfig(args).round_quorum
        self.round_idx: Optional[int] = None
        self.roster: List[int] = []
        self.codec: Optional[SecAggInt8Codec] = None
        self._peer_seeds: Dict[int, int] = {}
        self._residual: Optional[Tree] = None
        self._revealed: Dict[int, set] = {}  # round -> peers revealed

    @classmethod
    def from_args(cls, rank: int, args: Any) -> Optional["SecAggClientSession"]:
        return cls(rank, args) if secagg_enabled(args) else None

    # -- round setup ------------------------------------------------------------
    def begin_round(self, header: Any, round_idx: int) -> None:
        """Apply the broadcast's secagg header; a malformed one raises
        ``ValueError`` (a client never trains against a roster it could not
        parse)."""
        if not isinstance(header, dict):
            raise ValueError("malformed secagg header (not a dict)")
        try:
            roster = [int(c) for c in header["roster"]]
            pks = {int(c): _validate_pk(pk) for c, pk in dict(header["pks"]).items()}
            spec = str(header["spec"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed secagg header: {e}") from None
        if self.rank not in roster:
            raise ValueError(f"secagg header roster {roster} does not include this "
                             f"client (rank {self.rank})")
        if len(set(roster)) != len(roster):
            raise ValueError("secagg header roster has duplicates")
        codec = _codec_from_spec(spec)
        if codec.bound != masking.client_bound(len(roster), codec.mod_bits):
            raise ValueError(f"secagg spec bound {codec.bound} does not match a "
                             f"{len(roster)}-client roster")
        self.round_idx = int(round_idx)
        self.roster = roster
        self.codec = codec
        self._peer_seeds = {}
        for j in roster:
            if j == self.rank:
                continue
            if j not in pks:
                raise ValueError(f"secagg header missing pk for peer {j}")
            ck = (j, pks[j])
            if ck not in self._secret_cache:
                self._secret_cache[ck] = self._kx_agree(self.sk, pks[j])
            self._peer_seeds[j] = masking.pair_round_seed(self._secret_cache[ck],
                                                          self.round_idx)
        for r in [r for r in self._revealed if r < self.round_idx - 4]:
            del self._revealed[r]

    @property
    def active(self) -> bool:
        return self.codec is not None

    # -- upload path --------------------------------------------------------------
    def encode_update(self, delta: Tree, key):
        """Mask and encode one round's delta (reference layout); the error
        feedback residual lives here."""
        net_mask = masking.net_mask_leaves(self.rank, self._peer_seeds, _meta_of(delta),
                                           self.codec.mod_bits)
        sa = {"round": int(self.round_idx), "rank": self.rank, "roster": list(self.roster)}
        ct, self._residual = masked_encode(delta, net_mask, self.codec, key,
                                           residual=self._residual, sa=sa)
        _counter("secagg/masked_uploads").inc()
        return ct

    def reset_identity(self) -> None:
        """Rejoin or a round gap: drop the residual, so no pre-gap
        quantization error leaks into the new identity."""
        self._residual = None

    # -- dropout recovery -----------------------------------------------------------
    def reveal_for(self, evicted: Sequence[Any], round_idx: Any) -> Optional[Dict[int, int]]:
        """The pair seeds shared with ``evicted``, or None when the request
        fails a privacy guard (counted and logged: an honest server never
        sees a refusal)."""
        from fedml_tpu_torch.resilience import quorum_size

        refuse = _counter("secagg/reveal_refusals")
        try:
            evicted = sorted({int(e) for e in evicted})
            round_idx = int(round_idx)
        except (TypeError, ValueError):
            refuse.inc()
            logger.error("secagg: refusing malformed reveal request")
            return None
        if round_idx != self.round_idx or not self.roster:
            refuse.inc()
            logger.error("secagg: refusing reveal for round %s (client is at %s)",
                         round_idx, self.round_idx)
            return None
        if self.rank in evicted:
            # half of this client's own mask, while the server may hold its upload
            refuse.inc()
            logger.error("secagg: refusing reveal request naming THIS client as evicted")
            return None
        if not set(evicted) <= set(self.roster):
            refuse.inc()
            logger.error("secagg: refusing reveal for peers outside the round roster")
            return None
        already = self._revealed.setdefault(self.round_idx, set())
        # the tighter of the quorum (a round that lost more could never have
        # closed) and the 2-survivor privacy floor
        max_evictable = len(self.roster) - max(2, quorum_size(len(self.roster),
                                                              self.quorum_frac))
        if len(already | set(evicted)) > max_evictable:
            refuse.inc()
            logger.error("secagg: refusing reveal — %d claimed dropouts exceed the "
                         "quorum/privacy-compatible maximum %d",
                         len(already | set(evicted)), max_evictable)
            return None
        out = {j: self._peer_seeds[j] for j in evicted if j in self._peer_seeds}
        already.update(out)
        _counter("secagg/seeds_revealed").inc(len(out))
        return out


class SecAggServerSession:
    """The server's roster and reveal bookkeeping and the unmask. It holds
    no mask seed of its own: it learns exactly the revealed (survivor,
    evicted) pair seeds, applies them to the masked sum and materializes
    only the (optionally noised) aggregate."""

    def __init__(self, args: Any, client_num: int):
        self.client_num = int(client_num)
        self.clip = float(getattr(args, "secagg_clip", 0.1))
        self.mod_bits = int(getattr(args, "secagg_mod_bits", 8))
        self.recovery_rounds = int(getattr(args, "secagg_recovery_rounds",
                                           getattr(args, "round_deadline_extensions", 3)))
        self.pks: Dict[int, bytes] = {}
        self._lock = threading.Lock()
        self.round_idx: Optional[int] = None
        self.roster: List[int] = []
        self.codec: Optional[SecAggInt8Codec] = None
        self.recovering = False
        self.survivors: List[int] = []
        self.evicted: List[int] = []
        self.reveals: Dict[int, Dict[int, int]] = {}
        self.recovery_waves = 0

    @classmethod
    def from_args(cls, args: Any, client_num: int) -> Optional["SecAggServerSession"]:
        return cls(args, client_num) if secagg_enabled(args) else None

    # -- key advertisement ----------------------------------------------------------
    def note_pk(self, client_id: int, pk: Any) -> None:
        """Store a client's advertised key; a changed key is a restarted
        client, and its next roster uses the new one."""
        self.pks[int(client_id)] = _validate_pk(pk)

    # -- round lifecycle ----------------------------------------------------------------
    def begin_round(self, round_idx: int, cohort: Sequence[int]) -> dict:
        """Open a masked round; returns the broadcast header."""
        cohort = [int(c) for c in cohort]
        missing = [c for c in cohort if c not in self.pks]
        if missing:
            raise RuntimeError(f"secagg round {round_idx} cannot open: no key "
                               f"advertisement from clients {missing}")
        bound = masking.client_bound(len(cohort), self.mod_bits)
        spec = f"{SecAggInt8Codec.name}@{self.clip:g}/{bound}/{self.mod_bits}"
        with self._lock:
            self.round_idx = int(round_idx)
            self.roster = cohort
            self.codec = get_codec(spec)
            self.recovering = False
            self.survivors = []
            self.evicted = []
            self.reveals = {}
            self.recovery_waves = 0
        _counter("secagg/rounds").inc()
        record_phase("collect", round_idx, roster=cohort)
        return {"v": 1, "spec": spec, "roster": cohort,
                "pks": {int(c): self.pks[c] for c in cohort}, "round": int(round_idx)}

    def validate_upload(self, sender: int, ct: Any) -> None:
        """Reject a masked upload whose metadata lies (wrong codec, foreign
        round, spoofed rank, roster mismatch) with ``ValueError``."""
        from fedml_tpu_torch.compression import CompressedTree

        if not isinstance(ct, CompressedTree) or ct.codec != SecAggInt8Codec.name:
            raise ValueError(f"secagg round expected a masked upload, got "
                             f"{type(ct).__name__}")
        sa = ct.sa
        if not isinstance(sa, dict):
            raise ValueError("masked upload missing its sa header")
        try:
            rank = int(sa["rank"])
            rnd = int(sa["round"])
            roster = [int(c) for c in sa["roster"]]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed masked upload header: {e}") from None
        if rank != int(sender):
            raise ValueError(f"masked upload claims rank {rank} but came from {sender}")
        if rnd != self.round_idx or roster != self.roster:
            raise ValueError(f"masked upload for round {rnd}/roster {roster} does not "
                             f"match the open round {self.round_idx}/{self.roster}")

    # -- dropout recovery -------------------------------------------------------------
    def begin_recovery(self, survivors: Sequence[int], evicted: Sequence[int]) -> List[int]:
        """Start (or extend) recovery; returns the survivors to ask."""
        with self._lock:
            if not self.recovering:
                self.recovering = True
                self.survivors = [int(s) for s in survivors]
                self.evicted = sorted(int(e) for e in evicted)
                self.reveals = {}
            else:
                newly = sorted(set(int(e) for e in evicted) - set(self.evicted))
                self.evicted = sorted(set(self.evicted) | set(int(e) for e in evicted))
                self.survivors = [s for s in self.survivors if s not in self.evicted]
                for s in list(self.reveals):
                    if s in self.evicted:
                        del self.reveals[s]
                logger.warning("secagg recovery extended to evicted=%s (+%s)",
                               self.evicted, newly)
            self.recovery_waves += 1
            _counter("secagg/recoveries").inc()
            record_phase("recover", self.round_idx if self.round_idx is not None else -1,
                         wave=self.recovery_waves, evicted=self.evicted,
                         survivors=list(self.survivors))
            return list(self.survivors)

    def note_reveal(self, sender: int, payload: Any, round_idx: Any) -> bool:
        """Record one survivor's reveal; True once recovery is complete.
        A malformed payload raises ``ValueError``."""
        sender = int(sender)
        with self._lock:
            if not self.recovering or int(round_idx) != self.round_idx:
                raise ValueError(f"unexpected secagg reveal for round {round_idx} "
                                 f"(recovering={self.recovering} at {self.round_idx})")
            if sender not in self.survivors:
                raise ValueError(f"secagg reveal from non-survivor {sender}")
            if not isinstance(payload, dict):
                raise ValueError("secagg reveal payload must be a dict")
            try:
                seeds = {int(j): int(s) for j, s in payload.items()}
            except (TypeError, ValueError):
                raise ValueError("secagg reveal payload must map int→int") from None
            if not set(seeds) <= set(self.evicted):
                raise ValueError(f"secagg reveal covers non-evicted peers "
                                 f"{sorted(set(seeds) - set(self.evicted))}")
            self.reveals.setdefault(sender, {}).update(seeds)
            return self._complete_locked()

    def _complete_locked(self) -> bool:
        need = set(self.evicted)
        return all(need <= set(self.reveals.get(s, {})) for s in self.survivors)

    def recovery_complete(self) -> bool:
        with self._lock:
            return self.recovering and self._complete_locked()

    def pending_reveals(self) -> List[int]:
        with self._lock:
            need = set(self.evicted)
            return [s for s in self.survivors if not need <= set(self.reveals.get(s, {}))]

    def recovery_adjustment(self, meta) -> Optional[List[np.ndarray]]:
        with self._lock:
            if not self.evicted:
                return None
            pairs = [(s, j, self.reveals[s][j]) for s in self.survivors for j in self.evicted]
        return masking.recovery_adjustment(pairs, meta, self.mod_bits)

    # -- the unmask ------------------------------------------------------------------------
    def aggregate(self, cts: Sequence[Any], base: Tree) -> Tree:
        """Unmask the survivors' sum into the new global model (reference
        layout, with central DP's noise when it is on). ``cts`` come in any
        order: ``sa.rank`` orders them."""
        ordered = sorted(cts, key=lambda ct: int(ct.sa["rank"]))
        ranks = [int(ct.sa["rank"]) for ct in ordered]
        with self._lock:
            survivors = list(self.survivors) if self.recovering else list(self.roster)
        if ranks != sorted(survivors):
            raise ValueError(f"masked uploads {ranks} do not match the survivor set "
                             f"{sorted(survivors)}")
        recovery = self.recovery_adjustment(ordered[0].meta)
        dp_sigma, dp_key = self._dp_noise_params()
        out = unmask_finalize(ordered, base, self.codec, recovery=recovery,
                              dp_sigma=dp_sigma, dp_key_data=dp_key)
        record_phase("unmask", self.round_idx if self.round_idx is not None else -1,
                     survivors=ranks, recovered=len(self.evicted), dp_noised=dp_sigma > 0)
        if self.evicted:
            logger.warning("secagg round %s recovered: evicted %s, %d seeds revealed",
                           self.round_idx, self.evicted,
                           sum(len(v) for v in self.reveals.values()))
        return out

    def _dp_noise_params(self) -> Tuple[float, Optional[np.ndarray]]:
        """Central DP's noise, drawn in the unmask: σ of the configured
        Gaussian mechanism, the key from the accounted release chain (one
        release a round, like ``add_global_noise``)."""
        from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
            FedMLDifferentialPrivacy,
        )

        dp = FedMLDifferentialPrivacy.get_instance()
        if not (dp.is_dp_enabled() and dp.is_global_dp_enabled()):
            return 0.0, None
        sigma = getattr(getattr(dp.frame, "mechanism", None), "sigma", None)
        if sigma is None:
            raise ValueError("secagg in-program central DP supports the gaussian "
                             "mechanism only (laplace has no in-program path)")
        _counter("secagg/dp_noise_rounds").inc()
        return float(sigma), dp.take_key_data(1)[0]
