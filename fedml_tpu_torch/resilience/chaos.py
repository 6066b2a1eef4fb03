"""Seeded deterministic fault injection at the comm boundary — counterpart
of ``fedml_tpu/resilience/chaos.py``.

Every recovery path is only trustworthy if its failure is reproducible, so
the injector never consults a wall-clock RNG: a probabilistic fault (drop,
duplicate, delay) hashes ``(seed, kind, rank, receiver, per-peer send
sequence)`` through the reference's ``policy._unit_hash`` (a seed replays
the reference's decisions bit for bit), and a windowed fault (kill a
client, partition ranks) triggers on the authoritative round number, not
on time.

Spec (``args.chaos``, a dict or a JSON string; ``args.chaos_seed``)::

    chaos:
      drop: 0.05            # P(drop) per sent message
      duplicate: 0.05       # P(send twice): dedup's job to absorb
      delay_ms: 20          # hold the send thread this long
      delay: 0.1            # P(delay) per sent message
      kill:                 # crash client 2 for rounds [2, 3)
        rank: 2
        round: 2
        revive_round: 3
      partition:            # or split arbitrary rank sets
        ranks: [1, 2]
        round: 1
        heal_round: 3
      corrupt_update:       # per-rank model corruption windows
        - rank: 2
          round: 1          # [round, until)
          mode: nan         # nan | scale
          factor: 50.0      # scale mode only
      kill_server:          # SIGKILL the server (needs durability: true)
        round: 2
        after_uploads: 1

Faults are injected on the sender's side (a deterministic sequence),
except the kill and partition windows, which also filter inbound delivery
so a dead peer's in-flight messages cannot leak through. The update
corruption family targets the model instead of the transport: in its
window the model payload a rank sends is mutated at the comm seam, after
the encode and before the wire. :func:`run_chaos_scenario` runs an
in-process cross-silo federation under a spec and returns one JSON-safe
summary (``python -m fedml_tpu_torch.cli chaos``).

The scheduler tier's chaos (``AgentKillWindow``, ``NodeDrain``) comes with
the scheduler (ROADMAP A13): asking for it raises.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression.codecs import CompressedTree, _is_float_meta
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.resilience.policy import _unit_hash
from fedml_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)


class ChaosSpec:
    def __init__(self, spec: Optional[Dict] = None, seed: int = 0):
        spec = dict(spec or {})
        self.seed = int(seed)
        self.drop = float(spec.get("drop", 0.0))
        self.duplicate = float(spec.get("duplicate", 0.0))
        self.delay_ms = float(spec.get("delay_ms", 0.0))
        self.delay = float(spec.get("delay", 1.0 if self.delay_ms else 0.0))
        # kill is sugar for a single-rank partition
        partitions: List[Dict] = []
        kill = spec.get("kill")
        if kill:
            partitions.append({
                "ranks": [int(kill["rank"])],
                "round": int(kill.get("round", 0)),
                "heal_round": int(kill.get("revive_round", kill.get("heal_round", 1 << 30))),
            })
        part = spec.get("partition")
        if part:
            partitions.append({
                "ranks": [int(r) for r in part.get("ranks", [])],
                "round": int(part.get("round", 0)),
                "heal_round": int(part.get("heal_round", 1 << 30)),
            })
        self.partitions = partitions
        corrupt = spec.get("corrupt_update") or []
        if isinstance(corrupt, dict):  # a dict is a single window
            corrupt = [corrupt]
        self.corrupt_updates = [
            CorruptUpdateWindow(rank=int(c["rank"]), round=int(c.get("round", 0)),
                                until=c.get("until"), mode=str(c.get("mode", "scale")),
                                factor=float(c.get("factor", 50.0)))
            for c in corrupt]

    @property
    def any_probabilistic(self) -> bool:
        return self.drop > 0 or self.duplicate > 0 or (self.delay > 0 and self.delay_ms > 0)

    @classmethod
    def parse(cls, raw: Any, seed: int = 0) -> Optional["ChaosSpec"]:
        if raw is None or raw == "" or raw is False:
            return None
        if isinstance(raw, str):
            raw = json.loads(raw)
        if not isinstance(raw, dict):
            raise ValueError(f"chaos spec must be a dict/JSON object, got "
                             f"{type(raw).__name__}")
        return cls(raw, seed=seed)


class CorruptUpdateWindow:
    """Corrupt rank ``rank``'s outbound model payloads for rounds ``[round,
    until)`` (one round by default): ``mode='nan'`` pokes NaN into the first
    float block or scale, ``mode='scale'`` multiplies every scale (or leaf)
    by ``factor``. ``tier`` targets a node's uplink inside an aggregation
    tree (``hierarchy.TreeRunner``); None is a flat federation rank at the
    comm seam.
    """

    __slots__ = ("rank", "round", "until", "mode", "factor", "tier")

    def __init__(self, rank: int, round: int, until: Optional[int] = None,
                 mode: str = "scale", factor: float = 50.0, tier: Optional[int] = None):
        if mode not in ("nan", "scale"):
            raise ValueError(f"corrupt_update mode must be nan|scale, got {mode!r}")
        self.rank = int(rank)
        self.round = int(round)
        self.until = int(until) if until is not None else self.round + 1
        self.mode = mode
        self.factor = float(factor)
        self.tier = int(tier) if tier is not None else None

    def active_at(self, rank: int, round_idx: Optional[int]) -> bool:
        return (round_idx is not None and self.rank == int(rank)
                and self.round <= int(round_idx) < self.until)


class NaNWindow(CorruptUpdateWindow):
    """A :class:`CorruptUpdateWindow` that ships NaN."""

    def __init__(self, rank: int, round: int, until: Optional[int] = None,
                 tier: Optional[int] = None):
        super().__init__(rank, round, until=until, mode="nan", tier=tier)


def _nan_first(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    if t.numel():
        t.reshape(-1)[0] = float("nan")
    return t


def _corrupt_plain(node: Any, mode: str, factor: float, state: Dict[str, bool]) -> Any:
    """The leaves of a nested dict/list tree in the reference's leaf order
    (dict keys sorted, as a pytree flattens them)."""
    if isinstance(node, dict):
        return {k: _corrupt_plain(node[k], mode, factor, state) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_corrupt_plain(v, mode, factor, state) for v in node)
    if isinstance(node, torch.Tensor) and node.is_floating_point():
        if mode == "nan" and not state["done"]:
            state["done"] = True
            return _nan_first(node)
        if mode == "scale":
            return node * float(np.float32(factor))
    return node


def corrupt_model_payload(payload: Any, mode: str, factor: float = 50.0) -> Any:
    """Deterministic payload corruption (a pure function of the payload, no
    RNG, so a seeded replay stays bit-identical).

    ``CompressedTree``: nan → the first float leaf's scale-like part becomes
    NaN (multi-part codecs) or its first element does (single-part); scale →
    every float part multiplies by ``factor``. A plain tree (the wire form's
    nested dict, or the port's flat dict): nan → the first element of the
    first float leaf in the reference's leaf order; scale → every float
    leaf multiplies. The result is a copy on the payload's own device (the
    reference returns host arrays: its wire decodes there)."""
    if isinstance(payload, CompressedTree):
        arrays = [[p.clone() for p in parts] for parts in payload.arrays]
        for (dt, _), parts in zip(payload.meta, arrays):
            if not _is_float_meta(dt):
                continue
            if mode == "nan":
                k = 1 if len(parts) > 1 else 0
                parts[k] = _nan_first(parts[k])
                break
            for k, p in enumerate(parts):
                if p.is_floating_point():
                    parts[k] = p * float(np.float32(factor))
        return CompressedTree(payload.codec, payload.version, payload.is_delta,
                              payload.raw_nbytes, payload.meta, payload.structure, arrays,
                              sa=payload.sa)
    return _corrupt_plain(payload, mode, factor, {"done": False})


class ChaosInjector:
    """The per-manager injector ``FedMLCommManager`` consults on every send
    and delivery. ``round_provider`` supplies the authoritative round for
    windowed faults (the server's ``args.round_idx``, a client's own
    ``round_idx``) when a message carries no ``round`` header."""

    def __init__(self, spec: ChaosSpec, rank: int,
                 round_provider: Optional[Callable[[], int]] = None):
        self.spec = spec
        self.rank = int(rank)
        self.round_provider = round_provider
        self._seq: Dict[Tuple[str, int], int] = {}

    @staticmethod
    def _m_injected(action: str) -> None:
        get_registry().counter("resilience/chaos_injections",
                               labels={"action": action}).inc()

    def _round_of(self, msg: Any) -> Optional[int]:
        rnd = msg.get("round")
        if rnd is None and self.round_provider is not None:
            try:
                rnd = self.round_provider()
            except Exception:  # pragma: no cover - the provider is best-effort
                rnd = None
        try:
            return int(rnd) if rnd is not None else None
        except (TypeError, ValueError):
            return None

    def _partitioned(self, a: int, b: int, rnd: Optional[int]) -> bool:
        if rnd is None:
            return False
        for p in self.spec.partitions:
            if p["round"] <= rnd < p["heal_round"]:
                ranks = set(p["ranks"])
                if (a in ranks) != (b in ranks):  # across the cut
                    return True
        return False

    def _roll(self, kind: str, peer: int, seq: int) -> float:
        return _unit_hash(self.spec.seed, kind, self.rank, peer, seq)

    def on_send(self, msg: Any) -> Tuple[int, float]:
        """A send's fate, ``(copies, delay_s)``: 0 copies drop it, 2
        duplicate it; deterministic per (seed, peer, send sequence)."""
        peer = int(msg.get_receiver_id())
        seq = self._seq[("send", peer)] = self._seq.get(("send", peer), 0) + 1
        if self._partitioned(self.rank, peer, self._round_of(msg)):
            self._m_injected("partition_drop")
            return 0, 0.0
        copies, delay_s = 1, 0.0
        if self.spec.drop and self._roll("drop", peer, seq) < self.spec.drop:
            self._m_injected("drop")
            return 0, 0.0
        if self.spec.duplicate and self._roll("dup", peer, seq) < self.spec.duplicate:
            self._m_injected("duplicate")
            copies = 2
        if self.spec.delay_ms and self._roll("delay", peer, seq) < self.spec.delay:
            self._m_injected("delay")
            delay_s = self.spec.delay_ms / 1e3
        return copies, delay_s

    def on_deliver(self, msg: Any) -> bool:
        """The inbound filter: False swallows a message that would have
        crossed a live partition."""
        if self._partitioned(self.rank, int(msg.get_sender_id()), self._round_of(msg)):
            self._m_injected("partition_drop")
            return False
        return True

    def corrupt_payload(self, msg: Any) -> None:
        """Mutate an outbound model payload on the message while one of this
        rank's corruption windows is live: called by ``send_message`` right
        before the transport, after the encode."""
        if not self.spec.corrupt_updates:
            return
        payload = msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
        if payload is None:
            return
        rnd = self._round_of(msg)
        for w in self.spec.corrupt_updates:
            if w.tier is None and w.active_at(self.rank, rnd):
                self._m_injected("corrupt_update")
                payload = corrupt_model_payload(payload, w.mode, w.factor)
                msg.add_params(Message.MSG_ARG_KEY_MODEL_PARAMS, payload)


class ServerKillWindow:
    """SIGKILL the server itself mid-round, once it has journaled
    ``after_uploads`` uploads of round ``round``: the deterministic trigger
    the kill-and-respawn runner keys its MTTR to.

    The spec rides ``args.chaos.kill_server`` or the
    ``FEDML_CHAOS_KILL_SERVER`` environment variable (JSON, ``{"round": 2,
    "after_uploads": 1}``); the supervisor passes the variable to the first
    server process only, so the respawned server cannot re-trigger its own
    death."""

    __slots__ = ("round", "after_uploads")

    def __init__(self, round: int, after_uploads: int = 1):
        self.round = int(round)
        self.after_uploads = max(1, int(after_uploads))

    @classmethod
    def from_args(cls, args: Any) -> Optional["ServerKillWindow"]:
        raw = os.environ.get("FEDML_CHAOS_KILL_SERVER")
        spec = None
        if raw:
            spec = json.loads(raw)
        else:
            chaos = getattr(args, "chaos", None)
            if isinstance(chaos, str) and chaos:
                chaos = json.loads(chaos)
            if isinstance(chaos, dict):
                spec = chaos.get("kill_server")
        if not spec:
            return None
        return cls(int(spec.get("round", 0)), int(spec.get("after_uploads", 1)))

    def maybe_kill(self, round_idx: int, n_received: int) -> None:
        """SIGKILL this process: no cleanup, no atexit, no flush — the
        honest preemption the journal exists to survive."""
        if int(round_idx) == self.round and int(n_received) >= self.after_uploads:
            logger.warning("chaos: SIGKILLing the server at round %d after %d upload(s)",
                           round_idx, n_received)
            os.kill(os.getpid(), signal.SIGKILL)


class AgentKillWindow:
    """The scheduler tier's agent kill: refused until the scheduler is
    ported (ROADMAP A13)."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "AgentKillWindow is scheduler-tier chaos; the scheduler comes with ROADMAP A13")


class NodeDrain:
    """The scheduler tier's preemption notice: refused until the scheduler
    is ported (ROADMAP A13)."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "NodeDrain is scheduler-tier chaos; the scheduler comes with ROADMAP A13")


def chaos_from_args(args: Any, rank: int,
                    round_provider: Optional[Callable[[], int]] = None
                    ) -> Optional[ChaosInjector]:
    """The comm manager's constructor hook: None unless ``args.chaos`` is
    set, so the production path stays a None-check."""
    spec = ChaosSpec.parse(getattr(args, "chaos", None),
                           seed=int(getattr(args, "chaos_seed", 0)))
    if spec is None:
        return None
    return ChaosInjector(spec, rank, round_provider=round_provider)


def run_chaos_scenario(seed: int = 0, rounds: int = 5, clients: int = 3,
                       kill_rank: Optional[int] = None, kill_round: int = 2,
                       revive_round: Optional[int] = None, drop: float = 0.0,
                       duplicate: float = 0.0, delay_ms: float = 0.0,
                       compression: str = "", secagg: str = "", secagg_clip: float = 0.2,
                       round_deadline_s: float = 30.0, round_quorum: float = 2.0 / 3.0,
                       timeout: float = 300.0, corrupt_rank: Optional[int] = None,
                       corrupt_round: int = 1, corrupt_mode: str = "nan",
                       corrupt_factor: float = 50.0, integrity: bool = False,
                       agg_robust: str = "", device: DeviceLike = "cuda") -> Dict:
    """Run an in-process cross-silo federation (the reference's LR on its
    synthetic data) under a chaos spec on ``device``; returns a JSON-safe
    summary: the spec, the wall, whether it completed, the server's result
    and the ``resilience/*`` (and ``integrity/*``, ``secagg/*``) counters
    the run moved. ``corrupt_rank`` arms an update-corruption window; pair
    it with ``integrity`` and/or ``agg_robust`` to show containment."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    chaos: Dict[str, Any] = {}
    if kill_rank is not None:
        chaos["kill"] = {"rank": int(kill_rank), "round": int(kill_round),
                         "revive_round": int(revive_round if revive_round is not None
                                             else kill_round + 1)}
    if drop:
        chaos["drop"] = float(drop)
    if duplicate:
        chaos["duplicate"] = float(duplicate)
    if delay_ms:
        chaos["delay_ms"] = float(delay_ms)
    if corrupt_rank is not None:
        chaos["corrupt_update"] = [{"rank": int(corrupt_rank), "round": int(corrupt_round),
                                    "mode": str(corrupt_mode),
                                    "factor": float(corrupt_factor)}]
    cfg = {
        "common_args": {"training_type": "cross_silo", "random_seed": seed,
                        "run_id": f"chaos_{seed}"},
        "data_args": {"dataset": "synthetic", "train_size": 60 * clients,
                      "test_size": 60, "class_num": 4, "feature_dim": 10},
        "model_args": {"model": "lr"},
        "train_args": {
            "federated_optimizer": "FedAvg", "client_num_in_total": clients,
            "client_num_per_round": clients, "comm_round": rounds, "epochs": 1,
            "batch_size": 32, "learning_rate": 0.3,
            "round_deadline_s": round_deadline_s, "round_quorum": round_quorum,
            "chaos": chaos, "chaos_seed": seed,
            **({"compression": compression} if compression else {}),
            **({"integrity": True} if integrity else {}),
            **({"agg_robust": agg_robust} if agg_robust else {}),
            **({"secagg": secagg, "secagg_clip": secagg_clip} if secagg else {}),
        },
    }
    args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
    ds = load_federated(args)
    model = create(args, ds.class_num)
    reg = get_registry()
    counter_names = ["resilience/quorum_rounds", "resilience/clients_evicted",
                     "resilience/clients_rejoined", "resilience/stale_uploads",
                     "resilience/duplicates_dropped", "resilience/chaos_injections"]
    if integrity or corrupt_rank is not None:
        counter_names += ["integrity/screened_uploads", "integrity/nonfinite_uploads",
                          "integrity/norm_overflows", "integrity/z_outliers",
                          "integrity/quarantined", "integrity/rollbacks",
                          "integrity/nonfinite_wire"]
    if secagg:
        counter_names += ["secagg/rounds", "secagg/recoveries", "secagg/seeds_revealed",
                          "secagg/recovery_failures"]
    before = {n: reg.total(n) for n in counter_names}
    t0 = time.time()
    result = run_cross_silo_inproc(args, ds, model, timeout=timeout, device=device)
    wall_s = time.time() - t0
    return {
        "seed": int(seed), "rounds": int(rounds), "clients": int(clients),
        "chaos": chaos, "wall_s": round(wall_s, 3), "completed": result is not None,
        "result": {k: (round(float(v), 6) if isinstance(v, (int, float)) else v)
                   for k, v in (result or {}).items()},
        "counters": {n.split("/")[1]: reg.total(n) - v for n, v in before.items()},
    }
