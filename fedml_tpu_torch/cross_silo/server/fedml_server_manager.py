"""Cross-silo server FSM — counterpart of
``fedml_tpu/cross_silo/server/fedml_server_manager.py``, its synchronous
path: wait for every client's ONLINE status → broadcast the round's model
→ collect uploads → aggregate, test, select the next cohort → sync or
finish.

The messages are the reference's, so a JAX client can join a port server.
An uncompressed model crosses a message in the reference's form (nested,
in its layout: ``models/convert.to_wire_params``) and is converted back on
receipt, on LOCAL as on BROKER. Under a broadcast-safe codec the broadcast
is encoded once and fanned out, and under a lossy one the clients' deltas
resolve against the broadcast as they decoded it.

With ``round_deadline_s`` a dead client cannot hang a round: the deadline
(the static ceiling, tightened by the clients' latency EWMAs once they
exist) closes the round on a quorum of uploads, evicts the missing clients
and probes them each round; a returning client is re-synced and re-enters
at the next selection. A round stuck below quorum re-arms a bounded number
of times, then aborts the federation through ``handler_error``.

The integrity rings are the reference's (``integrity: true``,
``agg_robust``): quarantined clients sit out the selection; each upload is
screened on receipt (under the round lock, as the reference admits it; the
quarantine that follows a drop runs outside it), a screened sender counts
as missing and the round closes over the rest, with the per-block z pass
at the close; ``agg_robust`` rides the round-config header and swaps the
fused weighted mean for the robust statistic; and the acceptance guard may
reject the aggregate (non-finite, before anything else sees it) or the
eval (a loss spike), which rolls the round back to its round-open state
and re-runs it with a fresh cohort. Attacks, defenses and DP are the
singletons' and run in the aggregator's and the trainers' hooks.

Masked secure aggregation (``secagg: int8``) is the reference's: each
client's key advertisement rides its status messages, the round header
(roster, key directory, codec spec) rides the broadcast, every upload must
be a masked tree whose header matches the open round (else it is dropped
and counted), and the round resolves only in aggregate through the unmask.
A round that closes at quorum with missing clients first asks the
survivors for the pair seeds they shared with the evicted ones; a survivor
that never answers is evicted too, in bounded waves, then the federation
aborts. Every trust hook that needs one client's plaintext is refused at
construction. ``secure_aggregation: true`` selects the Bonawitz FSM
instead (``cross_silo/secagg``, through the server facade).

With ``checkpoint_dir`` the server saves the round state (the aggregated
model, the server optimizer's state, the DP counters, the next round)
after every ``checkpoint_frequency`` accepted rounds (``core/checkpoint``);
with ``resume: true`` a restarted server re-enters at the round after the
newest restorable one, and a rolled-back round restores from the newest
checkpoint before the round-open snapshot, as the reference's.
Contribution assessment (``enable_contribution``) runs in the aggregator.

With ``durability: true`` (and ``checkpoint_dir``) a write-ahead round
journal (``resilience/durability``) records every round-state transition
as the reference does: the round's identity before its broadcast leaves,
each admitted upload in its wire form (durable before it is applied), the
quorum close, and the commit, which forces a checkpoint and resets the
journal; a rolled-back round is journaled as terminal. A server restarted
with ``resume: true`` replays the journal at construction and re-enters the
interrupted round mid-flight: the salvaged uploads go back into the
aggregator (their msg ids prime the dedup, so a late copy drops), only the
rest of the cohort gets the round's broadcast again, and a round that had
closed closes again at once. A masked (secagg) round cannot resume: its
salvaged uploads are dropped loudly (``secagg/resume_aborts``) and the round
restarts from the checkpoint. ``chaos: {kill_server: ...}`` (or
``FEDML_CHAOS_KILL_SERVER``) SIGKILLs the server after the chosen journaled
upload, and needs the journal.

The server traces each round as the reference does: its broadcast goes out
under ``round/<n>/sync``, whose context rides every init and sync message,
so each silo's handler and training spans join the round's trace; then
``round/<n>/aggregate`` and ``round/<n>/eval``. The spans land in
``<log_file_dir>/run_<run_id>/spans.jsonl`` stamped ``rank0`` and the
flight recorder is armed there; ``mlops.log`` records the init broadcast
and each accepted round's metrics. Device memory is sampled after each
aggregate (``mem_sample`` in ``health.jsonl``), the trace controller
brackets each round from its broadcast to its aggregate (``trace_rounds``
captures it), and ``finish`` writes ``programs.jsonl``.

Run health is the reference's: a ``ClientHealthTracker`` scores each client
from its admitted uploads (latency from the broadcast, update norm, the
heartbeat's loss and memory) and its status heartbeats, and writes a
``client_health`` record a client each aggregated round; its latency EWMA
sets the adaptive deadline. Every fault the server absorbs (a stale,
invalid or screened-out upload, a deadline, an eviction, a rejoin, a
recovery wave, a journal replay, an abort) lands as a ``resilience_event``
record beside its counter, and a masked round that cannot resume as a
``secagg_event``; ``telemetry doctor`` triages them.

With ``live_telemetry: true`` this rank hosts the live plane
(``telemetry.live.LivePlane``): the collector every client's piggybacked
metric and span frames merge into, the online doctor, and a ``/metrics``
endpoint when ``metrics_port`` is set. It loops its own registry back after
each aggregate (the health scores and the just-closed round's critical path
reach the doctor then), and on a distributed backend it waits up to
``finish_grace_s`` for each client's final status, which carries its last
full frames, before it closes the plane. Not ported yet, and refused when
its arguments are set: FHE (A13).
``cross_silo/round_ms`` (broadcast to the test after aggregation), the
journal's append and replay times, and the reference's ``resilience/*``,
``integrity/*`` and ``secagg/*`` counters go to the port's metrics
registry.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.compression import CompressedTree, check_trust_stack, derive_key, get_codec
from fedml_tpu_torch.core.checkpoint import (
    apply_round_state,
    engine_checkpointer,
    pack_round_state,
    should_save,
)
from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.core.mlops import metrics as mlops
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.server.fedml_aggregator import FedMLAggregator
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.integrity import (
    AcceptanceGuard,
    IntegrityConfig,
    QuarantineList,
    RollbackBudgetExceeded,
    UpdateScreen,
    parse_robust_spec,
    resolve_agg_robust,
)
from fedml_tpu_torch.models.convert import (
    from_reference_layout,
    from_wire_params,
    to_reference_layout,
    to_wire_params,
)
from fedml_tpu_torch.privacy.secagg import SecAggMessage, SecAggServerSession
from fedml_tpu_torch.resilience import (
    RoundDeadline,
    ServerKillWindow,
    adaptive_deadline_s,
    journal_from_args,
    quorum_size,
    salvage_round,
)
from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.telemetry.device_stats import DeviceStatsSampler
from fedml_tpu_torch.telemetry.health import (
    ClientHealthTracker,
    log_health_event,
    update_norm,
)
from fedml_tpu_torch.telemetry.live import LivePlane
from fedml_tpu_torch.telemetry.profiling import get_trace_controller
from fedml_tpu_torch.telemetry.spans import configure_from_args, flush_run

logger = logging.getLogger(__name__)


class FedMLServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator: FedMLAggregator, comm=None,
                 client_rank: int = 0, client_num: int = 0,
                 backend: str = COMM_BACKEND_LOCAL, device: DeviceLike = "cpu"):
        check_trust_stack(args)
        super().__init__(args, comm, client_rank, client_num + 1, backend, device)
        # the run-dir sinks (spans, flight recorder), as the sp engine binds them
        self.tracer = configure_from_args(args, service=f"rank{self.rank}")
        # the live plane's host (None unless live_telemetry): the collector,
        # the online doctor and the optional /metrics endpoint
        self._live = LivePlane.from_args(args, node=f"rank{self.rank}",
                                         run_dir=self.tracer.sink_dir)
        # device memory sampled per aggregate (mem/* gauges, health.jsonl);
        # each client scored from its uploads and piggybacked heartbeats
        # (client_health records, health/* gauges; its latency EWMA sets the
        # adaptive deadline)
        self._devstats = DeviceStatsSampler()
        self._health = ClientHealthTracker()
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 1))
        self.args.round_idx = 0
        self.client_num = client_num
        # round checkpoints: a restarted server re-enters at the last
        # aggregated round with its model and optimizer state
        self._ckpt = engine_checkpointer(args)
        self.resumed_from: Optional[int] = None
        if self._ckpt is not None and bool(getattr(args, "resume", False)):
            restored = self._ckpt.restore_latest(
                self._round_state(0), device=self.aggregator.device)
            if restored is not None:
                self.resumed_from, state = restored
                self.aggregator.set_global_model_params(state["global_params"])
                self.args.round_idx = apply_round_state(state, self.aggregator.server_opt)
        self.client_online_status: Dict[int, bool] = {}
        self.client_id_list_in_this_round: Optional[List[int]] = None
        self.data_silo_index_of_client: Dict[int, int] = {}
        self.is_initialized = False
        self.result: Optional[dict] = None
        # the broadcast goes through the configured codec and the spec rides
        # every round config, so clients upload delta-encoded updates (not
        # under the Bonawitz FSM's flag: quantizing masked models would break
        # the cancellation)
        self._codec = (None if getattr(args, "secure_aggregation", False)
                       else get_codec(getattr(args, "compression", ""), args))
        # masked secure aggregation (secagg: int8): uploads arrive masked and
        # resolve only in aggregate; a quorum close with missing clients runs
        # the seed-reveal recovery before it aggregates
        self._secagg = SecAggServerSession.from_args(args, client_num)
        self._bcast_ts: Dict[int, float] = {}
        self._round_t0 = 0.0
        self._round_lock = threading.Lock()
        self._round_closed = False
        self._deadline_expired = False
        self._deadline_extensions_used = 0
        self._completing = False
        self._finished_once = False
        # the finish grace: after FINISH, wait for each client's final status
        # (its last full frames) before closing the live plane
        self._finishing = False
        self._final_status_pending: set = set()
        self._finish_grace_timer: Optional[threading.Timer] = None
        self._deadline = RoundDeadline(self._on_round_deadline)
        # the recovery's bounded waves re-arm this timer, never the round's
        self._recovery_deadline = RoundDeadline(self._on_recovery_deadline)
        self._m_round_ms = get_registry().histogram("cross_silo/round_ms")
        if self._secagg is not None:
            self._check_secagg_compat()
            self.aggregator.set_secagg(self._secagg)

        # crash-anywhere durability (parity: fedml_server_manager.py:141-195)
        self._journal = journal_from_args(args)
        self._kill_window = ServerKillWindow.from_args(args)
        if self._kill_window is not None and self._journal is None:
            # the kill would lose every received upload unrecoverably
            raise ValueError("chaos kill_server needs durability: true — the kill window "
                             "fires after uploads are journaled, and recovery replays "
                             "that journal")
        self._salvaged = None
        if self._journal is not None and bool(getattr(args, "resume", False)):
            self._salvaged = self._replay_journal()

        # the integrity rings (parity: fedml_server_manager.py:197-262)
        self._agg_robust = resolve_agg_robust(args, codec=self._codec)
        icfg = IntegrityConfig.from_args(args)
        if self._secagg is not None:
            conflicts = []
            if self._agg_robust:
                conflicts.append(f"agg_robust {self._agg_robust!r} (per-coordinate "
                                 "sorting needs per-client values the masks hide)")
            if icfg is not None and icfg.screen_enabled:
                conflicts.append("integrity screening (per-upload introspection is what "
                                 "the masks exist to prevent; secagg_clip is the masked "
                                 "wire's admission control)")
            if conflicts:
                raise ValueError("secure aggregation (secagg: int8) cannot run with: "
                                 + "; ".join(conflicts))
        if parse_robust_spec(getattr(args, "agg_robust", "")) is not None:
            if self._codec is None:
                raise ValueError(
                    "agg_robust rides the compressed fused aggregation path; set "
                    "compression (int8/bf16/identity), or use enable_defense + "
                    "defense_type for uncompressed runs")
            if not self._codec.broadcast_safe:
                raise ValueError(
                    f"agg_robust needs dense per-coordinate uploads; codec "
                    f"{self._codec.spec!r} is sparse — use int8/bf16/identity")
        self._screen: Optional[UpdateScreen] = None
        self._quarantine: Optional[QuarantineList] = None
        self._guard: Optional[AcceptanceGuard] = None
        if icfg is not None:
            self._quarantine = QuarantineList(icfg.quarantine_rounds)
            if icfg.screen_enabled and self._secagg is None:
                self._screen = UpdateScreen(icfg.norm_mult, icfg.z_threshold)
            if icfg.rollback_enabled:
                self._guard = AcceptanceGuard(icfg.loss_mult, icfg.loss_min_history,
                                              icfg.max_rollbacks)
        # senders screened out this round: they never re-upload, so the
        # close counts them as missing
        self._screened_out: set = set()
        # ring 3's restore point: the round-open state
        self._pre_round_state: Optional[dict] = None

    def _replay_journal(self):
        """The journal's open round, if it is the one the checkpoint resumes
        at and it is not masked; anything else is reset away."""
        reg = get_registry()
        t0 = time.perf_counter()
        records = self._journal.records(device=self.aggregator.device)
        if not records:
            return None
        reg.counter("resilience/restarts").inc()
        sal = salvage_round(records, int(self.args.round_idx))
        if sal is not None and sal.secagg:
            # the pairwise masks died with the session: the salvaged masked
            # uploads can never unmask, so the round restarts from the
            # checkpoint boundary, loudly
            reg.counter("secagg/resume_aborts").inc()
            log_health_event({"kind": "secagg_event", "event": "resume_aborted",
                              "round": sal.round_idx, "uploads_dropped": len(sal.uploads)})
            logger.error("secagg round %d cannot resume mid-round after a restart (masks "
                         "are irrecoverable without the session): dropping %d journaled "
                         "masked upload(s) and restarting the round from the checkpoint "
                         "boundary", sal.round_idx, len(sal.uploads))
            sal = None
        if sal is None:
            self._journal.reset()  # stale records: the checkpoint covers them
        reg.histogram("journal/replay_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return sal

    def _check_secagg_compat(self) -> None:
        """A masked round never exposes one client's model, so every trust
        hook that reads per-client plaintext is refused here, not
        mid-round (FHE is refused earlier, as not ported)."""
        from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
            FedMLDifferentialPrivacy,
        )
        from fedml_tpu_torch.core.security.attacker import FedMLAttacker
        from fedml_tpu_torch.core.security.defender import FedMLDefender

        conflicts = []
        if FedMLAttacker.get_instance().is_model_attack():
            conflicts.append("model-attack injection")
        if FedMLDefender.get_instance().is_defense_enabled():
            conflicts.append("list-based defenses (secagg_clip already bounds every "
                             "client update inside the masked encode)")
        if self.aggregator._contrib.is_enabled():
            conflicts.append("contribution assessment")
        if self._codec is not None and not self._codec.broadcast_safe:
            conflicts.append(f"upload codec {self._codec.spec!r} (secagg owns the upload "
                             "wire; only broadcast-safe compression applies)")
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_dp_enabled() and dp.is_global_dp_enabled() and getattr(
                getattr(dp.frame, "mechanism", None), "sigma", None) is None:
            conflicts.append("non-gaussian central-DP mechanism (only gaussian has an "
                             "in-program noise path)")
        if conflicts:
            raise ValueError("secure aggregation (secagg: int8) cannot run with "
                             "per-client-plaintext features: " + "; ".join(conflicts))

    # -- broadcast ------------------------------------------------------------
    def _broadcast_payload(self, global_params):
        """The round's broadcast, encoded once and fanned out to the cohort."""
        if self._codec is None or not self._codec.broadcast_safe:
            # an upload-only codec (topk) rides the negotiation header only
            self.aggregator.set_delta_base(None)
            return to_wire_params(global_params)
        # rank 0's key slot: clients encode uploads under their own ranks
        ct = self._codec.encode(
            to_reference_layout(global_params),
            key=derive_key(int(getattr(self.args, "random_seed", 0)),
                           int(self.args.round_idx), 0))
        # clients delta against the broadcast as they decode it; the server
        # resolves against the same base, or the broadcast's quantization
        # error would leak into every aggregate
        self.aggregator.set_delta_base(
            None if self._codec.lossless else from_reference_layout(self._codec.decode(ct)))
        return ct

    def _send_round_config(self, client_ids: List[int], payload, sa_header,
                           init: bool) -> None:
        msg_type = (MyMessage.MSG_TYPE_S2C_INIT_CONFIG if init
                    else MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
        for client_id in client_ids:
            msg = Message(msg_type, self.get_sender_id(), client_id)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, payload)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                           int(self.data_silo_index_of_client[client_id]))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.args.round_idx))
            if self._codec is not None:
                msg.add_params(Message.MSG_ARG_KEY_COMPRESSION, self._codec.spec)
            if self._agg_robust:
                # negotiated like the codec spec
                msg.add_params(Message.MSG_ARG_KEY_AGG_ROBUST, self._agg_robust)
            if sa_header is not None:
                msg.add_params(SecAggMessage.MSG_ARG_KEY_SECAGG, sa_header)
            self._bcast_ts[client_id] = time.time()
            self.send_message(msg)

    def _open_round(self, global_params, init: bool) -> None:
        """Broadcast the current round to its cohort and arm its deadline."""
        self._round_t0 = time.perf_counter()
        payload = self._broadcast_payload(global_params)
        sa_header = self._secagg_round_header()
        self._capture_round_state()
        with self._round_lock:
            self._round_closed = False
            self._deadline_expired = False
            self._deadline_extensions_used = 0
            self._completing = False
            self._screened_out = set()
            cohort = list(self.client_id_list_in_this_round)
        self._journal_round_open()
        # the open span's context rides each message of the broadcast, so
        # every silo's spans join this round's trace
        with self.tracer.span(f"round/{self.args.round_idx}/sync", n_clients=len(cohort)):
            self._send_round_config(cohort, payload, sa_header, init)
        self._arm_round_deadline()

    def _secagg_round_header(self) -> Optional[dict]:
        """Open a masked round: roster, key directory and codec spec, riding
        the broadcast at no extra round trip."""
        if self._secagg is None:
            return None
        with self._round_lock:
            cohort = list(self.client_id_list_in_this_round)
        return self._secagg.begin_round(int(self.args.round_idx), cohort)

    def send_init_msg(self) -> None:
        # the first round opens here: without this hook the start round
        # could never be traced
        try:
            get_trace_controller().on_round_start(self.args.round_idx)
        except Exception:  # noqa: BLE001 - profiling never breaks the round
            logger.exception("trace controller start hook failed")
        self._open_round(self.aggregator.get_global_model_params(), init=True)
        mlops.log({"event": "server.init_sent", "round": 0})

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client)
        self.register_message_receive_handler(
            SecAggMessage.MSG_TYPE_C2S_SECAGG_REVEAL, self.handle_message_secagg_reveal)

    # -- handlers -------------------------------------------------------------
    def handle_message_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            return
        for client_id in range(1, self.client_num + 1):  # the liveness handshake
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                      self.get_sender_id(), client_id))

    def handle_message_client_status_update(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        hb = msg.get(Message.MSG_ARG_KEY_HEALTH)
        if isinstance(hb, dict):
            self._health.heartbeat(sender, hb)
        if self._secagg is not None:
            # the key advertisement rides every status and heartbeat
            pk = msg.get(SecAggMessage.MSG_ARG_KEY_SECAGG_PK)
            if pk is not None:
                try:
                    self._secagg.note_pk(sender, pk)
                except ValueError:
                    logger.warning("dropping malformed secagg key advertisement from "
                                   "client %s", sender)
        # during the finish grace the handler is a sink (the frames were
        # ingested on receipt): once every final status is in, finish
        with self._round_lock:
            drained = None
            if self._finishing:
                self._final_status_pending.discard(sender)
                drained = not self._final_status_pending
        if drained is not None:
            if drained:
                self.finish()
            return
        # any sign of life from an evicted client is its reconnect
        if self.is_initialized and self.liveness.is_evicted(sender):
            self._readmit_client(sender)
            return
        if msg.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS) == MyMessage.MSG_CLIENT_STATUS_IDLE:
            self.client_online_status[sender] = True
        all_online = all(self.client_online_status.get(cid, False)
                         for cid in range(1, self.client_num + 1))
        if all_online and not self.is_initialized:
            self.is_initialized = True
            if self.args.round_idx >= self.round_num:
                # resumed past the final round: report and finish, without
                # a round beyond comm_round
                metrics = self.aggregator.test_on_server_for_all_clients(
                    self.args.round_idx - 1)
                with self._round_lock:
                    self.result = {"rounds": self.round_num, **metrics}
                self._send_finish()
                self._finish_after_final_frames()
                return
            with self._round_lock:
                salvaged = self._salvaged is not None
            if salvaged:
                self._resume_salvaged_round()
                return
            self._select_round_clients()
            self.send_init_msg()

    def _select_round_clients(self) -> None:
        client_ids = list(range(1, self.client_num + 1))
        # quarantined clients sit out until their rounds elapse, whether or
        # not they are evicted
        if self._quarantine is not None:
            client_ids = self._quarantine.filter_selection(client_ids,
                                                           int(self.args.round_idx))
            if not client_ids:
                raise RuntimeError(
                    "every client is quarantined; the federation has no "
                    "trustworthy cohort left (see the integrity/* counters)")
        # evicted clients sit out until they rejoin; each round probes them,
        # so a revived client has a deterministic way back in
        evicted = set(self.liveness.evicted())
        if evicted:
            client_ids = [c for c in client_ids if c not in evicted]
            if not client_ids:
                raise RuntimeError("every client is evicted; the federation cannot "
                                   "make progress (check round_deadline_s)")
            self._probe_evicted(sorted(evicted))
        cohort = self.aggregator.client_selection(
            self.args.round_idx, client_ids,
            min(int(self.args.client_num_per_round), len(client_ids)))
        silo_indexes = self.aggregator.data_silo_selection(
            self.args.round_idx, int(self.args.client_num_in_total), len(cohort))
        # this can run on the deadline's timer thread while the receive
        # thread reads the cohort: both fields change under the round lock
        with self._round_lock:
            self.client_id_list_in_this_round = cohort
            self.data_silo_index_of_client = dict(zip(cohort, silo_indexes))

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        model_params = wire = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        msg_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND)
        missing = None
        screened = None
        invalid = None
        with self._round_lock:
            cohort = list(self.client_id_list_in_this_round or [])
            stale = (self._round_closed or sender not in cohort
                     or (msg_round is not None
                         and int(msg_round) != int(self.args.round_idx)))
            if not stale and self._secagg is not None:
                # a masked upload whose metadata lies is dropped: it never
                # reaches the aggregate
                try:
                    self._secagg.validate_upload(sender, model_params)
                except ValueError as e:
                    invalid = str(e)
            if not stale and invalid is None:
                if not isinstance(model_params, CompressedTree):
                    model_params = from_wire_params(model_params, self.device)
                if self._screen is not None:
                    # ring 1 admission: a dropped upload never reaches the
                    # aggregator; its sender counts as missing
                    screened = self._screen.admit(
                        sender, int(self.args.round_idx), model_params,
                        base=self._screen_base(model_params))
                if screened is not None:
                    self._screened_out.add(sender)
                else:
                    self._observe_client_upload(sender, msg, model_params)
                    if self._journal is not None:
                        # durable before it is applied, in its wire form
                        self._journal_upload(msg, sender, wire)
                    self.aggregator.add_local_trained_result(
                        cohort.index(sender), model_params,
                        msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES),
                        local_steps=msg.get("local_steps"))
                missing = self._try_close_round(cohort)
        if (self._kill_window is not None and not stale and invalid is None
                and screened is None):
            # the chaos seam: after the upload is journaled, so exactly this
            # upload is salvaged and never retrained
            self._kill_window.maybe_kill(int(self.args.round_idx),
                                         self.aggregator.n_received())
        if invalid is not None:
            self._resilience_event("secagg_invalid_upload", client=sender,
                                   round=self.args.round_idx, reason=invalid,
                                   counter="secagg/invalid_uploads")
            logger.warning("dropping invalid masked upload from client %s: %s", sender,
                           invalid)
            return
        if screened is not None:
            # outside the lock: the sender loses its trust; the close evicts
            # it and quarantine keeps a readmitted sender out of selection
            self._quarantine.quarantine(sender, int(self.args.round_idx), screened)
            logger.warning("dropping screened upload from client %s: %s", sender,
                           screened)
        if stale:
            # a closed round's upload, or one from outside the cohort: never
            # applied; from an evicted client it is also its sign of life
            self._resilience_event("stale_upload", client=sender, upload_round=msg_round,
                                   server_round=self.args.round_idx,
                                   counter="resilience/stale_uploads")
            logger.warning("dropping stale upload from client %s (round %s, server at "
                           "round %s)", sender, msg_round, self.args.round_idx)
            if self.liveness.is_evicted(sender):
                self._readmit_client(sender)
            return
        if missing is not None:
            self._finish_round(missing)

    def _screen_base(self, payload):
        """What a non-delta upload is screened against: the round's upload
        base, in the payload's layout."""
        if isinstance(payload, CompressedTree):
            if payload.is_delta:
                return None
            return to_reference_layout(self.aggregator.get_upload_base())
        return self.aggregator.get_upload_base()

    def _try_close_round(self, cohort: List[int]) -> Optional[List[int]]:
        """Under the round lock: close the round if every upload arrived,
        or every unscreened sender arrived (a screened one never re-uploads;
        with the quorum still held, or under the all-received contract), or
        the deadline expired with a quorum in. Returns the missing cohort
        ids once closed, else None (parity: fedml_server_manager.py:653-744)."""
        expected = len(cohort)
        received = self.aggregator.n_received()
        need = quorum_size(expected, self.resilience.round_quorum)
        if received < expected:
            quorum_ok = received >= need or self.resilience.round_quorum >= 1.0
            screened_complete = (
                self._screened_out
                and received >= max(1, expected - len(self._screened_out))
                and quorum_ok)
            if not (screened_complete or (self._deadline_expired and received >= need)):
                return None
        if self._screen is not None:
            # ring 1's cohort pass: z outliers are dropped from the staged
            # uploads and quarantined, and close as missing
            for cid, reason in self._screen.close_round(int(self.args.round_idx)).items():
                if cid in cohort:
                    self.aggregator.drop_client_upload(cohort.index(cid))
                    self._screened_out.add(cid)
                    self._quarantine.quarantine(cid, int(self.args.round_idx), reason)
                    logger.warning("dropping z-outlier upload from client %s: %s",
                                   cid, reason)
            received = self.aggregator.n_received()
            if received == 0:
                return None  # nothing trustworthy: the deadline machinery aborts
            if received < need:
                # the honest subset still aggregates, but never silently
                logger.warning(
                    "round %d closing BELOW quorum after z-outlier drops: %d/%d "
                    "honest uploads (quorum %d)", int(self.args.round_idx), received,
                    expected, need)
                self._resilience_event("below_quorum_integrity_close",
                                       round=int(self.args.round_idx), received=received,
                                       expected=expected, quorum=need,
                                       counter="integrity/below_quorum_closes")
        missing_idx = self.aggregator.close_round_quorum(expected)
        self._round_closed = True
        self._deadline.cancel()
        if self._journal is not None:
            # a replay of a closed, uncommitted round closes on exactly this
            # missing set; not synced: a lost marker only re-closes the round
            self._journal.append("quorum_close", durable=False,
                                 round=int(self.args.round_idx),
                                 missing=[int(i) for i in missing_idx])
        return [cohort[i] for i in missing_idx]

    def _on_round_deadline(self, round_idx: int) -> None:
        """Timer thread: the armed round ran out of time."""
        with self._round_lock:
            if (self._round_closed or not self.is_initialized
                    or int(round_idx) != int(self.args.round_idx)):
                return  # the round closed normally
            self._deadline_expired = True
            cohort = list(self.client_id_list_in_this_round or [])
            missing = self._try_close_round(cohort)
            received = self.aggregator.n_received()
            extended = False
            if missing is None:
                # below quorum: a later upload that reaches quorum closes the
                # round, but a federation that never does must not wait
                # forever: a bounded number of re-arms, then abort. Re-armed
                # under the lock, so it cannot cancel the next round's timer.
                self._deadline_extensions_used += 1
                extended = (self._deadline_extensions_used
                            <= self.resilience.deadline_extensions)
                if extended:
                    self._deadline.arm(round_idx, self.resilience.round_deadline_s)
        need = quorum_size(len(cohort), self.resilience.round_quorum)
        self._resilience_event("deadline_expired", round=round_idx, received=received,
                               expected=len(cohort), quorum=need,
                               counter="resilience/deadline_fired")
        if missing is None:
            if extended:
                logger.warning("round %d deadline expired with %d/%d uploads (< quorum "
                               "%d); extension %d/%d armed", round_idx, received,
                               len(cohort), need, self._deadline_extensions_used,
                               self.resilience.deadline_extensions)
                return
            self._abort_federation(
                f"round {round_idx} stuck below quorum: {received}/{len(cohort)} uploads "
                f"after {self.resilience.deadline_extensions} deadline extensions "
                f"(need {need})")
            return
        logger.warning("round %d closing on quorum: %d/%d uploads, missing %s",
                       round_idx, received, len(cohort), missing)
        # no receive loop wraps the timer thread: a failure here must fail
        # the federation, not vanish into threading's excepthook
        try:
            self._finish_round(missing)
        except BaseException as e:  # noqa: BLE001 - surfaced through handler_error
            logger.exception("round advance failed on the deadline path")
            self._abort_federation(f"round advance failed after quorum close: {e!r}")

    def _abort_federation(self, reason: str) -> None:
        """An unrecoverable stall becomes a loud failure: ``handler_error``
        (which the in-process harness and any supervisor watch) and a
        stopped receive loop."""
        logger.error("aborting federation: %s", reason)
        self._resilience_event("federation_aborted", reason=reason,
                               counter="resilience/aborts")
        err = RuntimeError(reason)
        flight_recorder.get_flight_recorder().dump(reason="federation_abort", exc=err)
        with self._round_lock:
            self.handler_error = err
        self.com_manager.stop_receive_message()

    def _finish_round(self, missing_clients: List[int]) -> None:
        """Evict the clients that missed the round, then aggregate — in a
        masked round with dropouts after the seed-reveal recovery (the
        evicted clients' half-cancelled masks must go first)."""
        reg = get_registry()
        if missing_clients:
            reg.counter("resilience/quorum_rounds").inc()
            for cid in missing_clients:
                if self.liveness.evict(cid):
                    self._resilience_event("evicted", client=cid, round=self.args.round_idx,
                                           counter="resilience/clients_evicted")
        if (self._secagg is not None and missing_clients
                and not self._secagg.recovery_complete()):
            self._secagg_start_recovery(missing_clients)
            return
        self._complete_round()

    # -- secagg dropout recovery ----------------------------------------------
    def _secagg_start_recovery(self, missing_clients: List[int]) -> None:
        """Ask every survivor for the pair seeds it shared with the evicted
        clients: one extra round trip. The round aggregates when the reveals
        are complete or the bounded recovery deadline gives up."""
        with self._round_lock:
            cohort = list(self.client_id_list_in_this_round or [])
        survivors = [c for c in cohort if c not in set(missing_clients)]
        ask = self._secagg.begin_recovery(survivors, missing_clients)
        need = max(2, quorum_size(len(cohort), self.resilience.round_quorum))
        if len(ask) < need:
            self._abort_federation(
                f"secagg round {self.args.round_idx} unrecoverable: {len(ask)} survivors "
                f"< {need} (quorum floor; privacy floor is 2 — a lone survivor's upload "
                "would unmask)")
            return
        self._resilience_event("secagg_recovery", round=self.args.round_idx,
                               evicted=list(self._secagg.evicted), survivors=ask,
                               wave=self._secagg.recovery_waves,
                               counter="resilience/quorum_recoveries")
        logger.warning("secagg round %s recovery wave %d: evicted %s, asking %s",
                       self.args.round_idx, self._secagg.recovery_waves,
                       self._secagg.evicted, ask)
        self._send_recover_requests(ask)
        self._recovery_deadline.arm(int(self.args.round_idx), self._recovery_timeout_s())

    def _recovery_timeout_s(self) -> float:
        t = getattr(self.args, "secagg_recovery_timeout_s", None)
        if t:
            return float(t)
        return self.resilience.round_deadline_s or 30.0

    def _send_recover_requests(self, survivors: List[int]) -> None:
        for s in survivors:
            m = Message(SecAggMessage.MSG_TYPE_S2C_SECAGG_RECOVER, self.get_sender_id(), s)
            m.add_params(SecAggMessage.MSG_ARG_KEY_SECAGG_EVICTED,
                         list(self._secagg.evicted))
            m.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.args.round_idx))
            self.send_message(m)

    def handle_message_secagg_reveal(self, msg: Message) -> None:
        sa = self._secagg
        if sa is None:
            return
        sender = msg.get_sender_id()
        complete, err = False, None
        with self._round_lock:
            if self._completing:
                return
            try:
                complete = sa.note_reveal(sender,
                                          msg.get(SecAggMessage.MSG_ARG_KEY_SECAGG_REVEAL),
                                          msg.get(MyMessage.MSG_ARG_KEY_ROUND))
            except (TypeError, ValueError) as e:
                err = str(e)
        if err is not None:
            self._resilience_event("secagg_invalid_reveal", client=sender,
                                   round=self.args.round_idx, reason=err,
                                   counter="secagg/invalid_reveals")
            logger.warning("dropping invalid secagg reveal from client %s: %s", sender, err)
            return
        if complete:
            self._recovery_deadline.cancel()
            self._complete_round()

    def _on_recovery_deadline(self, round_idx: int) -> None:
        """Timer thread: a survivor never revealed. It is evicted too (its
        masked upload, with masks nobody can remove, is dropped) and the
        recovery extends to its pairs, bounded by secagg_recovery_rounds;
        then the federation aborts rather than hang or publish a
        mask-polluted aggregate."""
        sa = self._secagg
        if sa is None:
            return
        with self._round_lock:
            # decided and mutated under the round lock: a reveal completing
            # concurrently lands either before (complete → return) or after
            # (the revealer is no longer a survivor: its reveal is rejected)
            if (self._completing or not sa.recovering
                    or int(round_idx) != int(self.args.round_idx)
                    or sa.recovery_complete()):
                return
            pending = sa.pending_reveals()
            cohort = list(self.client_id_list_in_this_round or [])
            exhausted = sa.recovery_waves >= sa.recovery_rounds
            ask: List[int] = []
            if not exhausted:
                for cid in pending:
                    if self.liveness.evict(cid):
                        self._resilience_event("evicted", client=cid, round=round_idx,
                                               counter="resilience/clients_evicted")
                    self.aggregator.drop_client_upload(cohort.index(cid))
                ask = sa.begin_recovery(sa.survivors, set(sa.evicted) | set(pending))
        need = max(2, quorum_size(len(cohort), self.resilience.round_quorum))
        if exhausted or len(ask) < need:
            self._resilience_event("secagg_recovery_failed", round=round_idx,
                                   pending=pending, waves=sa.recovery_waves,
                                   counter="secagg/recovery_failures")
            self._abort_federation(
                f"secagg round {round_idx} mask recovery stuck: survivors {pending} never "
                f"revealed after {sa.recovery_waves} bounded waves" if exhausted else
                f"secagg round {round_idx} below quorum during mask recovery: "
                f"{len(ask)} survivors < {need}")
            return
        logger.warning("secagg recovery wave %d: survivors %s never revealed — evicted, "
                       "re-asking %s", sa.recovery_waves, pending, ask)
        self._send_recover_requests(ask)
        self._recovery_deadline.arm(int(round_idx), self._recovery_timeout_s())

    def _complete_round(self) -> None:
        with self._round_lock:
            if self._completing:
                return
            self._completing = True
        with self.tracer.span(f"round/{self.args.round_idx}/aggregate",
                              n_clients=self.aggregator.n_received()):
            global_params = self.aggregator.aggregate()
        if self._guard is not None:
            # ring 3, first gate: a non-finite aggregate is rejected before
            # anything else sees it
            reason = self._guard.check(global_params)
            if reason is not None:
                self._rollback_round(reason)
                return
        self._health.finish_round(self.args.round_idx)
        self._devstats.sample("aggregate", self.args.round_idx)
        if self._live is not None:
            # the fresh health scores reach /metrics and the online doctor as
            # the round closes, and the round's critical path the tracepath/*
            # gauges; a straggler alert here arms the capture opened below
            try:
                self._live.pump(round_idx=int(self.args.round_idx))
            except Exception:  # noqa: BLE001 - observability never breaks the round
                logger.exception("live telemetry pump failed at round %d",
                                 self.args.round_idx)
        # the trace round boundary: close the capture that bracketed the
        # round that just aggregated, open one for the next if armed
        try:
            tc = get_trace_controller()
            tc.on_round_end(self.args.round_idx)
            if self.args.round_idx + 1 < self.round_num:
                tc.on_round_start(self.args.round_idx + 1)
        except Exception:  # noqa: BLE001 - profiling never breaks the round
            logger.exception("trace controller round hook failed at round %d",
                             self.args.round_idx)
        with self.tracer.span(f"round/{self.args.round_idx}/eval"):
            metrics = self.aggregator.test_on_server_for_all_clients(self.args.round_idx)
        if self._guard is not None:
            # ring 3, second gate: the eval-loss spike
            reason = self._guard.check(None, metrics.get("test_loss"))
            if reason is not None:
                self._rollback_round(reason)
                return
            self._guard.accept(metrics.get("test_loss"))
        self._m_round_ms.observe((time.perf_counter() - self._round_t0) * 1e3)
        mlops.log({"round": self.args.round_idx, **metrics})
        # after ring 3: a rejected round never becomes durable. The journal
        # resets at every commit, so under durability every commit is
        # checkpoint-backed, whatever checkpoint_frequency says
        if self._ckpt is not None and (self._journal is not None
                                       or should_save(self.args, self.args.round_idx)):
            self._ckpt.save(self.args.round_idx,
                            self._round_state(self.args.round_idx + 1, global_params))
        if self._journal is not None:
            self._journal.append("aggregate_committed", durable=False,
                                 round=int(self.args.round_idx))
            self._journal.reset()
        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            # the last close can come from the receive thread (all uploads
            # in) or the timer thread (quorum): the result under the lock
            with self._round_lock:
                self.result = {"rounds": self.round_num, **metrics}
            self._send_finish()
            self._finish_after_final_frames()
            return
        self._select_round_clients()
        self._open_round(global_params, init=False)

    # -- the round state: checkpoints and ring 3's restore point ----------------
    def _round_state(self, next_round: int, global_params=None) -> dict:
        """The packed round state (references: the aggregator and the server
        optimizer replace their trees, never mutate them)."""
        return pack_round_state(
            self.aggregator.get_global_model_params() if global_params is None
            else global_params, self.aggregator.server_opt, next_round)

    def _capture_round_state(self) -> None:
        """Snapshot the round-open state as ring 3's restore point."""
        if self._guard is None:
            return
        state = self._round_state(int(self.args.round_idx))
        with self._round_lock:
            self._pre_round_state = state

    def _rollback_round(self, reason: str) -> None:
        """The aggregated round was rejected: restore the newest checkpoint,
        else the round-open state; quarantine the suspects (ring 1's
        ranking, else the whole cohort, unless that would leave no cohort)
        and re-run the same round index with a fresh cohort; past
        ``max_rollbacks`` consecutive rollbacks the federation aborts
        (parity: fedml_server_manager.py:1117-1190)."""
        round_idx = int(self.args.round_idx)
        try:
            self._guard.record_rollback(round_idx, reason)
        except RollbackBudgetExceeded as e:
            self._abort_federation(str(e))
            return
        state, restored_from = None, None
        if self._ckpt is not None:
            got = self._ckpt.restore_latest(self._round_state(0),
                                            device=self.aggregator.device)
            if got is not None:
                state, restored_from = got[1], f"checkpoint round {got[0]}"
        if state is None and self._pre_round_state is not None:
            state, restored_from = self._pre_round_state, "the round-open state"
        if state is None:
            self._abort_federation(f"round {round_idx} rejected ({reason}) with no "
                                   "state to roll back to")
            return
        self.aggregator.set_global_model_params(state["global_params"])
        apply_round_state(state, self.aggregator.server_opt)
        with self._round_lock:
            cohort = list(self.client_id_list_in_this_round or [])
        suspects = []
        if self._screen is not None:
            suspects = [c for c in self._screen.suspects() if c in cohort]
        if not suspects:
            suspects = cohort
        if self._quarantine is not None:
            pool = self._quarantine.filter_selection(
                [c for c in range(1, self.client_num + 1) if c not in set(suspects)],
                round_idx)
            if pool:
                for cid in suspects:
                    self._quarantine.quarantine(
                        cid, round_idx, f"round {round_idx} rolled back: {reason}")
            else:
                logger.warning("rollback suspects %s cover every remaining client — "
                               "re-running unquarantined (bounded by max_rollbacks)",
                               suspects)
        if self._journal is not None:
            # the rolled-back round's uploads must never be salvaged
            self._journal.append("round_rolled_back", round=round_idx, reason=str(reason),
                                 suspects=[int(c) for c in suspects])
            self._journal.reset()
        logger.warning("round %d rolled back to %s; suspects %s — re-running the round "
                       "with a fresh cohort", round_idx, restored_from, suspects)
        self._select_round_clients()
        self._open_round(self.aggregator.get_global_model_params(), init=False)

    # -- durability: the write-ahead journal and the mid-round replay ---------
    def _journal_round_open(self) -> None:
        """The round's identity, durable before any broadcast leaves: a crash
        at any later instant replays into this round with this cohort."""
        if self._journal is None:
            return
        with self._round_lock:
            cohort = list(self.client_id_list_in_this_round or [])
            silo = dict(self.data_silo_index_of_client or {})
        self._journal.append(
            "round_open", round=int(self.args.round_idx), cohort=[int(c) for c in cohort],
            silo_index={int(k): int(v) for k, v in silo.items()},
            seed=int(getattr(self.args, "random_seed", 0)),
            codec=self._codec.spec if self._codec is not None else None,
            secagg=self._secagg is not None)

    def _journal_upload(self, msg: Message, sender: int, wire) -> None:
        """One admitted upload, as it crossed the wire, fsynced."""
        t0 = time.perf_counter()
        nbytes = self._journal.append(
            "upload_received", round=int(self.args.round_idx), client=int(sender),
            msg_id=msg.get(Message.MSG_ARG_KEY_MSG_ID),
            n_samples=int(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES) or 1),
            local_steps=msg.get("local_steps"), payload=wire)
        reg = get_registry()
        reg.histogram("journal/upload_ms").observe((time.perf_counter() - t0) * 1e3)
        reg.histogram("journal/upload_bytes").observe(nbytes)

    def _resume_salvaged_round(self) -> None:
        """Re-enter the journaled round after a restart (parity:
        fedml_server_manager.py:1262-1331): the salvaged uploads go straight
        into the aggregator (those clients never retrain; a resend of the
        same logical message drops on the primed dedup), and only the clients
        whose uploads died with the old process get the round's broadcast
        again: they retrain the same seeded round, so an identity-codec run
        stays bit-identical. A round that had closed closes again at once."""
        with self._round_lock:
            sal, self._salvaged = self._salvaged, None
        cohort = list(sal.cohort)
        self._round_t0 = time.perf_counter()
        self._capture_round_state()
        with self._round_lock:
            self.client_id_list_in_this_round = cohort
            self.data_silo_index_of_client = dict(sal.silo_index)
            self._round_closed = False
            # a pre-crash quorum close replays as an expired deadline
            self._deadline_expired = sal.closed
            self._deadline_extensions_used = 0
            self._completing = False
            self._screened_out = set()
        # the same params under the same seeded encode key: the delta base
        # matches what the clients decoded before the crash
        payload = self._broadcast_payload(self.aggregator.get_global_model_params())
        for u in sal.uploads:
            mid = u.get("msg_id")
            if mid:
                self._deduper.seen(mid)
            upload = u.get("payload")
            if not isinstance(upload, CompressedTree):
                upload = from_wire_params(upload, self.device)
            self.aggregator.add_local_trained_result(
                cohort.index(int(u["client"])), upload, int(u.get("n_samples") or 1),
                local_steps=u.get("local_steps"))
        reg = get_registry()
        reg.counter("resilience/journal_replays").inc()
        reg.counter("resilience/journal_salvaged").inc(len(sal.uploads))
        self._resilience_event("journal_replayed", round=sal.round_idx,
                               salvaged=sorted(sal.uploaded_clients), closed=sal.closed)
        logger.warning("restart: journal replay re-entered round %d mid-flight with %d/%d "
                       "salvaged upload(s)%s", sal.round_idx, len(sal.uploads), len(cohort),
                       " (round already quorum-closed)" if sal.closed else "")
        uploaded = set(sal.uploaded_clients)
        to_broadcast = [c for c in cohort if c not in uploaded]
        if not sal.closed and to_broadcast:
            with self.tracer.span(f"round/{self.args.round_idx}/sync",
                                  n_clients=len(to_broadcast)):
                self._send_round_config(to_broadcast, payload, self._secagg_round_header(),
                                        init=True)
            self._arm_round_deadline()
        with self._round_lock:
            missing = self._try_close_round(cohort)
        if missing is not None:
            self._finish_round(missing)

    # -- resilience -----------------------------------------------------------
    def _probe_evicted(self, client_ids: List[int]) -> None:
        """Status probes to evicted peers, off-thread and failure-tolerant:
        the round must not stall on the clients it is probing for."""

        def probe() -> None:
            for cid in client_ids:
                try:
                    self.send_message(Message(MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                              self.get_sender_id(), cid))
                except OSError:
                    logger.debug("probe to evicted client %s failed", cid, exc_info=True)

        threading.Thread(target=probe, name="evicted-probe", daemon=True).start()

    def _arm_round_deadline(self) -> None:
        cfg = self.resilience
        if not cfg.deadline_enabled:
            return
        timeout = cfg.round_deadline_s
        if cfg.deadline_adaptive:
            # no history → the static ceiling, so a cold first round never
            # fires early
            timeout = adaptive_deadline_s(self._health.snapshot()["latency_ewma_s"],
                                          cfg.deadline_multiplier,
                                          cfg.deadline_grace_s, cfg.deadline_min_s,
                                          cfg.round_deadline_s)
        self._deadline.arm(int(self.args.round_idx), timeout)

    def _readmit_client(self, client_id: int) -> None:
        """An evicted client reconnected: re-sync it with the current round
        and model (uncompressed, so the in-flight round's delta base stays),
        marked as a rejoin so it resets its error feedback. It re-enters the
        cohort at the next selection."""
        if not self.liveness.readmit(client_id):
            return
        self._resilience_event("rejoined", client=client_id, round=self.args.round_idx,
                               counter="resilience/clients_rejoined")
        logger.info("client %s rejoined at round %s", client_id, self.args.round_idx)
        m = Message(MyMessage.MSG_TYPE_S2C_REJOIN_SYNC, self.get_sender_id(), client_id)
        m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                     to_wire_params(self.aggregator.get_global_model_params()))
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.args.round_idx))
        m.add_params(Message.MSG_ARG_KEY_REJOIN, True)
        if self._codec is not None:
            m.add_params(Message.MSG_ARG_KEY_COMPRESSION, self._codec.spec)
        self.send_message(m)

    def _resilience_event(self, event: str, counter: Optional[str] = None,
                          **fields) -> None:
        """One resilience event, landed everywhere the doctor looks: its
        ``resilience/*`` (or ``secagg/*``, ``integrity/*``) counter, a
        ``resilience_event`` record in ``health.jsonl`` and the flight
        recorder."""
        if counter:
            get_registry().counter(counter).inc()
        try:
            log_health_event({"kind": "resilience_event", "event": event, **fields})
        except OSError:  # observability never breaks the round
            logger.exception("resilience event logging failed")
        flight_recorder.record("resilience_event", event=event, **fields)

    def _observe_client_upload(self, sender: int, msg: Message, model_params) -> None:
        """Feed the health tracker from one admitted upload: its latency from
        the broadcast, its update norm against the round's upload base (off
        the wire arrays for a compressed delta; None for a masked one), and
        the loss and memory of its piggybacked heartbeat. Introspection never
        breaks the round."""
        try:
            sent = self._bcast_ts.get(sender)
            hb = msg.get(Message.MSG_ARG_KEY_HEALTH)
            hb = hb if isinstance(hb, dict) else {}
            self._health.observe(
                sender, self.args.round_idx,
                latency_s=(time.time() - sent) if sent else None,
                update_norm=update_norm(model_params, base=self._screen_base(model_params)),
                train_loss=hb.get("train_loss"), heartbeat=hb or None)
        except Exception:  # noqa: BLE001 - observability never breaks the round
            logger.exception("client health observation failed")

    def _send_finish(self) -> None:
        for client_id in range(1, self.client_num + 1):
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH,
                                      self.get_sender_id(), client_id))

    def _finish_after_final_frames(self) -> None:
        """Finish, once each remote client's final status is in.

        On FINISH a client arms full frames of its metric and span streams
        and sends one last status carrying them; tearing the receive loop
        down first would lose the tail of every remote node's trace and
        leave the collector's totals short. Over LOCAL every rank shares this
        process's registry and tracer: nothing is in flight.
        """
        backend = str(getattr(self.args, "comm_backend", "LOCAL") or "LOCAL").upper()
        if backend == COMM_BACKEND_LOCAL or self._live is None or self.client_num <= 0:
            self.finish()
            return
        grace = float(getattr(self.args, "finish_grace_s", 3.0) or 3.0)
        with self._round_lock:
            self._finishing = True
            self._final_status_pending = set(range(1, self.client_num + 1))
            timer = threading.Timer(grace, self.finish)
            timer.daemon = True
            self._finish_grace_timer = timer
        timer.start()

    def finish(self) -> None:
        with self._round_lock:
            if self._finished_once:
                return
            self._finished_once = True
            if self._finish_grace_timer is not None:
                self._finish_grace_timer.cancel()
        self._deadline.cancel()
        self._recovery_deadline.cancel()
        if self._journal is not None:
            self._journal.close()
        if self._live is not None:
            # the final full loopback frame: the collector's totals become
            # the post-hoc registry's; spans_remote.jsonl lands in the run dir
            self._live.close()
        get_trace_controller().finish()  # never leave a trace recording
        try:
            flush_run()  # spans, a registry snapshot and programs.jsonl
        except OSError:  # observability never breaks shutdown
            logger.exception("telemetry flush failed at finish")
        super().finish()
