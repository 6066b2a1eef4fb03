"""FA server FSM — counterpart of ``fedml_tpu/fa/fa_server_manager.py``:
handshake → broadcast the analyze request (state and sketch spec) → collect
submissions → close on all or on quorum at the deadline → aggregate →
iterate or finish with the result.

The resilience contract: a round closes on ``round_quorum`` when the
``round_deadline_s`` timer fires (the missing clients named), a straggler's
submission for a closed round is counted and dropped, and a round still
below quorum after its extensions aborts, naming the missing clients. In
sketch mode the analyze request carries the negotiated spec on the
round-config header, and with ``fa_screen`` the submissions pass the
integrity screen's ring 1 in the compressed domain before the fused merge.

Counters keep the reference's ``fa/*`` names, the task in the labels. The
reference's ``mlops`` round events (abort, quorum close, result) belong to
the MLOps facades of the telemetry stack (ROADMAP A12) and are left out, as
the port's cross-silo server leaves its own out.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.fa.fa_message_define import FAMessage
from fedml_tpu_torch.resilience import ResilienceConfig, RoundDeadline, quorum_size
from fedml_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)


class FAServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator, comm=None, client_rank: int = 0,
                 client_num: int = 0, backend: str = COMM_BACKEND_LOCAL):
        super().__init__(args, comm, client_rank, client_num + 1, backend,
                         device=aggregator.device)
        self.aggregator = aggregator
        self.client_num = client_num
        self.task = str(getattr(args, "fa_task"))
        self.round_idx = 0
        self.server_state = aggregator.init_state()
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self.submissions: Dict[int, Any] = {}
        self.result: Optional[dict] = None
        # sketch mode: the aggregator owns the negotiated spec; the
        # analyze-request header advertises it to every client
        self.sketch_spec: Optional[str] = getattr(aggregator, "sketch_spec", None)
        # deadline + quorum round close (0 = wait for every client); the
        # deadline fires on a timer thread, so every round transition holds
        # the (reentrant: a close re-arms the next deadline) lock
        self.resilience = ResilienceConfig(args)
        self._deadline = RoundDeadline(self._on_round_deadline)
        self._extensions_used = 0
        self._round_lock = threading.RLock()
        # integrity ring 1 on the compressed domain: screen sketch
        # submissions at admission, before the fused merge
        self._screen = None
        if self.sketch_spec and bool(getattr(args, "fa_screen", False)):
            from fedml_tpu_torch.integrity import UpdateScreen

            self._screen = UpdateScreen()

    def _counter(self, name: str):
        return get_registry().counter(name, labels={"task": self.task})

    # -- handshake ---------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        M = FAMessage
        self.register_message_receive_handler(
            M.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_client_status)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_SUBMIT, self.handle_submission)

    def handle_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            return
        M = FAMessage
        for cid in range(1, self.client_num + 1):
            self.send_message(Message(
                M.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, self.get_sender_id(), cid))

    def handle_client_status(self, msg: Message) -> None:
        M = FAMessage
        if msg.get(M.MSG_ARG_KEY_CLIENT_STATUS) == M.MSG_CLIENT_STATUS_IDLE:
            self.client_online_status[msg.get_sender_id()] = True
        if not self.is_initialized and all(
                self.client_online_status.get(c, False)
                for c in range(1, self.client_num + 1)):
            self.is_initialized = True
            self._broadcast_request()

    # -- round open --------------------------------------------------------
    def _broadcast_request(self) -> None:
        M = FAMessage
        for cid in range(1, self.client_num + 1):
            m = Message(M.MSG_TYPE_S2C_ANALYZE_REQUEST, self.get_sender_id(), cid)
            m.add_params(M.MSG_ARG_KEY_FA_TASK, self.task)
            m.add_params(M.MSG_ARG_KEY_SERVER_STATE, self.server_state)
            m.add_params(M.MSG_ARG_KEY_CLIENT_INDEX, cid - 1)
            m.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
            if self.sketch_spec:
                m.add_params(M.MSG_ARG_KEY_SKETCH_SPEC, self.sketch_spec)
            self.send_message(m)
        self._arm_deadline()

    def _arm_deadline(self) -> None:
        if self.resilience.round_deadline_s > 0:
            with self._round_lock:
                self._extensions_used = 0
                self._deadline.arm(self.round_idx, self.resilience.round_deadline_s)

    # -- submissions -------------------------------------------------------
    def handle_submission(self, msg: Message) -> None:
        M = FAMessage
        sender = msg.get_sender_id()
        with self._round_lock:
            msg_round = int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx))
            if msg_round != self.round_idx:
                # a straggler's upload for an already-closed round: counted
                # and dropped, never aggregated twice
                self._counter("fa/stale_submissions").inc()
                logger.warning(
                    "FA round %d: dropping stale submission from client %s (for "
                    "round %d)", self.round_idx, sender, msg_round)
                return
            submission = msg.get(M.MSG_ARG_KEY_SUBMISSION)
            if self._screen is not None:
                reason = self._screen.admit(sender, msg_round, submission)
                if reason is not None:
                    self._counter("fa/screened").inc()
                    logger.warning("FA round %d: screened out client %s (%s)",
                                   msg_round, sender, reason)
                    return
            self.submissions[sender] = submission
            if len(self.submissions) < self.client_num:
                return
            self._close_round(quorum_close=False)

    def _on_round_deadline(self, round_idx: int) -> None:
        with self._round_lock:
            if round_idx != self.round_idx or self.result is not None:
                return  # stale fire: the round already closed
            self._counter("fa/deadline_fired").inc()
            need = quorum_size(max(1, self.client_num), self.resilience.round_quorum)
            if len(self.submissions) >= need:
                self._close_round(quorum_close=True)
                return
            if self._extensions_used < self.resilience.deadline_extensions:
                self._extensions_used += 1
                logger.warning(
                    "FA round %d below quorum at deadline (%d/%d, need %d) — "
                    "extension %d/%d", round_idx, len(self.submissions),
                    self.client_num, need, self._extensions_used,
                    self.resilience.deadline_extensions)
                self._deadline.arm(self.round_idx, self.resilience.round_deadline_s)
                return
            self._counter("fa/aborts").inc()
            missing = sorted(set(range(1, self.client_num + 1)) - set(self.submissions))
            err = RuntimeError(
                f"FA round {round_idx} aborted below quorum: "
                f"{len(self.submissions)}/{self.client_num} submissions "
                f"(need {need}); missing clients {missing}")
            logger.error("%s", err)
            self.handler_error = err  # the harness fails loudly on this
            self._send_finish_all()
            self.finish()

    # -- round close -------------------------------------------------------
    def _close_round(self, quorum_close: bool) -> None:
        """Aggregate what arrived and advance; the caller holds the lock."""
        self._deadline.cancel()
        missing = sorted(set(range(1, self.client_num + 1)) - set(self.submissions))
        if self._screen is not None:
            # retrospective ring-1 rejections (cohort-relative norms)
            for cid, reason in self._screen.close_round(self.round_idx).items():
                if self.submissions.pop(cid, None) is not None:
                    self._counter("fa/screened").inc()
                    logger.warning("FA round %d: screened out client %s at close (%s)",
                                   self.round_idx, cid, reason)
                    missing.append(cid)
        if quorum_close:
            self._counter("fa/quorum_rounds").inc()
            logger.warning(
                "FA round %d quorum close: %d/%d submissions, missing clients %s",
                self.round_idx, len(self.submissions), self.client_num, sorted(missing))
        subs = sorted(self.submissions.items())
        self.submissions = {}
        state, done, result = self.aggregator.aggregate(subs, self.round_idx)
        self.round_idx += 1
        self._counter("fa/rounds").inc()
        if done:
            self.result = {"task": self.task, "rounds": self.round_idx, **result}
            if self.sketch_spec:
                self.result.setdefault("sketch_spec", self.sketch_spec)
            self._send_finish_all()
            self.finish()
            return
        self.server_state = state
        self._broadcast_request()

    def _send_finish_all(self) -> None:
        M = FAMessage
        for cid in range(1, self.client_num + 1):
            self.send_message(Message(M.MSG_TYPE_S2C_FINISH, self.get_sender_id(), cid))

    def finish(self) -> None:
        self._deadline.cancel()
        super().finish()
