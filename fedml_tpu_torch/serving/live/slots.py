"""Double-buffered live model slots — hot-swap weights under traffic.

Counterpart of ``fedml_tpu/serving/live/slots.py`` for plain weights. The
serving engine never reads "the model"; it acquires a lease on the
currently published slot. A new weight generation is staged (the engine's
quantize transform runs here, off the request path) and published by an
atomic pointer flip. Requests that leased the old slot finish on it — a
generation never mixes two rounds' weights — and the old slot's tensors are
dropped only when its lease count drains to zero.

A slot holds a model instance with its weights (an ``nn.Module``).
Staging of compressed aggregates waits for the codec item of the ROADMAP
(A8), the ``serve/*`` spans for the serving slice (A7, on A12a's span
layer).
"""
from __future__ import annotations

import copy
import logging
import threading
from typing import Any, Callable, Optional

from torch import nn

from fedml_tpu_torch.ops.quant import _shallow_module_copy
from fedml_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)


class _Slot:
    """One weight generation: model + round identity + lease refcount."""

    __slots__ = ("params", "round_idx", "refs", "retired", "reclaimed")

    def __init__(self, params: Any, round_idx: Optional[int]):
        self.params = params
        self.round_idx = round_idx
        self.refs = 0
        self.retired = False
        self.reclaimed = threading.Event()


class SlotLease:
    """A refcounted handle on one slot; ``release`` exactly once.

    The weights behind a held lease are stable: the slot is not reclaimed
    until every lease on it is released, even after a newer round is
    published.
    """

    __slots__ = ("_slots", "_slot", "_released")

    def __init__(self, slots: "ModelSlots", slot: _Slot):
        self._slots = slots
        self._slot = slot
        self._released = False

    @property
    def params(self) -> Any:
        return self._slot.params

    @property
    def round_idx(self) -> Optional[int]:
        return self._slot.round_idx

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._slots._release(self._slot)

    def __enter__(self) -> "SlotLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ModelSlots:
    """Atomic-flip holder for the endpoint's live weights.

    The initial weights are a static deployment (round ``None``); the first
    :meth:`publish` makes it live. ``transform`` (optional) runs on every
    staged model — the engine installs its quantization here so published
    weights land in the representation it serves.
    """

    def __init__(self, params: Any,
                 transform: Optional[Callable[[Any], Any]] = None,
                 monitor: Any = None):
        self._lock = threading.Lock()
        self._live = _Slot(params, None)
        self.transform = transform
        self.monitor = monitor
        self.swap_count = 0
        self.stale_drops = 0
        reg = get_registry()
        self._g_round = reg.gauge("serving/round_current")
        self._c_swaps = reg.counter("serving/swaps")
        self._c_stale = reg.counter("serving/swaps_stale")
        self._c_reclaimed = reg.counter("serving/slots_reclaimed")
        self._h_stall = reg.histogram("serving/swap_stall_ms")

    # -- read side (request path) -----------------------------------------
    @property
    def live_params(self) -> Any:
        return self._live.params

    @property
    def live_round(self) -> Optional[int]:
        return self._live.round_idx

    def acquire(self) -> SlotLease:
        with self._lock:
            slot = self._live
            slot.refs += 1
            return SlotLease(self, slot)

    def _release(self, slot: _Slot) -> None:
        with self._lock:
            slot.refs -= 1
            reclaim = slot.retired and slot.refs <= 0
        if reclaim:
            self._reclaim(slot)

    def _reclaim(self, slot: _Slot) -> None:
        # dropping the reference is the reclamation: the caching allocator
        # reuses the old generation's memory once nothing points at it
        slot.params = None
        slot.reclaimed.set()
        self._c_reclaimed.inc()

    # -- write side (publisher thread, off the request path) --------------
    def stage(self, payload: Any) -> Any:
        """Make a published model ready to serve: run the transform.

        The transform may consume (donate) its input, so it runs on a copy
        and the publisher's own model keeps its tensors. A model's copy is
        a new module tree sharing every tensor and quantized weight (a
        donating transform only drops the copy's references, never the
        tensors), so staging copies no weights; other payloads are copied
        deeply.
        """
        if self.transform is None:
            return payload
        if isinstance(payload, nn.Module):
            return self.transform(_shallow_module_copy(payload))
        return self.transform(copy.deepcopy(payload))

    def publish(self, params: Any, round_idx: int) -> bool:
        """Atomic pointer flip to already-staged ``params``.

        Monotonic in ``round_idx``: a duplicate or older round is dropped
        (counted), so resends and reordering never roll the endpoint back.
        """
        round_idx = int(round_idx)
        with self._lock:
            cur = self._live.round_idx
            if cur is not None and round_idx <= cur:
                self.stale_drops += 1
                self._c_stale.inc()
                return False
            old = self._live
            self._live = _Slot(params, round_idx)
            old.retired = True
            reclaim_now = old.refs <= 0
            self.swap_count += 1
        if reclaim_now:
            self._reclaim(old)
        self._g_round.set(float(round_idx))
        self._c_swaps.inc()
        if self.monitor is not None:
            try:
                self.monitor.record_swap(round_idx)
            except Exception:  # pragma: no cover - telemetry must not kill
                logger.exception("swap monitor record failed")
        return True

    def publish_payload(self, payload: Any, round_idx: int) -> bool:
        """Stage then flip — the one call a publisher makes per round."""
        with self._lock:
            cur = self._live.round_idx
        if cur is not None and int(round_idx) <= cur:
            # don't pay staging for a round that cannot win the flip
            self.stale_drops += 1
            self._c_stale.inc()
            return False
        return self.publish(self.stage(payload), round_idx)

    def record_swap_stall(self, round_idx: int, stall_ms: float) -> None:
        """The engine reports the request-visible pause it saw at its first
        step on a freshly published slot (0 when it was idle)."""
        self._h_stall.observe(float(stall_ms))
        if self.monitor is not None:
            try:
                self.monitor.record_swap_stall(round_idx, stall_ms)
            except Exception:  # pragma: no cover
                logger.exception("swap stall record failed")
