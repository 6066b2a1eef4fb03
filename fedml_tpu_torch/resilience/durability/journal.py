"""Write-ahead round journal — counterpart of
``fedml_tpu/resilience/durability/journal.py``.

The round checkpoints (``core/checkpoint``) make round boundaries durable;
this journal makes the inside of a round durable. The server appends one
record per round-state transition to an append-only, fsynced, CRC-framed
file beside the checkpoints:

- ``round_open``          — cohort, silo map, seed, codec spec, secagg flag
- ``upload_received``     — client id, msg_id, and the upload as it crossed
  the wire (a delta-encoded ``CompressedTree`` journals as its int8 blocks
  and scales, so a record costs about the wire size, not the f32 size)
- ``quorum_close``        — the round closed on quorum; missing positions
- ``aggregate_committed`` — the aggregate landed in a durable checkpoint;
  every earlier record is obsolete and the journal resets
- ``round_rolled_back``   — the integrity layer rejected the round; its
  uploads must never be salvaged, so the record is terminal like a commit

A killed server replays the journal at restart (:func:`salvage_round`) and
re-enters the interrupted round: salvaged uploads go back into the
aggregator (those clients never retrain; a late duplicate delivery drops
on the msg-id dedup), and only the rest of the cohort is re-broadcast.
Masked (secagg) rounds are journaled but not resumable: the pairwise masks
die with the session, so replay drops them to the last round boundary.

Framing (little-endian), the reference's byte for byte::

    record := b"RJ" | len(u32, payload bytes) | crc32(u32, of payload) | payload

``payload`` is :func:`~fedml_tpu_torch.utils.serialization.safe_dumps` of
the record dict — the reference's pickle-free wire format, so a journal
written by either package reads in the other. A torn tail (short header,
short payload, or a CRC mismatch from a crash mid-append) truncates the
file at the last valid record instead of failing the replay. Card tensors
reach host bytes through ``safe_dumps``'s one pinned staging buffer.
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.serialization import safe_dumps, safe_loads

logger = logging.getLogger(__name__)

__all__ = ["RoundJournal", "SalvagedRound", "journal_from_args",
           "parse_frames", "salvage_round", "scan_open_round"]

_MAGIC = b"RJ"
_HEADER = struct.Struct("<2sII")  # magic, payload length, crc32


def parse_frames(data: bytes, device: DeviceLike = "cpu") -> Tuple[List[Dict], int]:
    """``(records, valid_end)``: a scan of the RJ frame stream that changes
    nothing. It stops at a torn header, a short payload or a CRC hole;
    ``valid_end`` is the byte offset after the last valid record. Arrays
    come back as tensors on ``device``."""
    out: List[Dict] = []
    offset = 0
    valid_end = 0
    while offset + _HEADER.size <= len(data):
        magic, length, crc = _HEADER.unpack_from(data, offset)
        body_start = offset + _HEADER.size
        if magic != _MAGIC or body_start + length > len(data):
            break  # torn header or short payload
        payload = data[body_start:body_start + length]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break  # a corrupt record: stop at the last good frame
        try:
            rec = safe_loads(payload, device)
        except ValueError:
            break
        if not isinstance(rec, dict):
            break
        out.append(rec)
        offset = body_start + length
        valid_end = offset
    return out, valid_end


class RoundJournal:
    """Append-only, fsynced, CRC-framed record log.

    Appends come from the comm thread and the deadline's timer thread;
    every file mutation happens under ``_lock``. ``fsync=False`` drops the
    per-record sync (for measuring the seam without it).
    """

    def __init__(self, path: str, fsync: bool = True):
        self.path = os.path.abspath(path)
        self.fsync = bool(fsync)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "ab")
        reg = get_registry()
        self._m_records = reg.counter("resilience/journal_records")
        self._m_bytes = reg.counter("resilience/journal_bytes")

    # -- write path -------------------------------------------------------------
    def append(self, kind: str, durable: bool = True, **fields: Any) -> int:
        """Append one record and return its frame's bytes; with ``durable``
        (the default) it returns only once the bytes are on disk (write,
        flush, fdatasync), so a crash at any later instant replays it.

        ``durable=False`` skips the sync for a record whose loss the replay
        re-derives: a lost ``quorum_close`` or ``aggregate_committed`` just
        re-enters the round with its (durable) uploads and closes it again.
        The next durable append syncs it anyway (fdatasync is whole-file).
        """
        payload = safe_dumps({"kind": str(kind), **fields})
        frame = _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        with self._lock:
            self._fh.write(frame)
            self._fh.flush()
            if self.fsync and durable:
                self._sync()
        self._m_records.inc()
        self._m_bytes.inc(len(frame))
        return len(frame)

    def _sync(self) -> None:
        # an append-only log needs its data durable, not every timestamp
        fileno = self._fh.fileno()
        if hasattr(os, "fdatasync"):
            os.fdatasync(fileno)
        else:  # pragma: no cover - non-POSIX
            os.fsync(fileno)

    def reset(self) -> None:
        """Truncate to empty, once a round's aggregate is checkpointed.

        Not synced on purpose: if the truncate is lost to a crash, the
        replay sees a round the checkpoint already covers and drops it
        (``salvage_round``'s expected-round check)."""
        with self._lock:
            self._fh.truncate(0)
            self._fh.seek(0)
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:  # pragma: no cover - double close
                pass

    @property
    def nbytes(self) -> int:
        with self._lock:
            self._fh.flush()
            return os.path.getsize(self.path)

    # -- read path --------------------------------------------------------------
    def records(self, device: DeviceLike = "cpu") -> List[Dict]:
        """Every valid record, oldest first, arrays as tensors on
        ``device``. A torn tail (the crash artifact of a kill mid-append)
        is truncated at the last valid record, so the next append continues
        a clean file; a corrupt record drops itself and all after it."""
        with self._lock:
            self._fh.flush()
            with open(self.path, "rb") as f:
                data = f.read()
            out, valid_end = parse_frames(data, device)
            if valid_end < len(data):
                get_registry().counter("resilience/journal_truncations").inc()
                logger.warning("round journal %s has a torn tail: truncating %d byte(s) "
                               "after the last valid record", self.path,
                               len(data) - valid_end)
                self._fh.truncate(valid_end)
                self._fh.seek(valid_end)
                self._fh.flush()
                if self.fsync:
                    self._sync()
            return out


class SalvagedRound:
    """What the journal says about the round the crash interrupted."""

    __slots__ = ("round_idx", "cohort", "silo_index", "uploads", "closed",
                 "missing", "secagg")

    def __init__(self, round_idx: int, cohort: List[int], silo_index: Dict[int, int],
                 uploads: List[Dict], closed: bool, missing: List[int], secagg: bool):
        self.round_idx = int(round_idx)
        self.cohort = [int(c) for c in cohort]
        self.silo_index = {int(k): int(v) for k, v in silo_index.items()}
        self.uploads = list(uploads)          # the upload_received records
        self.closed = bool(closed)            # a quorum_close was journaled
        self.missing = [int(m) for m in missing]
        self.secagg = bool(secagg)

    @property
    def uploaded_clients(self) -> List[int]:
        return [int(u["client"]) for u in self.uploads]


def scan_open_round(records: List[Dict],
                    terminal_kinds: tuple = ("aggregate_committed", "round_rolled_back"),
                    note_kinds: tuple = ("quorum_close",)) -> tuple:
    """The one replay state machine every consumer shares: the latest
    ``round_open`` wins and resets the accumulation, records are scoped to
    the open round, a terminal kind closes it (nothing to salvage), and
    note kinds are collected beside the uploads. Returns ``(open_rec,
    uploads, notes)``, ``open_rec`` None when no round is open."""
    open_rec: Optional[Dict] = None
    uploads: List[Dict] = []
    notes: List[Dict] = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "round_open":
            open_rec = rec
            uploads = []
            notes = []
        elif open_rec is None:
            continue
        elif int(rec.get("round", -1)) != int(open_rec["round"]):
            continue
        elif kind == "upload_received":
            uploads.append(rec)
        elif kind in note_kinds:
            notes.append(rec)
        elif kind in terminal_kinds:
            open_rec = None
    if open_rec is None:
        return None, [], []
    return open_rec, uploads, notes


def salvage_round(records: List[Dict], expected_round: int) -> Optional[SalvagedRound]:
    """The open (uncommitted) round of a journal scan, or None when there is
    nothing to salvage: an empty journal, only committed rounds, or an open
    round other than ``expected_round`` (a crash between the checkpoint
    save and the journal reset: the checkpoint covers those records)."""
    open_rec, uploads, notes = scan_open_round(records)
    closes = [n for n in notes if n.get("kind") == "quorum_close"]
    missing = [int(m) for m in closes[-1].get("missing") or []] if closes else []
    if open_rec is None:
        return None
    if int(open_rec["round"]) != int(expected_round):
        logger.warning("journal holds round %s but the checkpoint resumes at round %s — "
                       "stale records dropped (crash between checkpoint save and journal "
                       "reset)", open_rec["round"], expected_round)
        return None
    return SalvagedRound(round_idx=int(open_rec["round"]),
                         cohort=open_rec.get("cohort") or [],
                         silo_index=open_rec.get("silo_index") or {},
                         uploads=uploads, closed=bool(closes), missing=missing,
                         secagg=bool(open_rec.get("secagg")))


def journal_from_args(args: Any, name: str = "server_round") -> Optional[RoundJournal]:
    """The engines' constructor hook: a journal beside the checkpoints,
    ``<checkpoint_dir>/<name>.journal``, when ``durability: true``, else
    None. Durability without ``checkpoint_dir`` is refused: a mid-round
    replay is only meaningful against a durable round boundary."""
    if not bool(getattr(args, "durability", False)):
        return None
    ckpt_dir = getattr(args, "checkpoint_dir", None)
    if not ckpt_dir:
        raise ValueError("durability: true needs checkpoint_dir — the round journal "
                         "replays relative to the last durable round boundary")
    return RoundJournal(os.path.join(str(ckpt_dir), f"{name}.journal"),
                        fsync=bool(getattr(args, "journal_fsync", True)))
