"""Round-state checkpoints for the port's engines — counterpart of
``fedml_tpu/core/checkpoint.py``.

Every engine can persist {global params, server-optimizer state, DP noise
counters, next round, engine extras} after a round and resume from it:
the engines derive every per-round draw (client sampling, shuffling, noise
keys) from ``random_seed × round × client``, so these are the whole state.

The reference writes orbax, which the card's machine does not have, and
neither has it safetensors. One round here is a directory ``round_{k}``
holding

* ``state.pt``: a ``torch.save`` of one flat ``{key: tensor}`` dict of CPU
  tensors, in the reference's layout, keyed by the reference's
  ``/``-joined tree paths (``global_params/params/Dense_0/kernel``,
  ``server_opt/0/mu/params/...``, ``dp_counter``), so a port checkpoint
  and the reference's orbax checkpoint of the same state hold the same
  keys and values;
* ``manifest.json``: the format version, the round, and each key's dtype
  and shape.

A save goes to a staging directory (``round_{k}.tmp-*``), flushed, then
``os.replace``d into place. A read is ``torch.load(weights_only=True)``:
tensors only, no pickled objects. Enable with::

    train_args:
      checkpoint_dir: ./ckpts
      checkpoint_frequency: 1        # rounds between saves
      checkpoint_keep: 3             # rounds kept on disk
      resume: true                   # pick up the latest round state
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import uuid
from typing import Any, Dict, Optional, Tuple

import torch

from fedml_tpu_torch.models.convert import from_reference_layout, to_reference_layout
from fedml_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1
STATE_FILE = "state.pt"
MANIFEST_FILE = "manifest.json"
_ROUND_RE = re.compile(r"^round_(\d+)$")

Flat = Dict[str, torch.Tensor]


# -- nested state <-> one flat dict -----------------------------------------

def flatten_state(state: Dict[str, Any], prefix: str = "") -> Flat:
    """A nested dict of tensors and ints → ``{"a/b/c": tensor}``; ints
    become 0-d int32 tensors (the reference saves its counters so)."""
    out: Flat = {}
    for key, val in state.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten_state(val, path))
        elif isinstance(val, torch.Tensor):
            out[path] = val
        else:
            out[path] = torch.tensor(int(val), dtype=torch.int32)
    return out


def unflatten_like(flat: Flat, template: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`flatten_state`, shaped by ``template``: every
    leaf of the template must be in ``flat`` with the template's shape."""
    out: Dict[str, Any] = {}
    for key, val in template.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out[key] = unflatten_like(flat, val, path)
            continue
        if path not in flat:
            raise KeyError(f"checkpoint has no {path!r}")
        got = flat[path]
        want = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
        if tuple(got.shape) != want:
            raise ValueError(f"{path}: checkpoint shape {tuple(got.shape)} != {want}")
        out[key] = got
    return out


# -- one round directory ------------------------------------------------------

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_round_dir(path: str, flat: Flat, round_idx: int) -> int:
    """Write ``flat`` as the round directory ``path`` through a staging
    directory beside it; an existing ``path`` is replaced. Returns the bytes
    of the state file."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    cpu = {k: v.detach().to("cpu").contiguous() for k, v in flat.items()}
    staging = f"{path}.tmp-{uuid.uuid4().hex[:12]}"
    os.makedirs(staging)
    try:
        state_path = os.path.join(staging, STATE_FILE)
        with open(state_path, "wb") as f:
            torch.save(cpu, f)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"format": FORMAT_VERSION, "round": int(round_idx),
                    "keys": {k: {"dtype": str(v.dtype).removeprefix("torch."),
                                 "shape": list(v.shape)} for k, v in cpu.items()}}
        with open(os.path.join(staging, MANIFEST_FILE), "w") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(staging)
        nbytes = os.path.getsize(state_path)
        old = None
        if os.path.exists(path):  # a save of the same round replaces it
            old = f"{path}.tmp-old-{uuid.uuid4().hex[:12]}"
            os.replace(path, old)
        os.replace(staging, path)
        _fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        return nbytes
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise


def read_round_dir(path: str, device: Any = "cpu") -> Flat:
    """Read a round directory: its manifest's keys, dtypes and shapes must
    match the state file (a half-written or foreign directory raises)."""
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {manifest.get('format')!r}, "
                         f"this reader knows {FORMAT_VERSION}")
    flat = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)
    if not isinstance(flat, dict) or set(flat) != set(manifest["keys"]):
        raise ValueError(f"{path}: the state file's keys disagree with its manifest")
    for k, meta in manifest["keys"].items():
        t = flat[k]
        if (not isinstance(t, torch.Tensor) or list(t.shape) != meta["shape"]
                or str(t.dtype).removeprefix("torch.") != meta["dtype"]):
            raise ValueError(f"{path}: {k!r} disagrees with its manifest entry {meta}")
    return flat


class RoundCheckpointer:
    """Saves one engine state per round under ``<dir>/round_<idx>``, keeping
    the newest ``keep``; a state's kernels go to the reference's layout
    (``models/convert.to_reference_layout``, by the key's last part) and
    come back. The LLM trainer's adapter checkpoints need no layout switch
    and write one round directory themselves (``write_round_dir``)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = os.path.abspath(ckpt_dir)
        self.keep = int(keep)
        self.last_save_bytes = 0
        os.makedirs(self.dir, exist_ok=True)

    def round_path(self, round_idx: int) -> str:
        return os.path.join(self.dir, f"round_{int(round_idx)}")

    # -- save -----------------------------------------------------------------
    def save(self, round_idx: int, state: Dict[str, Any]) -> str:
        path = self.round_path(round_idx)
        self.last_save_bytes = write_round_dir(
            path, to_reference_layout(flatten_state(state)), round_idx)
        self._prune()
        return path

    def _prune(self) -> None:
        rounds = self.saved_rounds()
        for r in rounds[: max(0, len(rounds) - self.keep)]:
            shutil.rmtree(self.round_path(r), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def saved_rounds(self):
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            m = _ROUND_RE.match(name)
            if m and os.path.isdir(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_round(self) -> Optional[int]:
        rounds = self.saved_rounds()
        return rounds[-1] if rounds else None

    def restore(self, round_idx: int, template: Dict[str, Any],
                device: Any = "cpu") -> Dict[str, Any]:
        """Round ``round_idx`` shaped like ``template`` (a packed state),
        in the port's layout, on ``device``."""
        flat = from_reference_layout(read_round_dir(self.round_path(round_idx), device))
        # the DP streams are the ones the saving process had opened, which
        # a fresh process has not: they come as saved
        state = unflatten_like(flat, {k: v for k, v in template.items()
                                      if k != "dp_streams"})
        streams = {k.split("/", 1)[1]: v for k, v in flat.items()
                   if k.startswith("dp_streams/")}
        if streams:
            state["dp_streams"] = streams
        return state

    def restore_latest(self, template: Dict[str, Any], device: Any = "cpu"
                       ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Restore the newest restorable round. A crash mid-save leaves a
        staging directory (removed here) and, on a filesystem without
        atomic renames, a half-written newest round: the walk then falls
        back to the round before it, and prunes the broken one only once
        an older round restored against the same template (a template that
        fits no round is a changed model, not crash damage)."""
        self._prune_orphaned_tmp()
        rounds = sorted(self.saved_rounds(), reverse=True)
        failed_round: Optional[int] = None
        for i, r in enumerate(rounds):
            try:
                state = self.restore(r, template, device)
            except Exception as e:  # noqa: BLE001 - any unreadable round
                if i > 0:
                    # saves are sequential: a crash damages the newest round
                    # only, so a second failure is a template mismatch
                    raise
                failed_round = r
                logger.warning("round checkpoint %d is unrestorable (%s: %s) — "
                               "falling back to the previous round", r,
                               type(e).__name__, e)
                continue
            if failed_round is not None:
                get_registry().counter("resilience/checkpoints_pruned").inc()
                logger.warning("pruning half-written round checkpoint %d (round %d "
                               "restored cleanly against the same template)",
                               failed_round, r)
                shutil.rmtree(self.round_path(failed_round), ignore_errors=True)
            logger.info("resumed round checkpoint %d from %s", r, self.dir)
            return r, state
        if failed_round is not None:
            logger.error("no restorable round checkpoint under %s (round %d kept on "
                         "disk unrestorable — half-written first save, or a changed "
                         "model template)", self.dir, failed_round)
        return None

    def _prune_orphaned_tmp(self) -> None:
        """Remove the staging directories a crash mid-save left behind (and
        the reference's orbax staging names): never restorable."""
        if not os.path.isdir(self.dir):
            return
        for name in os.listdir(self.dir):
            if "orbax-checkpoint-tmp" in name or ".tmp" in name:
                path = os.path.join(self.dir, name)
                logger.warning("pruning orphaned checkpoint staging dir %s "
                               "(crash mid-save)", path)
                shutil.rmtree(path, ignore_errors=True)


# -- the shared state contract ------------------------------------------------

def dp_counters() -> Tuple[int, Dict[str, int]]:
    """The DP singleton's release counters: the process stream's, and every
    other live stream's (in-process silos, by rank)."""
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )

    counters = FedMLDifferentialPrivacy.get_instance().counters()
    default = counters.pop(None, 0)
    return default, {str(k): v for k, v in counters.items()}


def pack_round_state(global_params: Dict[str, torch.Tensor], server_opt: Any = None,
                     next_round: int = 0, extra: Optional[Dict[str, Any]] = None,
                     dp_counter: Optional[int] = None) -> Dict[str, Any]:
    """The state every engine saves: global params, the server optimizer's
    state, the DP counter, the next round, plus engine extras (the sp
    engine's SCAFFOLD/Mime trees). The process stream's counter is
    ``dp_counter`` (the reference keeps only that one); the port's other
    live streams go under ``dp_streams/<rank>``."""
    default, streams = dp_counters()
    state: Dict[str, Any] = {
        "global_params": global_params,
        "server_opt": server_opt.get_state(global_params) if server_opt is not None else {},
        "dp_counter": default if dp_counter is None else int(dp_counter),
        "next_round": int(next_round),
    }
    if streams:
        state["dp_streams"] = streams
    if extra:
        state.update(extra)
    return state


def apply_round_state(state: Dict[str, Any], server_opt: Any = None) -> int:
    """Restore the shared fields (server optimizer, DP counters); returns
    the next round. ``state['global_params']`` and the engine extras are
    the caller's."""
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )

    if server_opt is not None:
        server_opt.set_state(state["server_opt"])
    counters = {None: int(state["dp_counter"])}
    counters.update({int(k): int(v) for k, v in state.get("dp_streams", {}).items()})
    FedMLDifferentialPrivacy.get_instance().set_counters(counters)
    return int(state["next_round"])


def engine_checkpointer(args: Any) -> Optional[RoundCheckpointer]:
    ckpt_dir = getattr(args, "checkpoint_dir", None)
    if not ckpt_dir:
        return None
    return RoundCheckpointer(ckpt_dir, keep=int(getattr(args, "checkpoint_keep", 3)))


def should_save(args: Any, round_idx: int) -> bool:
    freq = int(getattr(args, "checkpoint_frequency", 1) or 1)
    return round_idx % max(freq, 1) == 0


__all__ = ["RoundCheckpointer", "apply_round_state", "engine_checkpointer",
           "flatten_state", "pack_round_state", "read_round_dir", "should_save",
           "unflatten_like", "write_round_dir"]
