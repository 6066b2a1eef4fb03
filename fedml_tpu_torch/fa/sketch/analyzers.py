"""Sketch-domain client analyzers: local data in, CompressedTree out —
counterpart of ``fedml_tpu/fa/sketch/analyzers.py``.

The plaintext analyzers in :mod:`fedml_tpu_torch.fa.analyzer` submit dicts
and lists; these submit an encoded sketch under the round's negotiated spec,
which the server advertises on the analyze-request header and the client
manager pins here (:meth:`SketchClientAnalyzer.set_sketch_spec`): tables of
another geometry or hash seed would not merge. The sketch is built on the
host and encoded on the analyzer's ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from fedml_tpu_torch.compression import derive_key, get_codec
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.fa import constants as C
from fedml_tpu_torch.fa.base_frame import FAClientAnalyzer
from fedml_tpu_torch.fa.sketch.sketches import (
    BloomSketch,
    CountMinSketch,
    CountSketch,
    HistogramSketch,
    VoteVectorSketch,
)

__all__ = ["SketchClientAnalyzer", "create_sketch_analyzer"]

_REGISTRY: Dict[str, type] = {}


def _register(*tasks: str):
    def deco(cls):
        for t in tasks:
            _REGISTRY[t] = cls
        return cls

    return deco


def create_sketch_analyzer(task: str, args: Any = None, spec: str = "",
                           device: DeviceLike = "cuda") -> Optional["SketchClientAnalyzer"]:
    """The sketch analyzer for ``task``, or None when the task has no sketch
    form (``avg`` stays a plaintext scalar pair)."""
    cls = _REGISTRY.get((task or "").strip().lower())
    return None if cls is None else cls(args, spec, device)


class SketchClientAnalyzer(FAClientAnalyzer):
    """Shared shell: spec resolution + sketch encode.

    ``spec`` may arrive as ``auto`` (the task's default family from args) or
    an explicit codec spec; either way the server's round-config header
    overrides it before the first analyze runs.
    """

    def __init__(self, args: Any = None, spec: str = "", device: DeviceLike = "cuda"):
        super().__init__(args, device)
        self.spec = ""
        if spec and spec not in ("auto", "true", "1", "on"):
            self.set_sketch_spec(spec)

    def set_sketch_spec(self, spec: str) -> None:
        self.spec = get_codec(str(spec), self.args).spec  # normalized

    @property
    def codec(self):
        if not self.spec:
            raise ValueError(
                "sketch analyzer has no negotiated spec yet — the "
                "server's analyze request must carry fa_sketch_spec")
        return get_codec(self.spec, self.args)

    def _encode(self, sketch, round_idx: int):
        seed = int(getattr(self.args, "random_seed", 0) or 0)
        leaves = {k: torch.from_numpy(v).to(self.device) for k, v in sketch.leaves().items()}
        return self.codec.encode(leaves, key=derive_key(seed, int(round_idx), int(self.id)))

    @staticmethod
    def _hash_seed(server_state) -> int:
        return int((server_state or {}).get("hash_seed", 0))

    def _build(self, data, server_state, round_idx: int):
        raise NotImplementedError

    def local_analyze(self, data, server_state, round_idx):
        return self._encode(self._build(data, server_state, round_idx), round_idx)


@_register(C.FA_TASK_FREQ)
class FrequencySketchAnalyzer(SketchClientAnalyzer):
    """Local item counts into a count-min (or count) sketch."""

    def _build(self, data, server_state, round_idx):
        codec = self.codec
        cls = CountSketch if codec.name == "csk" else CountMinSketch
        sk = cls(codec.width, codec.depth, self._hash_seed(server_state))
        sk.add(list(data))
        return sk


@_register(C.FA_TASK_UNION, C.FA_TASK_INTERSECTION, C.FA_TASK_CARDINALITY)
class BloomSketchAnalyzer(SketchClientAnalyzer):
    """Distinct local items as a 0/1 Bloom membership vector."""

    def _build(self, data, server_state, round_idx):
        codec = self.codec
        sk = BloomSketch(codec.bits, codec.hashes, self._hash_seed(server_state))
        sk.add(list(data))
        return sk


@_register(C.FA_TASK_HISTOGRAM, C.FA_TASK_K_PERCENTILE)
class HistogramSketchAnalyzer(SketchClientAnalyzer):
    """Fixed-bin counts over the spec's preset range: one round, no
    range-discovery phase (the range rides the negotiated spec)."""

    def _build(self, data, server_state, round_idx):
        codec = self.codec
        sk = HistogramSketch(codec.lo, codec.hi, codec.bins)
        sk.add(data)
        return sk


@_register(C.FA_TASK_HEAVY_HITTER_TRIEHH)
class TrieHHSketchAnalyzer(SketchClientAnalyzer):
    """TrieHH prefix-extension votes into the vote-vector table: the
    plaintext analyzer's trie walk ('$'-terminated words, one level a round,
    votes gated on the server's popular set) with an opaque counter table
    as the ballot box, one that SecAgg can mask."""

    def _build(self, data, server_state, round_idx):
        codec = self.codec
        state = server_state or {}
        sk = VoteVectorSketch(codec.width, codec.depth, self._hash_seed(server_state))
        sk.vote([str(w) for w in data], state.get("popular", ()),
                int(state.get("depth", 1)))
        return sk
