"""Client-side error feedback — counterpart of
``fedml_tpu/compression/error_feedback.py``.

EF-SGD (Seide et al. 2014; Karimireddy et al. 2019): a client keeps the
compression error it made this round and adds it into next round's update
before encoding, so the error is re-sent rather than lost. The residual is
one tree per client, kept across rounds, in memory only.
"""
from __future__ import annotations

from typing import Optional

import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.compression.codecs import Codec, CompressedTree
from fedml_tpu_torch.utils.tree import Tree, tree_map


class ErrorFeedback:
    """Per-client residual accumulator wrapping a lossy codec; a lossless
    codec (identity) keeps no state."""

    def __init__(self, codec: Codec):
        self.codec = codec
        self._residual: Optional[Tree] = None

    @property
    def residual(self) -> Optional[Tree]:
        return self._residual

    def reset(self) -> None:
        self._residual = None

    def encode(self, delta: Tree, key: Optional[threefry.Key] = None,
               is_delta: bool = True) -> CompressedTree:
        """Encode ``delta + residual``; keep the new residual for next round."""
        if self.codec.lossless:
            return self.codec.encode(delta, key=key, is_delta=is_delta)
        if self._residual is None:
            self._residual = tree_map(torch.zeros_like, delta)
        ct, self._residual = self.codec.encode(
            delta, key=key, is_delta=is_delta, residual=self._residual)
        return ct
