"""LSTM models — counterparts of ``fedml_tpu/models/nlp/rnn.py``: the
FedAvg paper's Shakespeare next-character model and the StackOverflow
next-word model. The cell matches flax's ``OptimizedLSTMCell`` leaf for
leaf (``models/layers.lstm``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from fedml_tpu_torch.models.layers import Scope, dense, embed, lstm


@dataclass(frozen=True)
class RNNOriginalFedAvg:
    """Embedding(8) → LSTM(256) ×2 → Dense(vocab); Shakespeare charset 90."""

    vocab_size: int = 90
    embedding_dim: int = 8
    hidden_size: int = 256

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        h = embed(s, x, self.vocab_size, self.embedding_dim)
        h = lstm(s, h, self.hidden_size)
        h = lstm(s, h, self.hidden_size)
        return dense(s, h, self.vocab_size)  # [batch, seq, vocab]


@dataclass(frozen=True)
class RNNStackOverflow:
    """Embed(96) → LSTM(670) → Dense(96) → Dense(vocab)."""

    vocab_size: int = 10004
    embedding_dim: int = 96
    hidden_size: int = 670

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        h = embed(s, x, self.vocab_size, self.embedding_dim)
        h = lstm(s, h, self.hidden_size)
        h = dense(s, h, self.embedding_dim)
        return dense(s, h, self.vocab_size)
