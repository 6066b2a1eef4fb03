"""Dataset loaders — counterpart of ``fedml_tpu/data/data_loader.py``.

Only the causal-LM loader of the training slice is ported so far:
:func:`load_synthetic_lm` draws the same arrays as the reference's for the
same arguments (same generator, same draws, same order).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from fedml_tpu_torch.data.dataset import FederatedDataset


def load_synthetic_lm(args: Any) -> FederatedDataset:
    """Causal-LM token streams for the LLM path.

    An order-1 Markov token stream with a banded transition matrix (token t
    mostly moves to t+1 or t+2 mod V, 5% uniform noise): enough structure
    that per-round eval loss falls measurably. Samples are
    (x, y) = (tokens[:-1], tokens[1:]) of shape [T]; the train set is split
    into ``client_num_in_total`` contiguous shards.
    """
    seq_len = int(getattr(args, "max_seq_length", getattr(args, "seq_len", 128)))
    vocab = int(getattr(args, "vocab_size", 256))
    n_train = int(getattr(args, "train_size", 512))
    n_test = int(getattr(args, "test_size", 64))
    seed = int(getattr(args, "random_seed", 0))
    rng = np.random.default_rng(seed + 77)

    def gen(n):
        toks = np.zeros((n, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=n)
        step = rng.choice([1, 2], p=[0.8, 0.2], size=(n, seq_len))
        noise = rng.random((n, seq_len)) < 0.05
        rand_tok = rng.integers(0, vocab, size=(n, seq_len))
        for t in range(seq_len):
            nxt = (toks[:, t] + step[:, t]) % vocab
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return toks[:, :-1], toks[:, 1:]

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)

    client_num = int(getattr(args, "client_num_in_total", 4))
    bounds = np.linspace(0, n_train, client_num + 1).astype(int)
    train_local = {
        i: (xtr[bounds[i]: bounds[i + 1]], ytr[bounds[i]: bounds[i + 1]])
        for i in range(client_num)
    }
    test_local = {i: (xte, yte) for i in range(client_num)}
    return FederatedDataset(
        train_data_num=n_train,
        test_data_num=n_test,
        train_data_global=(xtr, ytr),
        test_data_global=(xte, yte),
        train_data_local_num_dict={i: len(train_local[i][0]) for i in train_local},
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=vocab,
        feature_dim=seq_len,
    )
