"""In-memory federated dataset container and batching — copies of
``fedml_tpu/data/dataset.py``'s ``FederatedDataset`` and ``batch_epochs``.
A client's data is a pair of numpy arrays ``(x, y)``; batching packs it
into fixed-shape ``[steps, batch, ...]`` arrays with a validity mask, with
the reference's shuffles and padding."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class FederatedDataset:
    """The 8-tuple the reference's ``fedml.data.load`` returns, as a struct:
    (train_data_num, test_data_num, train_data_global, test_data_global,
    train_data_local_num_dict, train_data_local_dict, test_data_local_dict,
    class_num)."""

    train_data_num: int
    test_data_num: int
    train_data_global: Tuple[np.ndarray, np.ndarray]
    test_data_global: Tuple[np.ndarray, np.ndarray]
    train_data_local_num_dict: Dict[int, int]
    train_data_local_dict: Dict[int, Tuple[np.ndarray, np.ndarray]]
    test_data_local_dict: Dict[int, Tuple[np.ndarray, np.ndarray]]
    class_num: int
    feature_dim: Optional[int] = None
    stats: dict = field(default_factory=dict)

    def as_tuple(self):
        return (
            self.train_data_num,
            self.test_data_num,
            self.train_data_global,
            self.test_data_global,
            self.train_data_local_num_dict,
            self.train_data_local_dict,
            self.test_data_local_dict,
            self.class_num,
        )


def batch_epochs(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    epochs: int,
    seed: int = 0,
    pad_to_batches: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack (x, y) into [steps, batch_size, ...] with a validity mask.

    Shuffles per epoch, pads the tail batch, and optionally pads the step
    dimension to ``pad_to_batches`` per epoch so heterogeneous clients share
    one compiled shape (SURVEY §7 hard part (b): mask-and-pad over SPMD).
    """
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    per_epoch = max(1, int(np.ceil(n / batch_size)))
    steps_per_epoch = pad_to_batches or per_epoch
    if n == 0:
        # empty client (tiny datasets / unlucky partition): fully padded,
        # mask 0 everywhere → training step is a masked no-op
        shape = (steps_per_epoch * epochs, batch_size)
        return (
            np.zeros((*shape, *x.shape[1:]), dtype=x.dtype),
            np.zeros((*shape, *y.shape[1:]), dtype=y.dtype),
            np.zeros(shape, dtype=np.float32),
        )
    xs, ys, ms = [], [], []
    for _ in range(epochs):
        order = rng.permutation(n)
        padded = steps_per_epoch * batch_size
        reps = int(np.ceil(padded / max(n, 1)))
        idx = np.concatenate([order] * reps)[:padded]
        mask = np.zeros(padded, dtype=np.float32)
        mask[: min(n, padded)] = 1.0
        xs.append(x[idx].reshape(steps_per_epoch, batch_size, *x.shape[1:]))
        ys.append(y[idx].reshape(steps_per_epoch, batch_size, *y.shape[1:]))
        ms.append(mask.reshape(steps_per_epoch, batch_size))
    return (
        np.concatenate(xs, axis=0),
        np.concatenate(ys, axis=0),
        np.concatenate(ms, axis=0),
    )
