"""In-memory federated dataset container — a copy of
``fedml_tpu/data/dataset.py::FederatedDataset``. A client's data is a pair
of numpy arrays ``(x, y)``."""
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
