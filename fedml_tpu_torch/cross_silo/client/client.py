"""Cross-silo Client facade — counterpart of
``fedml_tpu/cross_silo/client/client.py``."""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.cross_silo.client.fedml_client_master_manager import (
    ClientMasterManager,
)
from fedml_tpu_torch.cross_silo.client.trainer_dist_adapter import TrainerDistAdapter
from fedml_tpu_torch.cross_silo.server.server import comm_backend
from fedml_tpu_torch.device import DeviceLike, resolve_device


class Client:
    def __init__(self, args: Any, device: DeviceLike, dataset: Any, model: Any,
                 client_trainer=None):
        self.args = args
        dev = resolve_device(device)
        rank = int(getattr(args, "rank", 1))
        client_num = int(getattr(args, "client_num_per_round", 1))
        adapter = TrainerDistAdapter(args, dev, rank, model, dataset, client_trainer)
        self.manager = ClientMasterManager(args, adapter, rank=rank, size=client_num + 1,
                                           backend=comm_backend(args), device=dev)

    def run(self):
        self.manager.run()
        return None
