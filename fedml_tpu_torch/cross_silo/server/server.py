"""Cross-silo Server facade — counterpart of
``fedml_tpu/cross_silo/server/server.py``: the aggregator, the initial
global model on the server's device, and the synchronous server FSM.

The asynchronous server (``async_aggregation`` / ``AsyncFedAvg``) comes
with ROADMAP A10.3 and the SecAgg server with A10.2: asking for either
raises (the latter in the server FSM).
"""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.core.distributed.fedml_comm_manager import COMM_BACKEND_LOCAL
from fedml_tpu_torch.cross_silo.server.fedml_aggregator import FedMLAggregator
from fedml_tpu_torch.cross_silo.server.fedml_server_manager import FedMLServerManager
from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.ml.aggregator.default_aggregator import create_server_aggregator
from fedml_tpu_torch.models import model_hub


def comm_backend(args: Any) -> str:
    """The transport the args name; the simulation backends' names mean the
    in-process one."""
    backend = str(getattr(args, "comm_backend", None) or getattr(args, "backend", "LOCAL"))
    return COMM_BACKEND_LOCAL if backend.lower() in ("sp", "mesh") else backend


def refuse_async(args: Any) -> None:
    if bool(getattr(args, "async_aggregation", False)) or (
            str(getattr(args, "federated_optimizer", "")) == "AsyncFedAvg"):
        raise NotImplementedError(
            "async_aggregation / AsyncFedAvg: the asynchronous server comes with "
            "ROADMAP A10.3")


class Server:
    def __init__(self, args: Any, device: DeviceLike, dataset: FederatedDataset,
                 model: Any, server_aggregator=None):
        refuse_async(args)
        self.args = args
        dev = resolve_device(device)
        aggregator = server_aggregator or create_server_aggregator(model, args)
        aggregator.set_id(0)
        client_num = int(getattr(args, "client_num_per_round", 1))
        self.fedml_aggregator = FedMLAggregator(
            dataset.test_data_global, dataset.train_data_global, dataset.train_data_num,
            dataset.train_data_local_dict, dataset.test_data_local_dict,
            dataset.train_data_local_num_dict, client_num, dev, args, aggregator)
        sample_x = dataset.train_data_global[0][: int(getattr(args, "batch_size", 32))]
        self.fedml_aggregator.set_global_model_params(
            model_hub.init_params(model, args, sample_x, dev))
        self.manager = FedMLServerManager(args, self.fedml_aggregator, client_rank=0,
                                          client_num=client_num,
                                          backend=comm_backend(args), device=dev)

    def run(self):
        self.manager.run()
        return self.manager.result

