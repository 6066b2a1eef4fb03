"""Cross-silo Server facade — counterpart of
``fedml_tpu/cross_silo/server/server.py``: the aggregator, the initial
global model on the server's device, and the server FSM — the Bonawitz
SecAgg FSM under ``secure_aggregation: true`` (``cross_silo/secagg``), the
asynchronous FedAsync/FedBuff one under ``async_aggregation`` or
``federated_optimizer: AsyncFedAvg`` (``async_server_manager``), else the
synchronous one (which runs ``secagg: int8`` itself).
"""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.core.distributed.fedml_comm_manager import COMM_BACKEND_LOCAL
from fedml_tpu_torch.cross_silo.server.async_server_manager import AsyncFedMLServerManager
from fedml_tpu_torch.cross_silo.server.fedml_aggregator import FedMLAggregator
from fedml_tpu_torch.cross_silo.secagg.sa_server_manager import SAServerManager
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


def use_async(args: Any) -> bool:
    return bool(getattr(args, "async_aggregation", False)) or (
        str(getattr(args, "federated_optimizer", "")) == "AsyncFedAvg")


def build_aggregator(args: Any, dev, dataset: FederatedDataset, model: Any,
                     server_aggregator=None) -> FedMLAggregator:
    """The server's aggregator with the initial global model on ``dev``."""
    aggregator = server_aggregator or create_server_aggregator(model, args)
    aggregator.set_id(0)
    fedml_aggregator = FedMLAggregator(
        dataset.test_data_global, dataset.train_data_global, dataset.train_data_num,
        dataset.train_data_local_dict, dataset.test_data_local_dict,
        dataset.train_data_local_num_dict, int(getattr(args, "client_num_per_round", 1)),
        dev, args, aggregator)
    sample_x = dataset.train_data_global[0][: int(getattr(args, "batch_size", 32))]
    fedml_aggregator.set_global_model_params(
        model_hub.init_params(model, args, sample_x, dev))
    return fedml_aggregator


class Server:
    def __init__(self, args: Any, device: DeviceLike, dataset: FederatedDataset,
                 model: Any, server_aggregator=None):
        self.args = args
        dev = resolve_device(device)
        client_num = int(getattr(args, "client_num_per_round", 1))
        self.fedml_aggregator = build_aggregator(args, dev, dataset, model,
                                                 server_aggregator)
        if getattr(args, "secure_aggregation", False):
            manager_cls = SAServerManager
        elif use_async(args):
            manager_cls = AsyncFedMLServerManager
        else:
            manager_cls = FedMLServerManager
        self.manager = manager_cls(args, self.fedml_aggregator, client_rank=0,
                                   client_num=client_num, backend=comm_backend(args),
                                   device=dev)

    def run(self):
        self.manager.run()
        return self.manager.result

    def run_async(self):
        """The receive loop on a daemon thread (an in-process federation)."""
        return self.manager.run_async()
