"""In-process Bonawitz SecAgg federation — counterpart of
``fedml_tpu/cross_silo/secagg/run_inproc.py``: the SecAgg server and
client FSMs on threads of one process over the LOCAL transport."""
from __future__ import annotations

import copy
from typing import Any, Optional

from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
from fedml_tpu_torch.cross_silo.client.trainer_dist_adapter import TrainerDistAdapter
from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
from fedml_tpu_torch.cross_silo.secagg.sa_client_manager import SAClientManager
from fedml_tpu_torch.cross_silo.secagg.sa_message_define import SAMessage
from fedml_tpu_torch.cross_silo.secagg.sa_server_manager import SAServerManager
from fedml_tpu_torch.cross_silo.server.server import build_aggregator
from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import DeviceLike, resolve_device


def build_secagg_inproc(args: Any, dataset: FederatedDataset, model: Any,
                        device: DeviceLike = "cuda", client_trainer=None,
                        server_aggregator=None, server_cls=SAServerManager,
                        client_cls=SAClientManager):
    """The server manager and ``client_num_per_round`` client managers
    (ranks 1..N) of a masked-protocol federation, built but not started."""
    dev = resolve_device(device)
    client_num = int(getattr(args, "client_num_per_round", 1))
    server = server_cls(args, build_aggregator(args, dev, dataset, model, server_aggregator),
                        client_rank=0, client_num=client_num, device=dev)
    clients = []
    for rank in range(1, client_num + 1):
        cargs = copy.copy(args)
        cargs.rank = rank
        adapter = TrainerDistAdapter(cargs, dev, rank, model, dataset, client_trainer)
        clients.append(client_cls(cargs, adapter, rank=rank, size=client_num + 1,
                                  device=dev))
    return server, clients


def run_secagg_inproc(args: Any, dataset: FederatedDataset, model: Any,
                      client_trainer=None, server_aggregator=None, timeout: float = 600.0,
                      device: DeviceLike = "cuda") -> Optional[dict]:
    """Run the SecAgg server and clients to completion; returns the
    server's metrics (with the final ``global_model``)."""
    run_id = str(getattr(args, "run_id", "0"))
    LocalBroker.destroy(run_id)
    server, clients = build_secagg_inproc(args, dataset, model, device, client_trainer,
                                          server_aggregator)
    return run_managers_to_completion([server] + clients, run_id,
                                      SAMessage.MSG_TYPE_CONNECTION_IS_READY, timeout)
