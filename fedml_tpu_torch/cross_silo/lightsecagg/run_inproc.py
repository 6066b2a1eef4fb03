"""In-process LightSecAgg federation — counterpart of
``fedml_tpu/cross_silo/lightsecagg/run_inproc.py``: the LightSecAgg
server and client FSMs on threads of one process over LOCAL."""
from __future__ import annotations

from typing import Any, Optional

from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
from fedml_tpu_torch.cross_silo.lightsecagg.lsa_client_manager import LSAClientManager
from fedml_tpu_torch.cross_silo.lightsecagg.lsa_message_define import LSAMessage
from fedml_tpu_torch.cross_silo.lightsecagg.lsa_server_manager import LSAServerManager
from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
from fedml_tpu_torch.cross_silo.secagg.run_inproc import build_secagg_inproc
from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import DeviceLike


def build_lightsecagg_inproc(args: Any, dataset: FederatedDataset, model: Any,
                             device: DeviceLike = "cuda", client_trainer=None,
                             server_aggregator=None):
    """The LightSecAgg server and client managers, built but not started."""
    return build_secagg_inproc(args, dataset, model, device, client_trainer,
                               server_aggregator, LSAServerManager, LSAClientManager)


def run_lightsecagg_inproc(args: Any, dataset: FederatedDataset, model: Any,
                           client_trainer=None, server_aggregator=None,
                           timeout: float = 600.0,
                           device: DeviceLike = "cuda") -> Optional[dict]:
    """Run the LightSecAgg server and clients to completion; returns the
    server's metrics."""
    run_id = str(getattr(args, "run_id", "0"))
    LocalBroker.destroy(run_id)
    server, clients = build_lightsecagg_inproc(args, dataset, model, device,
                                               client_trainer, server_aggregator)
    return run_managers_to_completion([server] + clients, run_id,
                                      LSAMessage.MSG_TYPE_CONNECTION_IS_READY, timeout)
