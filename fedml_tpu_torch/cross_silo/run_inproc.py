"""In-process cross-silo federation — counterpart of
``fedml_tpu/cross_silo/run_inproc.py``: the server and the clients' FSMs
on threads of one process over the LOCAL transport, on one device.

A handler that raises stops the whole federation and is raised here
(``handler_error``), so a failure never waits out a deadline; a run that
does not finish in ``timeout`` raises too.
"""
from __future__ import annotations

import copy
import time
from typing import Any, List, Optional

from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.cross_silo.client.client import Client
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.server.server import Server
from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import DeviceLike


def run_managers_to_completion(managers: List[Any], run_id: str, ready_msg_type: str,
                               timeout: float = 600.0) -> Optional[dict]:
    """Start every manager's receive loop, post connection-ready to each
    rank, and wait; returns ``managers[0].result`` (the server's)."""
    threads = [m.run_async() for m in managers]
    broker = LocalBroker.get(run_id)
    for rank in range(len(managers)):
        broker.post(rank, Message(ready_msg_type, rank, rank))

    def first_error():
        for mgr in managers:
            if mgr.handler_error is not None:
                return mgr, mgr.handler_error
        return None, None

    def shutdown():
        for m in managers:
            m.finish()
        for t in threads:
            t.join(timeout=5.0)

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(t.is_alive() for t in threads):
        mgr, err = first_error()
        if err is not None:
            shutdown()
            raise RuntimeError(f"rank {mgr.rank} message handler failed: {err!r}") from err
        time.sleep(0.01)
    mgr, err = first_error()
    if err is not None:
        raise RuntimeError(f"rank {mgr.rank} message handler failed: {err!r}") from err
    if any(t.is_alive() for t in threads):
        shutdown()
        raise TimeoutError(f"federation run did not finish within {timeout}s (alive: "
                           f"{[t.name for t in threads if t.is_alive()]})")
    return managers[0].result


def build_cross_silo_inproc(args: Any, dataset: FederatedDataset, model: Any,
                            device: DeviceLike = "cuda", client_trainer=None,
                            server_aggregator=None):
    """The server and ``client_num_per_round`` clients (ranks 1..N), built
    but not started: ``(server, clients)``."""
    server = Server(args, device, dataset, model, server_aggregator)
    clients: List[Client] = []
    for rank in range(1, int(getattr(args, "client_num_per_round", 1)) + 1):
        cargs = copy.copy(args)
        cargs.rank = rank
        clients.append(Client(cargs, device, dataset, model, client_trainer))
    return server, clients


def run_cross_silo_inproc(args: Any, dataset: FederatedDataset, model: Any,
                          client_trainer=None, server_aggregator=None,
                          timeout: float = 600.0,
                          device: DeviceLike = "cuda") -> Optional[dict]:
    """Run the server and ``client_num_per_round`` clients to completion on
    ``device``; returns the server's final metrics."""
    run_id = str(getattr(args, "run_id", "0"))
    LocalBroker.destroy(run_id)
    server, clients = build_cross_silo_inproc(args, dataset, model, device,
                                              client_trainer, server_aggregator)
    managers = [server.manager] + [c.manager for c in clients]
    return run_managers_to_completion(managers, run_id,
                                      MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout)
