"""FedMLRunner — counterpart of ``fedml_tpu/runner.py`` for the training
types the port has: ``simulation``, ``cross_silo`` (the server for ``role:
server`` or rank 0, else a client; the server is the asynchronous one under
``async_aggregation``) and ``cross_cloud`` (the same roles as
``cross_cloud.CloudServer`` / ``CloudClient``). ``scenario: hierarchical``
runs the cross-silo roles once ``init`` has applied the per-silo config
overrides (``arguments.update_client_specific_args``); a silo trained over
several devices (``n_proc_in_silo > 1``) comes with the multi-GPU layer,
ROADMAP A11. Cross-device comes with A13."""
from __future__ import annotations

from typing import Any


class FedMLRunner:
    def __init__(self, args: Any, device: Any, dataset: Any, model: Any,
                 client_trainer=None, server_aggregator=None):
        self.args = args
        tt = str(getattr(args, "training_type", "simulation"))
        if tt == "simulation":
            from fedml_tpu_torch.simulation.simulator import create_simulator

            self.runner = create_simulator(args, device, dataset, model,
                                           client_trainer, server_aggregator)
        elif tt in ("cross_silo", "cross_cloud"):
            is_server = (str(getattr(args, "role", "client")) == "server"
                         or int(getattr(args, "rank", 0)) == 0)
            if tt == "cross_cloud":
                from fedml_tpu_torch.cross_cloud import CloudClient as Client
                from fedml_tpu_torch.cross_cloud import CloudServer as Server
            else:
                from fedml_tpu_torch.cross_silo.client.client import Client
                from fedml_tpu_torch.cross_silo.server.server import Server
            if is_server:
                self.runner = Server(args, device, dataset, model, server_aggregator)
            else:
                self.runner = Client(args, device, dataset, model, client_trainer)
        elif tt == "cross_device":
            raise NotImplementedError(
                "training_type 'cross_device' comes with the remainder (ROADMAP A13)")
        else:
            raise ValueError(f"unknown training_type {tt!r}")

    def run(self):
        return self.runner.run()
