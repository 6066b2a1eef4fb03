"""FedMLRunner — counterpart of ``fedml_tpu/runner.py`` for the training
types the port has: ``simulation`` and ``cross_silo`` (the server for
``role: server`` or rank 0, else a client). Hierarchical cross-silo comes
with ROADMAP A10.3, cross-cloud with A10.4 and cross-device with A13."""
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
        elif tt == "cross_silo":
            if str(getattr(args, "scenario", "horizontal")) == "hierarchical":
                raise NotImplementedError(
                    "scenario 'hierarchical': hierarchical cross-silo comes with "
                    "ROADMAP A10.3")
            is_server = (str(getattr(args, "role", "client")) == "server"
                         or int(getattr(args, "rank", 0)) == 0)
            if is_server:
                from fedml_tpu_torch.cross_silo.server.server import Server

                self.runner = Server(args, device, dataset, model, server_aggregator)
            else:
                from fedml_tpu_torch.cross_silo.client.client import Client

                self.runner = Client(args, device, dataset, model, client_trainer)
        elif tt == "cross_cloud":
            raise NotImplementedError(
                "training_type 'cross_cloud' comes with ROADMAP A10.4")
        elif tt == "cross_device":
            raise NotImplementedError(
                "training_type 'cross_device' comes with the remainder (ROADMAP A13)")
        else:
            raise ValueError(f"unknown training_type {tt!r}")

    def run(self):
        return self.runner.run()
