"""FedMLRunner — counterpart of ``fedml_tpu/runner.py`` for the training
type the port has: ``simulation``. Cross-silo and cross-cloud come with
ROADMAP A10, cross-device with A13."""
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
            raise NotImplementedError(
                f"training_type {tt!r} comes with cross-silo federation (ROADMAP A10)")
        elif tt == "cross_device":
            raise NotImplementedError(
                "training_type 'cross_device' comes with the remainder (ROADMAP A13)")
        else:
            raise ValueError(f"unknown training_type {tt!r}")

    def run(self):
        return self.runner.run()
