"""Simulator facade — counterpart of ``fedml_tpu/simulation/simulator.py``.

The port has the single-process backend (``backend: sp``). The mesh
backend and its aliases (``mesh``, ``NCCL``, ``MPI``) come with the
multi-GPU layer (ROADMAP A11); the message-passing backend and the
algorithm-shaped engines (hierarchical FL, TurboAggregate, FedGKT, FedNAS,
FedGAN, FedSeg, vertical FL, split learning, decentralized FL) with the
remainder (A13). Naming one raises.
"""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.data.dataset import FederatedDataset

_MESH = ("mesh", "NCCL", "MPI")
_A13_BACKENDS = ("mp", "multiprocess", "message_passing")
_A13_OPTIMIZERS = ("hierarchical_fl", "hierarchicalfl", "turbo_aggregate",
                   "turboaggregate", "fedgkt", "fednas", "fedgan", "fedseg",
                   "vertical_fl", "vfl", "classical_vertical", "split_nn",
                   "splitnn", "decentralized", "decentralized_fl", "gossip")


class SimulatorSingleProcess:
    def __init__(self, args, device, dataset: FederatedDataset, model,
                 client_trainer=None, server_aggregator=None):
        from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

        self.fl_trainer = FedAvgAPI(args, device, dataset, model, client_trainer,
                                    server_aggregator)

    def run(self):
        return self.fl_trainer.train()


def create_simulator(args: Any, device, dataset, model, client_trainer=None,
                     server_aggregator=None) -> SimulatorSingleProcess:
    backend = str(getattr(args, "backend", "sp"))
    fed_opt = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if fed_opt in _A13_OPTIMIZERS:
        raise NotImplementedError(
            f"federated_optimizer {fed_opt!r} runs its own engine, which comes "
            "with the remainder of the port (ROADMAP A13)")
    if backend == "sp":
        return SimulatorSingleProcess(args, device, dataset, model, client_trainer,
                                      server_aggregator)
    if backend in _MESH:
        raise NotImplementedError(
            f"backend {backend!r}: the mesh simulator comes with the multi-GPU "
            "layer (ROADMAP A11); use backend 'sp'")
    if backend.lower() in _A13_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r}: the message-passing simulator comes with the "
            "remainder of the port (ROADMAP A13); use backend 'sp'")
    raise ValueError(f"unknown simulation backend {backend!r}")
