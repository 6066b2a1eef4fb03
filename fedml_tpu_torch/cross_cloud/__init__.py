"""Cross-cloud ("Cheetah") federated training — counterpart of
``fedml_tpu/cross_cloud/__init__.py`` (the reference's
``python/fedml/cross_cloud/``).

A silo is a cloud's GPU machine. The round is the cross-silo one: the
protocol does not change because the silos live in different clouds, only
the transport each silo reaches (the broker, MQTT, gRPC or tRPC) and its
store, which each silo brings in its own override file
(``data_silo_config``, applied by ``fedml_tpu_torch.init`` through
``arguments.update_client_specific_args``). A silo spanning several hosts
(the reference's multi-host slice runtime) comes with the multi-GPU
layer, ROADMAP A11: ``init`` refuses its environment.
"""
from __future__ import annotations

from fedml_tpu_torch.cross_silo.client.client import Client
from fedml_tpu_torch.cross_silo.server.server import Server


class CloudServer(Server):
    """The cross-cloud aggregation server (the cross-silo FSM)."""


class CloudClient(Client):
    """One cloud silo: ``init`` has applied its override file, so the
    cross-silo client builds its trainer and transport from the silo's own
    settings."""


__all__ = ["CloudClient", "CloudServer"]
