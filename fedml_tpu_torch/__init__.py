"""fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu for NVIDIA Hopper.

The JAX package ``fedml_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find, imports neither JAX nor
anything of ``fedml_tpu``, and replaces every Pallas kernel on a ported
path with a CUDA kernel written for ``sm_90a`` (``ops/csrc``).

Ported so far: the int8 serving path (``models.llm.llama``,
``ops.quant``, ``serving``), federated LoRA fine-tuning with the
on-device round (``train.llm``, ``ops.flash_attention``, ``data``,
``simulation.sampling``), and the quantized formats: w8a8 and int4/nf4
serving and QLoRA over an int8/int4/nf4 frozen base (``ops.quant``, the
NF4 codebook in ``compression``), the single-process FedAvg simulation
with compressed uplinks (:func:`run_simulation`: ``simulation``,
``ml``, ``models``, ``data``, the wire codecs in ``compression``), and
synchronous cross-silo FedAvg over the in-process and TCP-broker
transports (:func:`run_cross_silo_server` / :func:`run_cross_silo_client`:
``cross_silo``, ``core.distributed``, ``resilience``, the reference's wire
in ``utils.serialization``), the aggregation-side trust stack of both
engines: the integrity rings (``integrity``), differential privacy
(``core.dp``), attacks and defenses (``core.security``), and secure
aggregation: the masked int8 domain (``privacy.secagg``, ``secagg: int8``)
and the Bonawitz and LightSecAgg protocols (``core.mpc``,
``cross_silo.secagg``, ``cross_silo.lightsecagg``), round checkpoints with
resume (``core.checkpoint``: the sp engine, the cross-silo server, the LLM
trainer and ``serve --checkpoint``), contribution assessment
(``core.contribution``), the gradient-reconstruction attacks and the
host-loop FedLLM round, the durable and asynchronous cross-silo servers,
and the aggregation tree (``hierarchy``: ``TreeRunner``, edge aggregators,
partial sums, per-cohort SecAgg) with hierarchical cross-silo
(:func:`run_hierarchical_cross_silo_server` /
:func:`run_hierarchical_cross_silo_client`), and the other transports
(gRPC, tRPC, MQTT, the C++ epoll broker, the S3 and web3/Theta stores in
``core.distributed.communication``) with cross-cloud training
(:func:`run_cross_cloud_server` / :func:`run_cross_cloud_client`,
``cross_cloud``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
import os
import random
from typing import Any, Optional

import numpy as np

from fedml_tpu_torch.device import DeviceLike, resolve_device


def _refuse_multihost(args: Any) -> None:
    """The reference's multi-host slice runtime (one silo over several
    hosts: ``FEDML_MULTIHOST=auto``, or ``FEDML_COORDINATOR_ADDRESS`` with
    ``FEDML_NUM_PROCESSES`` or their config keys) comes with the multi-GPU
    layer."""
    def pick(env: str, attr: str):
        v = os.environ.get(env)
        return getattr(args, attr, None) if v is None else v

    if (str(os.environ.get("FEDML_MULTIHOST", "")).lower() == "auto"
            or (pick("FEDML_COORDINATOR_ADDRESS", "coordinator_address") is not None
                and pick("FEDML_NUM_PROCESSES", "num_processes") is not None)):
        raise NotImplementedError(
            "the multi-host runtime (FEDML_MULTIHOST / FEDML_COORDINATOR_ADDRESS + "
            "FEDML_NUM_PROCESSES) comes with the multi-GPU layer, ROADMAP A11")


def init(args: Any) -> Any:
    """Counterpart of ``fedml_tpu.init`` for an args namespace: seed
    Python's and numpy's generators, apply the per-silo config overrides
    (``arguments.update_client_specific_args``) and configure the
    trust-stack singletons (``FedMLAttacker``, ``FedMLDefender``,
    ``FedMLDifferentialPrivacy``) from ``args``. They are per process:
    ``reset()`` them between in-process runs. A multi-host environment
    raises, naming ROADMAP A11."""
    from fedml_tpu_torch.arguments import update_client_specific_args
    from fedml_tpu_torch.compression import check_trust_stack
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    _refuse_multihost(args)
    check_trust_stack(args)
    seed = int(getattr(args, "random_seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    update_client_specific_args(args)
    FedMLAttacker.get_instance().init(args)
    FedMLDefender.get_instance().init(args)
    FedMLDifferentialPrivacy.get_instance().init(args)
    return args


def run_simulation(args: Optional[Any] = None, device: DeviceLike = "cuda"):
    """Run a federated simulation end to end — counterpart of
    ``fedml_tpu.run_simulation``: ``args`` is an args namespace (for
    example ``arguments.load_arguments_from_dict``), or, when None, is read
    from the command line (``--cf config.yaml``). Loads the dataset, builds
    the model, trains ``comm_round`` rounds and returns the final report."""
    from fedml_tpu_torch.arguments import apply_defaults, load_arguments
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.runner import FedMLRunner

    dev = resolve_device(device)
    args = init(load_arguments("simulation") if args is None else apply_defaults(args))
    dataset = load_federated(args)
    model = create(args, dataset.class_num)
    return FedMLRunner(args, dev, dataset, model).run()


def _run_cross_silo(role: str, args: Optional[Any], device: DeviceLike,
                    scenario: Optional[str] = None, training_type: Optional[str] = None):
    from fedml_tpu_torch.arguments import apply_defaults, load_arguments
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.runner import FedMLRunner

    dev = resolve_device(device)
    args = (load_arguments(training_type or "cross_silo") if args is None
            else apply_defaults(args))
    args.role = role
    if training_type is not None:  # the launcher's type wins over the config's
        args.training_type = training_type
    if scenario is not None:
        args.scenario = scenario
    init(args)
    dataset = load_federated(args)
    model = create(args, dataset.class_num)
    return FedMLRunner(args, dev, dataset, model).run()


def run_cross_silo_server(args: Optional[Any] = None, device: DeviceLike = "cuda"):
    """The cross-silo server of one federation — counterpart of
    ``fedml_tpu.run_cross_silo_server``: ``args``, or when None the command
    line (``--cf config.yaml --rank 0 --role server``), names the
    transport (``comm_backend: BROKER`` with ``broker_host``/``broker_port``,
    or ``LOCAL``); returns the final ``{"rounds": ..., **test metrics}``."""
    return _run_cross_silo("server", args, device)


def run_cross_silo_client(args: Optional[Any] = None, device: DeviceLike = "cuda"):
    """One silo of a cross-silo federation (``--rank r`` of 1..N); runs
    until the server's FINISH."""
    return _run_cross_silo("client", args, device)


def run_hierarchical_cross_silo_server(args: Optional[Any] = None,
                                       device: DeviceLike = "cuda"):
    """The server of a hierarchical cross-silo federation — counterpart of
    ``fedml_tpu.run_hierarchical_cross_silo_server``: the cross-silo server
    with ``scenario: hierarchical``, which loads ``server_config_path`` on
    top of the config."""
    return _run_cross_silo("server", args, device, scenario="hierarchical")


def run_hierarchical_cross_silo_client(args: Optional[Any] = None,
                                       device: DeviceLike = "cuda"):
    """One silo of a hierarchical cross-silo federation (``--rank r``): loads
    entry r-1 of ``client_silo_config_paths`` on top of the config. A silo
    over several devices (``n_proc_in_silo > 1``) raises, naming ROADMAP A11."""
    return _run_cross_silo("client", args, device, scenario="hierarchical")


def run_cross_cloud_server(args: Optional[Any] = None, device: DeviceLike = "cuda"):
    """The server of a cross-cloud federation — counterpart of
    ``fedml_tpu.run_cross_cloud_server``: the cross-silo server as
    ``cross_cloud.CloudServer`` (``training_type: cross_cloud``)."""
    return _run_cross_silo("server", args, device, training_type="cross_cloud")


def run_cross_cloud_client(args: Optional[Any] = None, device: DeviceLike = "cuda"):
    """One cloud silo of a cross-cloud federation (``--rank r``): entry r-1
    of ``data_silo_config`` applies its own transport and settings."""
    return _run_cross_silo("client", args, device, training_type="cross_cloud")


__all__ = ["init", "resolve_device", "run_cross_cloud_client", "run_cross_cloud_server",
           "run_cross_silo_client", "run_cross_silo_server",
           "run_hierarchical_cross_silo_client", "run_hierarchical_cross_silo_server",
           "run_simulation"]
