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
in ``utils.serialization``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
import random
from typing import Any, Optional

import numpy as np

from fedml_tpu_torch.device import DeviceLike, resolve_device


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
    args = load_arguments("simulation") if args is None else apply_defaults(args)
    seed = int(getattr(args, "random_seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    dataset = load_federated(args)
    model = create(args, dataset.class_num)
    return FedMLRunner(args, dev, dataset, model).run()


def _run_cross_silo(role: str, args: Optional[Any], device: DeviceLike):
    from fedml_tpu_torch.arguments import apply_defaults, load_arguments
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.runner import FedMLRunner

    dev = resolve_device(device)
    args = load_arguments("cross_silo") if args is None else apply_defaults(args)
    args.role = role
    seed = int(getattr(args, "random_seed", 0))
    random.seed(seed)
    np.random.seed(seed)
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


__all__ = ["resolve_device", "run_cross_silo_client", "run_cross_silo_server",
           "run_simulation"]
