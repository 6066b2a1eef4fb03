"""Configuration — the part of ``fedml_tpu/arguments.py`` that
``run_simulation`` and the cross-silo launchers need: a flat attribute bag
whose YAML sections (``common_args``, ``data_args``, ``train_args``, ...)
are flattened onto one namespace, the ``--cf``, ``--run_id``, ``--rank``
and ``--role`` command-line flags, and the reference's defaults.

:func:`update_client_specific_args` applies the per-silo config overrides
(``data_silo_config``, and under ``scenario: hierarchical`` the
``server_config_path`` / ``client_silo_config_paths``), as the reference's
``fedml_tpu.init`` does.

PyYAML is imported only inside :func:`read_config`, and a
machine without it (the card's has none) reads a config written in YAML's
JSON form with ``json``; a config built in code
(:func:`load_arguments_from_dict`) needs neither.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Optional, Sequence

_DEFAULTS = dict(
    training_type="simulation",
    backend="sp",
    federated_optimizer="FedAvg",
    dataset="synthetic",
    data_cache_dir="",
    partition_method="hetero",
    partition_alpha=0.5,
    model="lr",
    client_num_in_total=4,
    client_num_per_round=2,
    comm_round=2,
    epochs=1,
    batch_size=32,
    client_optimizer="sgd",
    learning_rate=0.03,
    weight_decay=0.0,
    server_optimizer="sgd",
    server_lr=1.0,
    server_momentum=0.9,
    frequency_of_the_test=1,
    random_seed=0,
    compression="",
    compression_topk_ratio=0.05,
    rank=0,
    run_id="0",
    role="client",
    scenario="horizontal",
)


class Arguments:
    """Flat attribute bag: every key of every section of the config becomes
    a top-level attribute."""

    def __init__(self, cmd_args: Optional[argparse.Namespace] = None,
                 training_type: Optional[str] = None):
        if cmd_args is not None:
            for k, v in vars(cmd_args).items():
                setattr(self, k, v)
        if training_type is not None and not hasattr(self, "training_type"):
            self.training_type = training_type
        config_file = getattr(self, "yaml_config_file", None)
        if config_file:
            self.load_yaml_config(config_file)

    def load_yaml_config(self, path: str | os.PathLike) -> None:
        self.set_attr_from_config(read_config(path))
        self.yaml_paths = [str(path)]

    def set_attr_from_config(self, configuration: dict) -> None:
        for section, payload in configuration.items():
            if isinstance(payload, dict):
                for k, v in payload.items():
                    setattr(self, k, v)
            else:
                setattr(self, section, payload)


def read_config(path: str | os.PathLike) -> dict:
    """A YAML config file as a dict (``{}`` when empty); without PyYAML, a
    config in YAML's JSON form."""
    with open(path, "r") as f:
        text = f.read()
    try:
        import yaml  # only here: the card's machine has no PyYAML
    except ImportError:
        try:  # JSON is YAML: a config in that form needs no PyYAML
            cfg = json.loads(text)
        except json.JSONDecodeError as e:
            raise RuntimeError(
                f"{path}: PyYAML is not installed, and the config is not in "
                f"YAML's JSON form ({e})") from None
    else:
        cfg = yaml.safe_load(text)
    return cfg or {}


def update_client_specific_args(args: Any) -> None:
    """Per-silo config overrides, the reference's rule: ``data_silo_config``
    lists one config a client silo, and rank r > 0 loads entry r-1 on top of
    the global config (setting ``worker_num`` to the silo count; a rank past
    the list raises); else under ``scenario: hierarchical`` rank 0 loads
    ``server_config_path`` and rank r > 0 entry r-1 of
    ``client_silo_config_paths``. Relative paths resolve against the main
    config's directory."""
    rank = int(getattr(args, "rank", 0))

    def _apply(path: str) -> None:
        if not os.path.isabs(path):
            base = os.path.dirname((getattr(args, "yaml_paths", None) or [""])[0])
            path = os.path.join(base, path) if base else path
        args.set_attr_from_config(read_config(path))

    silo_cfgs = getattr(args, "data_silo_config", None)
    if silo_cfgs:
        args.worker_num = len(silo_cfgs)
        if rank > 0:
            if rank > len(silo_cfgs):
                raise ValueError(f"rank {rank} but data_silo_config lists only "
                                 f"{len(silo_cfgs)} silos")
            _apply(str(silo_cfgs[rank - 1]))
    elif str(getattr(args, "scenario", "")) == "hierarchical":
        if rank == 0 and getattr(args, "server_config_path", None):
            _apply(str(args.server_config_path))
        elif rank > 0 and getattr(args, "client_silo_config_paths", None):
            paths = args.client_silo_config_paths
            if rank <= len(paths):
                _apply(str(paths[rank - 1]))


def add_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument("--yaml_config_file", "--cf", help="yaml configuration file",
                        type=str, default="")
    parser.add_argument("--run_id", type=str, default="0")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    args, _ = parser.parse_known_args(argv)
    return args


def apply_defaults(args: Any) -> Any:
    for k, v in _DEFAULTS.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    return args


def load_arguments(training_type: Optional[str] = None,
                   argv: Optional[Sequence[str]] = None) -> Arguments:
    """Args from the command line (``--cf config.yaml``) and the defaults."""
    return apply_defaults(Arguments(add_args(argv), training_type))


def load_arguments_from_dict(config: dict,
                             training_type: Optional[str] = None) -> Arguments:
    """Args from an in-memory config dict (sections or flat keys)."""
    args = Arguments(training_type=training_type)
    args.set_attr_from_config(config)
    return apply_defaults(args)
