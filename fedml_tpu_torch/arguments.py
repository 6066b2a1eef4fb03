"""Configuration — the part of ``fedml_tpu/arguments.py`` that
``run_simulation`` and the cross-silo launchers need: a flat attribute bag
whose YAML sections (``common_args``, ``data_args``, ``train_args``, ...)
are flattened onto one namespace, the ``--cf``, ``--run_id``, ``--rank``
and ``--role`` command-line flags, and the reference's defaults.

PyYAML is imported only inside :meth:`Arguments.load_yaml_config`, and a
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
        cfg = cfg or {}
        self.set_attr_from_config(cfg)
        self.yaml_paths = [str(path)]

    def set_attr_from_config(self, configuration: dict) -> None:
        for section, payload in configuration.items():
            if isinstance(payload, dict):
                for k, v in payload.items():
                    setattr(self, k, v)
            else:
                setattr(self, section, payload)


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
