"""Typed configuration for the LLM fine-tuning kit — a copy of
``fedml_tpu/train/llm/configurations.py``: model selection is a
``LlamaConfig`` preset name, and the mesh sizes stay in the experiment
group (the port runs on one device; ``LLMTrainer`` refuses other sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ModelArguments:
    model_name: str = "tiny"          # LlamaConfig preset name
    lora_rank: int = 8
    lora_alpha: float = 16.0
    use_flash_attention: bool = True
    gradient_checkpointing: bool = True
    dtype: str = "bfloat16"


@dataclasses.dataclass
class DatasetArguments:
    dataset: str = "synthetic_lm"
    max_seq_length: int = 512
    vocab_size: int = 256
    train_size: int = 2048
    test_size: int = 256


@dataclasses.dataclass
class ExperimentArguments:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 0
    max_steps: int = 100
    per_device_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    seed: int = 0
    output_dir: str = "./outputs"
    save_every_rounds: int = 1
    mesh_dp: int = 1
    mesh_fsdp: int = -1
    mesh_tp: int = 1
    mesh_sp: int = 1

    @property
    def global_batch_size(self) -> int:
        return self.per_device_batch_size * self.gradient_accumulation_steps


def from_args(args: Any):
    """Build the three argument groups from a flat fedml-style args bag."""

    def pick(cls):
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
        return cls(**kw)

    return pick(ModelArguments), pick(DatasetArguments), pick(ExperimentArguments)
