"""create_model_trainer — counterpart of
``fedml_tpu/ml/trainer/trainer_creator.py``."""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer


def create_model_trainer(model: Any, args: Any):
    # classification covers sequence tasks too (3-D logits in the loss)
    return ClassificationTrainer(model, args)
