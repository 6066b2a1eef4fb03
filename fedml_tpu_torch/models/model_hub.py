"""``create`` / ``init_params`` — counterpart of
``fedml_tpu/models/model_hub.py`` for the simulation's model families: LR,
MLP, the CNNs, the ResNets (GroupNorm) and the LSTMs. A model is a
callable ``model(scope, x)`` (``models/layers.py``); its parameters are a
flat dict in the reference's leaf order, kept apart from it."""
from __future__ import annotations

from typing import Any, Callable

import torch

from fedml_tpu_torch.models import layers


def create(args: Any, output_dim: int = 10) -> Callable:
    name = str(getattr(args, "model", "lr")).lower()
    from fedml_tpu_torch.models.cv.cnn import CNNCifar, CNNFemnist, LeNet5
    from fedml_tpu_torch.models.cv.resnet import resnet18, resnet20, resnet56
    from fedml_tpu_torch.models.linear.lr import MLP, LogisticRegression
    from fedml_tpu_torch.models.nlp.rnn import RNNOriginalFedAvg, RNNStackOverflow

    dataset = str(getattr(args, "dataset", "")).lower()
    groups = None if getattr(args, "group_norm_channels", 2) in (0, None) else int(
        getattr(args, "group_norm_channels", 2))

    if name in ("lr", "logistic_regression"):
        return LogisticRegression(output_dim=output_dim)
    if name == "mlp":
        return MLP(hidden_dim=int(getattr(args, "hidden_dim", 128)), output_dim=output_dim)
    if name in ("cnn", "cnn_dropout"):
        if "cifar" in dataset or "cinic" in dataset:
            return CNNCifar(output_dim=output_dim)
        return CNNFemnist(output_dim=output_dim)
    if name in ("lenet", "lenet5", "mnn_lenet"):
        return LeNet5(output_dim=output_dim)
    if name in ("resnet18", "resnet18_gn"):
        return resnet18(output_dim=output_dim, groups=groups)
    if name in ("resnet20",):
        return resnet20(output_dim=output_dim, groups=groups)
    if name in ("resnet56", "resnet56_gn"):
        return resnet56(output_dim=output_dim, groups=groups)
    if name in ("rnn", "lstm"):
        if "stackoverflow" in dataset or "reddit" in dataset:
            return RNNStackOverflow(vocab_size=max(output_dim, 4))
        return RNNOriginalFedAvg(vocab_size=max(output_dim, 4))
    raise NotImplementedError(
        f"model {name!r} is not ported to the simulation: the rest of the model "
        "zoo (segnet, mobilenet, efficientnet, vgg, darts, and the LLM in the sp "
        "engine) comes with ROADMAP A13; the LoRA path of Llama is "
        "fedml_tpu_torch.train.llm")


def init_params(model: Callable, args: Any, sample_input: Any,
                device: Any = "cpu") -> layers.Tree:
    """Fresh parameters for ``model`` from ``args.random_seed``: the
    reference's shapes and distributions (not its bits; see
    ``models/layers.py``)."""
    x = torch.as_tensor(sample_input)
    return layers.init(model, x, seed=int(getattr(args, "random_seed", 0)),
                       device=torch.device(device))
