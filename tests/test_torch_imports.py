"""The port (``fedml_tpu_torch``) stands alone: it imports neither JAX nor
flax nor anything of ``fedml_tpu``, and its entry points refuse to run
without CUDA unless the caller asks for the CPU."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "fedml_tpu_torch"
PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_port_modules_import_with_jax_blocked():
    """Import every port module in a fresh interpreter where ``import jax``
    fails (this test process has JAX loaded already, via conftest)."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"mods = {PORT_MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "    if k == 'fedml_tpu' or k.startswith('fedml_tpu.'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(PORT_MODULES) >= 15


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.ops.flash_attention",
    "fedml_tpu_torch.train.llm.trainer",
    "fedml_tpu_torch.train.llm.federated",
    "fedml_tpu_torch.train.llm.run_fedllm",
    "fedml_tpu_torch.train.llm.configurations",
    "fedml_tpu_torch.data.dataset",
    "fedml_tpu_torch.data.data_loader",
    "fedml_tpu_torch.simulation.sampling",
    "fedml_tpu_torch.compression",
    "fedml_tpu_torch.compression.codecs",
    "fedml_tpu_torch.ops.quant",
])
def test_training_slice_modules_are_scanned(module):
    """The training slice's modules, and the quantized formats' (the NF4
    codebook's own copy in ``compression``), are among those both scans
    cover."""
    assert module in PORT_MODULES


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.compression.threefry",
    "fedml_tpu_torch.compression.error_feedback",
    "fedml_tpu_torch.utils.tree",
    "fedml_tpu_torch.core.data.noniid_partition",
    "fedml_tpu_torch.core.alg_frame.client_trainer",
    "fedml_tpu_torch.core.alg_frame.server_aggregator",
    "fedml_tpu_torch.core.alg_frame.params",
    "fedml_tpu_torch.models.layers",
    "fedml_tpu_torch.models.linear.lr",
    "fedml_tpu_torch.models.cv.cnn",
    "fedml_tpu_torch.models.cv.resnet",
    "fedml_tpu_torch.models.nlp.rnn",
    "fedml_tpu_torch.models.model_hub",
    "fedml_tpu_torch.models.convert",
    "fedml_tpu_torch.ml.trainer.local_sgd",
    "fedml_tpu_torch.ml.trainer.classification_trainer",
    "fedml_tpu_torch.ml.trainer.trainer_creator",
    "fedml_tpu_torch.ml.aggregator.agg_operator",
    "fedml_tpu_torch.ml.aggregator.default_aggregator",
    "fedml_tpu_torch.ml.aggregator.server_optimizer",
    "fedml_tpu_torch.simulation.sp.fedavg_api",
    "fedml_tpu_torch.simulation.simulator",
    "fedml_tpu_torch.arguments",
    "fedml_tpu_torch.runner",
])
def test_sp_slice_modules_are_scanned(module):
    """The single-process simulation's modules (the wire codecs, the models,
    the trainers and aggregators, the engine) are among those both scans
    cover."""
    assert module in PORT_MODULES


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.utils.serialization",
    "fedml_tpu_torch.core.distributed.message",
    "fedml_tpu_torch.core.distributed.fedml_comm_manager",
    "fedml_tpu_torch.core.distributed.communication.base_com_manager",
    "fedml_tpu_torch.core.distributed.communication.local_comm",
    "fedml_tpu_torch.core.distributed.communication.object_store",
    "fedml_tpu_torch.core.distributed.communication.broker",
    "fedml_tpu_torch.core.distributed.communication.broker_comm",
    "fedml_tpu_torch.resilience",
    "fedml_tpu_torch.resilience.policy",
    "fedml_tpu_torch.resilience.dedup",
    "fedml_tpu_torch.resilience.liveness",
    "fedml_tpu_torch.resilience.quorum",
    "fedml_tpu_torch.cross_silo.message_define",
    "fedml_tpu_torch.cross_silo.run_inproc",
    "fedml_tpu_torch.cross_silo.server.fedml_aggregator",
    "fedml_tpu_torch.cross_silo.server.fedml_server_manager",
    "fedml_tpu_torch.cross_silo.server.server",
    "fedml_tpu_torch.cross_silo.client.trainer_dist_adapter",
    "fedml_tpu_torch.cross_silo.client.fedml_client_master_manager",
    "fedml_tpu_torch.cross_silo.client.client",
    "fedml_tpu_torch.cli",
])
def test_cross_silo_slice_modules_are_scanned(module):
    """The cross-silo slice's modules (the wire, the message layer and its
    transports, resilience, the FSMs) are among those both scans cover."""
    assert module in PORT_MODULES


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_flax_or_reference_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "fedml_tpu"), (
            f"{path.relative_to(REPO)} imports {name}")


def test_entry_points_refuse_missing_cuda(monkeypatch):
    from fedml_tpu_torch import resolve_device
    from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM
    from fedml_tpu_torch.serving.llm_engine import ContinuousBatchingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(model, batch_slots=1, max_len=16)
    eng = ContinuousBatchingEngine(model, batch_slots=1, max_len=16, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    from fedml_tpu_torch.train.llm.trainer import LLMTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMTrainer(LlamaConfig.tiny(dtype=torch.float32, lora_rank=4), object())


def test_run_simulation_refuses_missing_cuda(monkeypatch):
    """``run_simulation`` and the sp engine default to ``cuda`` and raise
    without it; the YAML reader is not needed for a config built in code."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = load_arguments_from_dict({"train_args": {"comm_round": 1},
                                     "data_args": {"train_size": 64, "test_size": 16}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fedml_tpu_torch.run_simulation(args)
    ds = load_federated(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FedAvgAPI(args, "cuda", ds, create(args, ds.class_num))
    assert fedml_tpu_torch.run_simulation(args, device="cpu")["rounds"] == 1


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cross_silo_entry_points_refuse_missing_cuda(monkeypatch):
    """The cross-silo launchers and the in-process harness default to
    ``cuda`` and raise without it, before any transport is opened."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "run_id": "no_cuda"},
        "train_args": {"comm_round": 1}, "data_args": {"train_size": 64, "test_size": 16}})
    for fn in (fedml_tpu_torch.run_cross_silo_server, fedml_tpu_torch.run_cross_silo_client):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(args)
    ds = load_federated(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cross_silo_inproc(args, ds, create(args, ds.class_num))
    assert run_cross_silo_inproc(args, ds, create(args, ds.class_num), timeout=60,
                                 device="cpu")["rounds"] == 1
