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
])
def test_training_slice_modules_are_scanned(module):
    """The training slice's modules are among those both scans cover."""
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
        assert root not in ("jax", "jaxlib", "flax", "optax", "fedml_tpu"), (
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


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
