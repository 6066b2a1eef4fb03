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


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.telemetry.health",
    "fedml_tpu_torch.integrity",
    "fedml_tpu_torch.integrity.quarantine",
    "fedml_tpu_torch.integrity.screen",
    "fedml_tpu_torch.integrity.robust_agg",
    "fedml_tpu_torch.integrity.rollback",
    "fedml_tpu_torch.core.dp.mechanisms",
    "fedml_tpu_torch.core.dp.frames",
    "fedml_tpu_torch.core.dp.frames.dp_clip",
    "fedml_tpu_torch.core.dp.budget_accountant",
    "fedml_tpu_torch.core.dp.fedml_differential_privacy",
    "fedml_tpu_torch.core.security.attacker",
    "fedml_tpu_torch.core.security.defender",
    "fedml_tpu_torch.core.security.attack",
    "fedml_tpu_torch.core.security.attack.base",
    "fedml_tpu_torch.core.security.attack.byzantine",
    "fedml_tpu_torch.core.security.attack.label_flipping",
    "fedml_tpu_torch.core.security.attack.backdoor",
    "fedml_tpu_torch.core.security.attack.lazy_worker",
    "fedml_tpu_torch.core.security.attack.model_replacement",
    "fedml_tpu_torch.core.security.defense",
    "fedml_tpu_torch.core.security.defense.base",
    "fedml_tpu_torch.core.security.defense.blockwise",
] + [f"fedml_tpu_torch.core.security.defense.{m}" for m in (
    "bulyan", "cclip", "cross_round", "coord_median", "crfl", "foolsgold",
    "geometric_median", "krum", "norm_diff_clipping", "outlier_detection",
    "residual_reweight", "robust_learning_rate", "slsgd", "soteria", "three_sigma",
    "trimmed_mean", "weak_dp", "wbc")])
def test_trust_slice_modules_are_scanned(module):
    """The trust stack's modules (integrity rings, DP, attacks, the eighteen
    defenses) are among those both scans cover."""
    assert module in PORT_MODULES


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.privacy",
    "fedml_tpu_torch.privacy.secagg",
] + [f"fedml_tpu_torch.privacy.secagg.{m}" for m in ("keys", "masking", "codec", "protocol")]
    + ["fedml_tpu_torch.core.mpc"]
    + [f"fedml_tpu_torch.core.mpc.{m}" for m in ("finite", "lcc", "secagg", "lightsecagg")]
    + ["fedml_tpu_torch.cross_silo.secagg", "fedml_tpu_torch.cross_silo.lightsecagg"]
    + [f"fedml_tpu_torch.cross_silo.secagg.{m}" for m in (
        "sa_message_define", "sa_client_manager", "sa_server_manager", "run_inproc")]
    + [f"fedml_tpu_torch.cross_silo.lightsecagg.{m}" for m in (
        "lsa_message_define", "lsa_client_manager", "lsa_server_manager", "run_inproc")])
def test_secagg_slice_modules_are_scanned(module):
    """Secure aggregation's modules (the masked int8 domain, the finite-field
    math, the Bonawitz and LightSecAgg FSMs) are among those both scans
    cover."""
    assert module in PORT_MODULES


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.resilience.chaos",
    "fedml_tpu_torch.resilience.durability",
    "fedml_tpu_torch.resilience.durability.journal",
    "fedml_tpu_torch.resilience.durability.recover",
    "fedml_tpu_torch.scheduler",
    "fedml_tpu_torch.scheduler.supervision",
    "fedml_tpu_torch.hierarchy",
    "fedml_tpu_torch.hierarchy.fedbuff",
    "fedml_tpu_torch.cross_silo.server.async_server_manager",
])
def test_durability_and_async_slice_modules_are_scanned(module):
    """The durability, chaos and async slice's modules (the journal, the
    injector, the kill-and-respawn runner and its supervision policy,
    FedBuff, the async server) are among those both scans cover."""
    assert module in PORT_MODULES


def _refusal(case):
    import types

    from fedml_tpu_torch import compression, init
    from fedml_tpu_torch.integrity import fused_robust_sum
    from fedml_tpu_torch.privacy.secagg import unmask_finalize
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    ns = types.SimpleNamespace
    return {
        "sketch codec": lambda: compression.get_codec("cms"),
        "secagg mesh": lambda: unmask_finalize([object()], {}, None, mesh=ns(size=2)),
        "contribution": lambda: init(ns(enable_contribution=True)),
        "reconstruction attack": lambda: init(ns(enable_attack=True, attack_type="dlg")),
        "FHE": lambda: init(ns(enable_fhe=True)),
        "robust mesh": lambda: fused_robust_sum([object()], "median", mesh=object()),
        "host-loop FedLLM": lambda: FedLLMAPI(ns(on_device_round=False), "cpu", None),
    }[case]


def _built(case):
    """What the reconstruction and federated-analytics slices ported, built
    on the CPU."""
    import types

    from fedml_tpu_torch import compression, init
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    ns = types.SimpleNamespace
    if case == "sketch codec":
        return compression.get_codec("cms").spec == "cms@1024/4"
    if case == "contribution":
        return init(ns(enable_contribution=True)).enable_contribution
    if case == "reconstruction attack":
        init(ns(enable_attack=True, attack_type="dlg"))
        try:
            return FedMLAttacker.get_instance().is_reconstruct_data_attack()
        finally:
            FedMLAttacker.reset()
    args = ns(on_device_round=False, dataset="synthetic_lm", max_seq_length=8,
              vocab_size=16, train_size=8, test_size=4, client_num_in_total=2,
              client_num_per_round=1, per_device_batch_size=2, random_seed=0)
    api = FedLLMAPI(args, "cpu", load_synthetic_lm(args),
                    cfg=LlamaConfig.tiny(lora_rank=2, vocab_size=16, dtype=torch.float32))
    return not api.on_device


@pytest.mark.parametrize("case,item", [
    # ported with A10.5: the id it had while it still raised
    pytest.param("sketch codec", None, id=r"sketch codec-A10\.5"), ("secagg mesh", "A11"),
    ("contribution", None), ("reconstruction attack", None),
    ("host-loop FedLLM", None), ("robust mesh", "A11"), ("FHE", "A13")])
def test_trust_refusals_name_their_items(case, item):
    """What the trust slices leave out raises naming where it comes; what
    the reconstruction and federated-analytics slices ported (item None)
    builds."""
    if item is None:
        assert _built(case)
        return
    with pytest.raises(NotImplementedError, match=item):
        _refusal(case)()


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


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.hierarchy.tree",
    "fedml_tpu_torch.hierarchy.partial_sum",
    "fedml_tpu_torch.hierarchy.edge",
    "fedml_tpu_torch.hierarchy.runner",
    "fedml_tpu_torch.privacy.secagg.hierarchy",
])
def test_tree_slice_modules_are_scanned(module):
    """The aggregation tree's modules (the topology, the partial sums, the
    edge aggregators and leaf cohorts, the runner, the per-cohort SecAgg) are
    among those both scans cover."""
    assert module in PORT_MODULES


def test_tree_entry_points_refuse_missing_cuda(monkeypatch):
    """The tree's runner, its aggregators, the ``tree`` command and the
    hierarchical cross-silo launchers default to ``cuda`` and raise without
    it."""
    import fedml_tpu_torch
    from fedml_tpu_torch import cli
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import get_codec
    from fedml_tpu_torch.hierarchy import EdgeAggregator, TreeRunner, TreeTopology

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TreeRunner(TreeTopology((1, 4, 16)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EdgeAggregator(1, 0, [1, 2], get_codec("int8"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["tree", "--clients", "16"])
    args = load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "run_id": "no_cuda_h"},
        "train_args": {"comm_round": 1}, "data_args": {"train_size": 64, "test_size": 16}})
    for fn in (fedml_tpu_torch.run_hierarchical_cross_silo_server,
               fedml_tpu_torch.run_hierarchical_cross_silo_client):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(args)
    assert TreeRunner(TreeTopology((1, 4, 16)), device="cpu").run(1)["completed"]


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.core.distributed.communication.mqtt_compat",
    "fedml_tpu_torch.core.distributed.communication.grpc_comm",
    "fedml_tpu_torch.core.distributed.communication.trpc_comm",
    "fedml_tpu_torch.core.distributed.communication.s3_store",
    "fedml_tpu_torch.core.distributed.communication.decentralized_storage",
    "fedml_tpu_torch.cross_cloud",
])
def test_transport_slice_modules_are_scanned(module):
    """The other transports' modules (the MQTT seam, gRPC, tRPC, the S3 and
    web3/Theta stores) and the cross-cloud engine are among those both
    scans cover."""
    assert module in PORT_MODULES


def test_cross_cloud_entry_points_refuse_missing_cuda(monkeypatch):
    """The cross-cloud launchers default to ``cuda`` and raise without it,
    before any transport is opened."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = load_arguments_from_dict({
        "common_args": {"training_type": "cross_silo", "run_id": "no_cuda_cc"},
        "train_args": {"comm_round": 1}, "data_args": {"train_size": 64, "test_size": 16}})
    for fn in (fedml_tpu_torch.run_cross_cloud_server, fedml_tpu_torch.run_cross_cloud_client):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(args)


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.models.llm.llama",
    "fedml_tpu_torch.models.llm.convert",
    "fedml_tpu_torch.models.llm.hf_convert",
    "fedml_tpu_torch.utils.tree",
    "fedml_tpu_torch.ml.aggregator.agg_operator",
])
def test_llm_rest_slice_modules_are_scanned(module):
    """The mixture-of-experts model, the weight and exchange conversions, the
    HF checkpoint import (which takes a state dict and imports no
    ``transformers``) and the leaf-at-a-time aggregation are among those
    both scans cover."""
    assert module in PORT_MODULES


def test_hf_convert_imports_no_transformers():
    """``models/llm/hf_convert.py`` imports no ``transformers``; the CLI
    imports it only inside ``load_hf_checkpoint``."""
    import ast

    for path, allowed in ((PORT / "models" / "llm" / "hf_convert.py", set()),
                          (PORT / "cli.py", {"load_hf_checkpoint"})):
        tree = ast.parse(path.read_text())
        owner = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    owner.setdefault(id(node), fn.name)  # the outermost function
        found = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                if any(n.split(".")[0] == "transformers" for n in names):
                    found.add(owner.get(id(node)))
        assert found == allowed, (path, found)


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.fa",
    "fedml_tpu_torch.fa.constants",
    "fedml_tpu_torch.fa.fa_message_define",
    "fedml_tpu_torch.fa.base_frame",
    "fedml_tpu_torch.fa.analyzer",
    "fedml_tpu_torch.fa.aggregator",
    "fedml_tpu_torch.fa.fa_client_manager",
    "fedml_tpu_torch.fa.fa_server_manager",
    "fedml_tpu_torch.fa.run_inproc",
    "fedml_tpu_torch.fa.sketch",
    "fedml_tpu_torch.fa.sketch.sketches",
    "fedml_tpu_torch.fa.sketch.codec",
    "fedml_tpu_torch.fa.sketch.analyzers",
    "fedml_tpu_torch.fa.sketch.aggregators",
    "fedml_tpu_torch.fa.sketch.federation",
])
def test_fa_slice_modules_are_scanned(module):
    """Federated analytics' modules (the FSM, its analyzers and aggregators,
    the sketches, their codecs, the tree-scale federation) are among those
    both scans cover: none imports JAX or the reference package."""
    assert module in PORT_MODULES


def test_fa_entry_points_refuse_missing_cuda(monkeypatch):
    """``run_fa_inproc``, the operators' factories, ``run_sketch_federation``
    and the ``fa`` command default to ``cuda`` and raise without it, unless
    given the CPU."""
    import types

    from fedml_tpu_torch import cli
    from fedml_tpu_torch.fa import create_aggregator, create_analyzer, run_fa_inproc
    from fedml_tpu_torch.fa.sketch.federation import run_sketch_federation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = types.SimpleNamespace(run_id="no_cuda_fa", fa_task="cardinality", fa_sketch="auto",
                                 random_seed=0, rank=0)
    data = {1: ["a", "b"], 2: ["b", "c"]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fa_inproc(args, data)
    for make in (create_analyzer, create_aggregator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make("cardinality", args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sketch_federation(n_clients=16, levels=(1, 4, 16))
    for argv in (["fa"], ["fa", "--federation", "--fed-clients", "16"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert run_fa_inproc(args, data, device="cpu")["spec"] == "bloom@4096/4"
    out = run_sketch_federation(n_clients=16, levels=(1, 4, 16), codec="votevec@256/3",
                                vocab=32, device="cpu")
    assert out["stats"]["completed"] and out["heavy_hitters"] == out["ref_heavy_hitters"]


@pytest.mark.parametrize("module", [
    "fedml_tpu_torch.telemetry",
    "fedml_tpu_torch.telemetry.registry",
    "fedml_tpu_torch.telemetry.spans",
    "fedml_tpu_torch.telemetry.flight_recorder",
    "fedml_tpu_torch.telemetry.report",
    "fedml_tpu_torch.core.mlops",
    "fedml_tpu_torch.core.mlops.event",
    "fedml_tpu_torch.core.mlops.metrics",
    "fedml_tpu_torch.core.mlops.status",
    "fedml_tpu_torch.core.mlops.log_daemon",
    "fedml_tpu_torch.core.mlops.system_stats",
    "fedml_tpu_torch.mlops",
])
def test_span_layer_modules_are_scanned(module):
    """The span layer's modules (the registry, spans, the flight recorder,
    the report, the MLOps facades) are among those both scans cover: none
    imports JAX or the reference package, though several are copies of
    reference modules that import no JAX."""
    assert module in PORT_MODULES
