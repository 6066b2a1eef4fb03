"""Command line of the port (argparse; counterpart of the ``serve``,
``deploy broker``, ``chaos`` and ``tree`` commands of ``fedml_tpu/cli.py``).

    python -m fedml_tpu_torch.cli serve --model llama3_8b --quantize int8
    python -m fedml_tpu_torch.cli deploy broker --port 18923
    python -m fedml_tpu_torch.cli chaos --kill-server --seed 7 --rounds 4
    python -m fedml_tpu_torch.cli tree --clients 100000 --tiers 3 --codec int8

``chaos`` runs a seeded fault scenario against a cross-silo federation and
prints one JSON line (exit 1 unless it completed): message drop, duplicate
and delay, a client killed for a round window, a rank's uploads corrupted,
over an in-process federation (``resilience.run_chaos_scenario``); or with
``--kill-server`` the server itself SIGKILLed mid-round and respawned by a
supervisor, resuming from its write-ahead journal, the federation running
as OS processes over the broker (``resilience.durability.
run_recover_scenario``: MTTR, salvaged uploads, the final digest). It runs
on ``--device`` (``cuda`` unless ``cpu`` is asked for). The scheduler
tier's ``--drain`` and ``--agent-kill`` come with ROADMAP A13.

``tree`` runs a seeded hierarchical (aggregation-tree) federation in
process (``hierarchy.TreeRunner`` on ``--device``): virtual leaf clients
upload compressed deltas, edge aggregators forward partial sums in the
compressed block domain, every tier closes on quorum and survives a kill
window (``--kill-tier``/``--kill-node``/``--kill-round``). It prints one
JSON line and exits 1 on a below-quorum abort; the same ``--seed``
reproduces the same ``final_digest``. ``--metrics-port`` and
``--trace-rounds`` come with the telemetry stack, ROADMAP A12.

``deploy broker`` runs the federation's TCP pub/sub broker until
interrupted; a cross-silo server and its clients
(``run_cross_silo_server`` / ``run_cross_silo_client`` with ``comm_backend:
BROKER``) dial it, JAX peers included. ``--native`` (the reference's C++
broker) comes with ROADMAP A10.4.

``serve``
boots a continuous-batching Llama endpoint on one CUDA device: weights
are drawn on the device in bf16 from seed 0, quantized in place (int8
through the dequant-matmul kernel, ``w8a8`` int8 activations and weights,
or packed ``int4``/``nf4``; the full-precision kernels are dropped as
their quantized twins are built), and served over HTTP (``POST /predict``,
``GET /ready``, ``GET /metrics``). ``--checkpoint DIR`` serves a round
checkpoint the trainer wrote (``LLMTrainer.save_checkpoint``, e.g.
``<checkpoint_dir>/round_1``): restored into the model before quantization,
a LoRA payload (with ``--lora-rank``) merged onto the base; the LoRA leaves
stay f32 beside the quantized base, as the reference keeps them.
The live bridge, SLO flags and the OpenAI surface wait for later slices of
the port.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

QUANTIZE_CHOICES = ("int8", "int8_pallas", "int8_dequant", "w8a8", "int8_w8a8",
                    "int4", "nf4")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="fedml_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="boot a continuous-batching LLM "
                                         "inference endpoint (blocking)")
    serve.add_argument("--model", dest="model_size", default="tiny",
                       help="llama preset: tiny/llama2_7b/llama2_13b/llama3_8b")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8080)
    serve.add_argument("--batch-slots", type=int, default=4)
    serve.add_argument("--max-len", type=int, default=512)
    serve.add_argument("--lora-rank", type=int, default=0)
    serve.add_argument("--checkpoint", default=None,
                       help="round checkpoint directory to serve "
                            "(LLMTrainer.save_checkpoint); LoRA payloads merge "
                            "onto the base")
    serve.add_argument("--quantize", default=None, choices=QUANTIZE_CHOICES,
                       help="int8 weights: int8/int8_pallas run every ≤128-row "
                            "matmul through the CUDA dequant-matmul kernel, "
                            "int8_dequant through plain PyTorch, w8a8/int8_w8a8 "
                            "also quantize activations (int8 x int8 -> int32); "
                            "int4/nf4 keep 4-bit packed weights")
    serve.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    deploy = sub.add_parser("deploy", help="deploy-plane daemons")
    deploy_sub = deploy.add_subparsers(dest="daemon", required=True)
    broker = deploy_sub.add_parser("broker", help="run the federation's pub/sub "
                                                  "broker (blocking)")
    broker.add_argument("--host", default="127.0.0.1")
    broker.add_argument("--port", type=int, default=18923)
    broker.add_argument("--native", action="store_true",
                        help="the C++ epoll broker (not ported: ROADMAP A10.4)")
    chaos = sub.add_parser("chaos", help="run a seeded chaos scenario against a "
                                          "federation; prints one JSON line")
    chaos.add_argument("--seed", type=int, default=0,
                       help="chaos seed: fault decisions replay bit-identically")
    chaos.add_argument("--rounds", type=int, default=5)
    chaos.add_argument("--clients", type=int, default=3)
    chaos.add_argument("--kill-rank", type=int, default=None,
                       help="crash this client rank for a round window")
    chaos.add_argument("--kill-round", type=int, default=2)
    chaos.add_argument("--revive-round", type=int, default=None,
                       help="round at which the killed client's network heals "
                            "(default: kill-round + 1)")
    chaos.add_argument("--drop", type=float, default=0.0, help="P(drop) per sent message")
    chaos.add_argument("--duplicate", type=float, default=0.0,
                       help="P(duplicate) per sent message")
    chaos.add_argument("--delay-ms", type=float, default=0.0,
                       help="injected send delay in milliseconds")
    chaos.add_argument("--compression", default="", help="update codec (e.g. int8)")
    chaos.add_argument("--secagg", default="", help="masked secure aggregation (int8)")
    chaos.add_argument("--round-deadline-s", type=float, default=30.0)
    chaos.add_argument("--round-quorum", type=float, default=2.0 / 3.0)
    chaos.add_argument("--corrupt-rank", type=int, default=None,
                       help="corrupt this rank's model uploads at --corrupt-round")
    chaos.add_argument("--corrupt-round", type=int, default=1)
    chaos.add_argument("--corrupt-mode", default="nan", choices=("nan", "scale"))
    chaos.add_argument("--corrupt-factor", type=float, default=50.0)
    chaos.add_argument("--integrity", action="store_true",
                       help="arm the update-integrity rings")
    chaos.add_argument("--agg-robust", default="",
                       help="fused robust aggregation (trimmed_mean@0.1 | median)")
    chaos.add_argument("--kill-server", action="store_true",
                       help="SIGKILL the server mid-round (at --kill-round, after "
                            "--after-uploads journaled uploads) and supervise its "
                            "respawn with resume, as OS processes over the broker")
    chaos.add_argument("--after-uploads", type=int, default=1)
    chaos.add_argument("--drain", action="store_true",
                       help="scheduler-tier node drain (not ported: ROADMAP A13)")
    chaos.add_argument("--agent-kill", action="store_true",
                       help="scheduler-tier agent kill (not ported: ROADMAP A13)")
    chaos.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    tree = sub.add_parser("tree", help="run a seeded hierarchical (aggregation-tree) "
                                       "federation scenario; prints one JSON line")
    tree.add_argument("--clients", type=int, default=100_000,
                      help="virtual leaf clients in the cohort")
    tree.add_argument("--tiers", type=int, default=3,
                      help="tree depth incl. root and leaves")
    tree.add_argument("--rounds", type=int, default=2)
    tree.add_argument("--params", type=int, default=256,
                      help="virtual model size (elements)")
    tree.add_argument("--codec", default="int8",
                      help="wire codec at every tier (identity/bf16/int8/topk)")
    tree.add_argument("--seed", type=int, default=0,
                      help="scenario seed: two runs reproduce bit-identically")
    tree.add_argument("--quorum", type=float, default=2.0 / 3.0,
                      help="per-cohort close fraction")
    tree.add_argument("--kill-tier", type=int, default=None,
                      help="chaos: tier of the node to kill (e.g. 1 = edge)")
    tree.add_argument("--kill-node", type=int, default=0)
    tree.add_argument("--kill-round", type=int, default=1)
    tree.add_argument("--revive-round", type=int, default=None,
                      help="round the killed node comes back (default: +1)")
    tree.add_argument("--metrics-port", type=int, default=None,
                      help="live /metrics endpoint (not ported: ROADMAP A12)")
    tree.add_argument("--trace-rounds", default="",
                      help="rounds to capture a device trace of (not ported: ROADMAP A12)")
    tree.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def run_tree(args: argparse.Namespace) -> dict:
    """The ``tree`` command's scenario; returns its JSON-safe summary
    (``{"completed": False, "error": ...}`` on a below-quorum abort)."""
    from fedml_tpu_torch.hierarchy import (
        KillWindow,
        TreeRunner,
        TreeTopology,
        default_template,
    )

    if args.metrics_port is not None or args.trace_rounds:
        raise NotImplementedError("tree --metrics-port / --trace-rounds: live telemetry "
                                  "and device traces come with ROADMAP A12")
    chaos = []
    if args.kill_tier is not None:
        chaos.append(KillWindow(args.kill_tier, args.kill_node, args.kill_round,
                                until=args.revive_round))
    runner = TreeRunner(TreeTopology.build(args.clients, tiers=args.tiers),
                        template=default_template(args.params), codec=args.codec,
                        seed=args.seed, quorum=args.quorum, chaos=chaos, device=args.device)
    try:
        return runner.run(args.rounds)
    except RuntimeError as e:
        return {"completed": False, "error": str(e)}


def run_chaos(args: argparse.Namespace) -> dict:
    """The ``chaos`` command's scenario; returns its JSON-safe summary."""
    if args.drain or args.agent_kill:
        raise NotImplementedError("chaos --drain / --agent-kill: scheduler-tier chaos "
                                  "comes with the scheduler, ROADMAP A13")
    if args.kill_server:
        if args.secagg:
            raise ValueError("--kill-server with secagg is a round-boundary abort by "
                             "design (masks die with the session); run it without "
                             "--secagg to measure mid-round salvage")
        from fedml_tpu_torch.resilience.durability import run_recover_scenario

        return run_recover_scenario(
            seed=args.seed, rounds=args.rounds, clients=args.clients,
            kill_round=args.kill_round, after_uploads=args.after_uploads,
            compression=args.compression or "identity", device=args.device)
    from fedml_tpu_torch.resilience import run_chaos_scenario

    return run_chaos_scenario(
        seed=args.seed, rounds=args.rounds, clients=args.clients,
        kill_rank=args.kill_rank, kill_round=args.kill_round,
        revive_round=args.revive_round, drop=args.drop, duplicate=args.duplicate,
        delay_ms=args.delay_ms, compression=args.compression, secagg=args.secagg,
        round_deadline_s=args.round_deadline_s, round_quorum=args.round_quorum,
        corrupt_rank=args.corrupt_rank, corrupt_round=args.corrupt_round,
        corrupt_mode=args.corrupt_mode, corrupt_factor=args.corrupt_factor,
        integrity=args.integrity, agg_robust=args.agg_robust, device=args.device)


def run_broker(args: argparse.Namespace) -> None:
    """Serve the pub/sub broker until interrupted."""
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker

    if args.native:
        raise NotImplementedError(
            "deploy broker --native: the C++ epoll broker comes with ROADMAP A10.4")
    broker = PubSubBroker(args.host, args.port).start()
    print(f"broker on {broker.address[0]}:{broker.address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        broker.stop()


def build_endpoint(args: argparse.Namespace):
    """(engine, runner) for parsed ``serve`` arguments; nothing started."""
    from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM
    from fedml_tpu_torch.serving import (
        ContinuousBatchingEngine,
        EndpointMonitor,
        FedMLInferenceRunner,
        LlamaPredictor,
    )

    class _A:
        pass

    a = _A()
    a.model_size = args.model_size
    a.lora_rank = args.lora_rank or None
    # served weights are frozen: bf16 storage, no f32 masters
    a.base_params_bf16 = True
    cfg = LlamaConfig.from_args(a)
    model = LlamaForCausalLM(cfg, device=args.device, seed=0)
    if getattr(args, "checkpoint", None):
        from fedml_tpu_torch.train.llm.trainer import restore_checkpoint_into

        restore_checkpoint_into(model, args.checkpoint, lora_only=bool(args.lora_rank))
    engine = ContinuousBatchingEngine(
        model, batch_slots=args.batch_slots, max_len=args.max_len,
        quantize=args.quantize, quantize_donate=True, device=args.device)
    runner = FedMLInferenceRunner(
        LlamaPredictor(engine), host=args.host, port=args.port,
        monitor=EndpointMonitor(endpoint_id=args.model_size))
    # the engine forwards per-stream TTFT/TPOT to the endpoint monitor
    engine.model_slots.monitor = runner.monitor
    return engine, runner


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "deploy":
        run_broker(args)
    elif args.command in ("chaos", "tree"):
        out = run_chaos(args) if args.command == "chaos" else run_tree(args)
        print(json.dumps(out), flush=True)
        return 0 if out["completed"] else 1
    elif args.command == "serve":
        engine, runner = build_endpoint(args)
        print(f"serving {args.model_size} on http://{args.host}:{runner.port} "
              f"({args.device}, {torch.__version__})", flush=True)
        try:
            runner.run()
        except KeyboardInterrupt:
            pass
        finally:
            runner.stop()
            engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
