"""Command line of the port (argparse; counterpart of the ``serve``,
``deploy broker``, ``chaos``, ``tree``, ``fa``, ``telemetry report``,
``telemetry doctor`` and ``telemetry profile`` commands of
``fedml_tpu/cli.py``).

    python -m fedml_tpu_torch.cli serve --model llama3_8b --quantize int8
    python -m fedml_tpu_torch.cli deploy broker --port 18923
    python -m fedml_tpu_torch.cli chaos --kill-server --seed 7 --rounds 4
    python -m fedml_tpu_torch.cli tree --clients 100000 --tiers 3 --codec int8
    python -m fedml_tpu_torch.cli fa --task heavy_hitter_triehh
    python -m fedml_tpu_torch.cli fa --federation --fed-clients 102400
    python -m fedml_tpu_torch.cli telemetry report .fedml_logs/run_0
    python -m fedml_tpu_torch.cli telemetry doctor .fedml_logs/run_0 --json
    python -m fedml_tpu_torch.cli telemetry profile --rounds 0 -- python run.py

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
reproduces the same ``final_digest``. ``--trace-rounds 0,2`` captures a
``torch.profiler`` trace of those rounds (the budgeted trace controller)
into the run dir's ``traces/``; ``--metrics-port`` hosts the live plane
(a ``/metrics`` endpoint and the online doctor) for the run.

``telemetry report RUN_DIR`` reads a run's sinks (``spans.jsonl``,
``events.jsonl``, ``telemetry.jsonl``; ``<log_file_dir>/run_<run_id>``)
and prints each round's wall and phases, the phases' percentiles, the
slowest clients, the comm bytes and the spans stitched across processes
(``--json``: one sorted JSON object), and joins ``programs.jsonl`` (the
program catalog) against the phase walls into the roofline attribution.
It exits 1 on a directory with no spans and no metrics. It reads the JAX
package's run dirs too.

``telemetry doctor RUN_DIR [--json] [--straggler-threshold 2.0]
[--anomaly-threshold 4.0]`` triages the same run dir: the stragglers and
anomalous clients (from ``health.jsonl``'s ``client_health`` records), the
memory growth, the compression payoff, the faults the resilience, secagg,
integrity and tree layers absorbed, and the crash context of a dead run
from ``flight_recorder.jsonl``. It prints the verdict and a section each
(``--json``: one sorted JSON object), and exits 1 on a directory with no
telemetry of any kind.

``telemetry profile [--rounds 0,2] [--trace-dir DIR] -- CMD ...`` runs
CMD with ``FEDML_TRACE_ROUNDS`` / ``FEDML_TRACE_DIR`` set: every engine's
round loop in it captures a ``torch.profiler`` trace of exactly those
rounds into DIR (Chrome trace JSON), with a ``profile_capture`` marker in
the run's ``telemetry.jsonl`` and flight recorder.

``fa`` runs a federated-analytics round over seeded synthetic data on
``--device`` and prints one JSON line (exit 1 on a failed round): by
default the FA message FSM in process (``fa.run_fa_inproc``: sketch
submissions under the negotiated spec, ``--deadline-s``/``--quorum`` round
close) for any of the eight tasks; with ``--federation`` the heavy-hitter
vote federation over the aggregation tree with SecAgg and central DP
(``fa.sketch.federation.run_sketch_federation``). The same ``--seed`` gives
the same line.

``deploy broker`` runs the federation's TCP pub/sub broker until
interrupted; a cross-silo server and its clients
(``run_cross_silo_server`` / ``run_cross_silo_client`` with ``comm_backend:
BROKER``) dial it, JAX peers included. ``--native`` runs the C++ epoll
broker instead (``ops/csrc/broker.cpp``, built with the host compiler into
``build/fedml_tpu_torch/`` at first use), on the same frame protocol.

``serve``
boots a continuous-batching Llama endpoint on one CUDA device: weights
are drawn on the device in bf16 from seed 0, quantized in place (int8
through the dequant-matmul kernel, ``w8a8`` int8 activations and weights,
or packed ``int4``/``nf4``; the full-precision kernels are dropped as
their quantized twins are built), and served over HTTP (``POST /predict``,
``GET /ready``, ``GET /metrics``). ``--checkpoint DIR`` serves a round
checkpoint the trainer wrote (``LLMTrainer.save_checkpoint``, e.g.
``<checkpoint_dir>/round_1``): restored into the model before quantization,
a LoRA payload (with ``--lora-rank``) merged onto the base, a full one
(``--lora-rank 0``) replacing every weight; the LoRA leaves stay f32
beside the quantized base, as the reference keeps them.
``--hf-checkpoint DIR`` loads a HuggingFace Llama checkpoint first
(``models/llm/hf_convert.py``), read through ``transformers``, which is
imported only for this option and must be installed; ``--model`` must
name the checkpoint's widths and depth.
The live bridge, SLO flags and the OpenAI surface wait for later slices of
the port.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
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
    serve.add_argument("--hf-checkpoint", default=None, metavar="DIR",
                       help="HuggingFace Llama checkpoint directory to load before "
                            "quantization (needs the transformers package)")
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
                        help="the C++ epoll broker (ops/csrc/broker.cpp) instead of "
                             "the Python one")
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
                      help="host a live /metrics + /healthz scrape endpoint and the "
                           "online doctor for this tree run (0 = ephemeral)")
    tree.add_argument("--trace-rounds", default="",
                      help="comma-separated round indices to capture a device trace "
                           "of (budgeted trace controller)")
    tree.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    telemetry = sub.add_parser("telemetry", help="inspect a run's telemetry sinks")
    telemetry_sub = telemetry.add_subparsers(dest="tool", required=True)
    report = telemetry_sub.add_parser(
        "report", help="per-round timeline, span percentiles, comm bytes and stitched "
                       "spans of a run dir")
    report.add_argument("run_dir", help="a run's sink directory "
                                        "(<log_file_dir>/run_<run_id>)")
    report.add_argument("--json", dest="as_json", action="store_true",
                        help="emit the report as one JSON object")
    doctor = telemetry_sub.add_parser(
        "doctor", help="triage a run: stragglers, anomalous clients, memory growth, "
                       "compression, absorbed faults and the crash context")
    doctor.add_argument("run_dir", help="a run's sink directory "
                                        "(<log_file_dir>/run_<run_id>)")
    doctor.add_argument("--json", dest="as_json", action="store_true",
                        help="emit the raw triage dict as JSON")
    doctor.add_argument("--straggler-threshold", type=float, default=2.0,
                        help="flag clients whose median latency score exceeds this "
                             "multiple of the cohort median (default 2.0)")
    doctor.add_argument("--anomaly-threshold", type=float, default=4.0,
                        help="flag clients whose median per-round update-norm/loss "
                             "robust z exceeds this (default 4.0)")
    trace = telemetry_sub.add_parser(
        "trace", help="assemble the federation-wide causal trace and walk its "
                      "critical path")
    trace.add_argument("run_dir", help="a run's sink directory "
                                       "(<log_file_dir>/run_<run_id>)")
    trace.add_argument("--round", dest="round_idx", type=int, default=None,
                       help="restrict to ONE round index (default: all rounds)")
    trace.add_argument("--perfetto", dest="perfetto_out", default=None,
                       help="write a Perfetto/Chrome trace-event JSON file here")
    trace.add_argument("--json", dest="as_json", action="store_true",
                       help="emit the critical-path summary dict as JSON")
    watch = telemetry_sub.add_parser(
        "watch", help="refreshing per-round/per-node view of a live run (a /metrics "
                      "URL) or of a run dir")
    watch.add_argument("target", help="a live scrape endpoint URL (http://host:port) "
                                      "or a run dir")
    watch.add_argument("--interval", type=float, default=2.0,
                       help="refresh period in seconds (default 2.0)")
    watch.add_argument("--once", action="store_true",
                       help="render a single frame and exit")
    profile = telemetry_sub.add_parser(
        "profile", help="run CMD with device-trace capture armed for some rounds")
    profile.add_argument("--rounds", dest="trace_rounds", default="0",
                         help="comma-separated round indices to trace (default 0)")
    profile.add_argument("--trace-dir", default=".fedml_logs/traces",
                         help="where the captures land (default .fedml_logs/traces)")
    profile.add_argument("cmd", nargs=argparse.REMAINDER,
                         help="the command to run, after --")
    fa = sub.add_parser("fa", help="run a federated-analytics round over seeded synthetic "
                                   "data; prints one JSON line")
    fa.add_argument("--task", default="frequency_estimation",
                    help="FA task (frequency_estimation, heavy_hitter_triehh, histogram, "
                         "k_percentile_element, union, intersection, cardinality, avg)")
    fa.add_argument("--clients", type=int, default=6, help="FSM clients (in-proc transport)")
    fa.add_argument("--sketch", default="auto",
                    help="sketch codec spec (cms@W/D, votevec@W/D, bloom@B/H, hist@N/lo/hi, "
                         "'auto' picks per task, '' = plaintext)")
    fa.add_argument("--seed", type=int, default=0)
    fa.add_argument("--query", default="",
                    help="comma-separated items to point-query in the result")
    fa.add_argument("--theta", type=int, default=2, help="TrieHH vote threshold")
    fa.add_argument("--deadline-s", type=float, default=0.0,
                    help="round deadline (0 = wait for every client)")
    fa.add_argument("--quorum", type=float, default=None,
                    help="round close fraction once the deadline fires")
    fa.add_argument("--federation", action="store_true",
                    help="run the tree-scale heavy-hitter federation (secagg + central DP "
                         "over TreeRunner) instead of FSM rounds")
    fa.add_argument("--fed-clients", type=int, default=4096,
                    help="virtual clients for --federation")
    fa.add_argument("--fed-tiers", type=int, default=3)
    fa.add_argument("--dp-sigma", type=float, default=0.0,
                    help="central Gaussian noise std on the root sum (--federation only)")
    fa.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


_FA_WORDS = ("sun", "moon", "star", "rain", "wind", "sea", "sky", "fog", "ice", "ash")


def run_fa(args: argparse.Namespace) -> dict:
    """The ``fa`` command: the FA message FSM in process over seeded data
    (sketch submissions under the negotiated spec, deadline/quorum close),
    or with ``--federation`` the heavy-hitter vote federation over the
    aggregation tree with SecAgg and central DP, on ``--device``. Returns the
    JSON-safe result (``{"completed": False, "error": ...}`` on a failed
    round); the same ``--seed`` gives the same result."""
    import types

    import numpy as np

    from fedml_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.federation:
        from fedml_tpu_torch.fa.sketch.federation import run_sketch_federation

        out = run_sketch_federation(n_clients=args.fed_clients, tiers=args.fed_tiers,
                                    seed=args.seed, secagg=True, dp_sigma=args.dp_sigma,
                                    device=device)
        out.pop("stats", None)
        return out
    from fedml_tpu_torch.fa.run_inproc import run_fa_inproc

    rng = np.random.default_rng(args.seed)
    numeric = args.task in ("histogram", "k_percentile_element", "avg")
    data = {}
    for r in range(1, int(args.clients) + 1):
        if numeric:
            data[r] = rng.uniform(0, 100, 64).tolist()
        else:
            # a zipf-ish head: low word ids dominate, so the heavy-hitter and
            # frequency tasks have discoverable structure
            idx = np.minimum(rng.zipf(1.5, 64) - 1, len(_FA_WORDS) - 1)
            data[r] = [_FA_WORDS[i] for i in idx]
    fa_args = types.SimpleNamespace(
        run_id=f"fa_cli_{args.seed}", random_seed=args.seed, rank=0, fa_task=args.task,
        fa_sketch=args.sketch, fa_theta=args.theta,
        fa_query_items=[q for q in args.query.split(",") if q])
    if args.deadline_s > 0:
        fa_args.round_deadline_s = float(args.deadline_s)
    if args.quorum is not None:
        fa_args.round_quorum = float(args.quorum)
    try:
        out = run_fa_inproc(fa_args, data, device=device)
    except (RuntimeError, ValueError, TimeoutError) as e:
        return {"completed": False, "error": str(e)}
    if out is None:
        return {"completed": False, "error": "federation aborted"}
    out = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in out.items()}
    return {"completed": True, **out}


def run_tree(args: argparse.Namespace) -> dict:
    """The ``tree`` command's scenario; returns its JSON-safe summary
    (``{"completed": False, "error": ...}`` on a below-quorum abort)."""
    from fedml_tpu_torch.hierarchy import (
        KillWindow,
        TreeRunner,
        TreeTopology,
        default_template,
    )

    from fedml_tpu_torch.telemetry.profiling import get_trace_controller, parse_rounds

    armed = parse_rounds(args.trace_rounds)
    if armed:
        get_trace_controller().arm_rounds(armed)
    chaos = []
    if args.kill_tier is not None:
        chaos.append(KillWindow(args.kill_tier, args.kill_node, args.kill_round,
                                until=args.revive_round))
    live = None
    if args.metrics_port is not None:
        from fedml_tpu_torch.telemetry.live import LivePlane

        live = LivePlane(job=f"tree_{args.seed}", node="tree_root",
                         metrics_port=args.metrics_port)
        print(f"live telemetry: {live.url}/metrics (watch: python -m fedml_tpu_torch.cli "
              f"telemetry watch {live.url})", file=sys.stderr, flush=True)
    runner = TreeRunner(TreeTopology.build(args.clients, tiers=args.tiers),
                        template=default_template(args.params), codec=args.codec,
                        seed=args.seed, quorum=args.quorum, chaos=chaos, live=live,
                        device=args.device)
    try:
        return runner.run(args.rounds)
    except RuntimeError as e:
        return {"completed": False, "error": str(e)}
    finally:
        if live is not None:
            live.close()


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
    from fedml_tpu_torch.core.distributed.communication.broker import (
        NativePubSubBroker,
        PubSubBroker,
    )

    cls = NativePubSubBroker if args.native else PubSubBroker
    broker = cls(args.host, args.port).start()
    print(f"broker on {broker.address[0]}:{broker.address[1]}"
          + (" (native)" if args.native else ""), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        broker.stop()


def load_hf_checkpoint(model, path: str):
    """Read a HuggingFace Llama checkpoint directory with ``transformers``
    (its own dtype kept) and convert it into ``model`` in place."""
    try:
        from transformers import AutoModelForCausalLM
    except ImportError as e:
        raise RuntimeError(
            f"serve --hf-checkpoint {path}: reading a HuggingFace checkpoint needs the "
            f"'transformers' package, which is not installed") from e
    from fedml_tpu_torch.models.llm.hf_convert import convert_hf_llama_state_dict

    print(f"loading HF checkpoint {path} ...", flush=True)
    hf = AutoModelForCausalLM.from_pretrained(path, torch_dtype="auto")
    convert_hf_llama_state_dict(hf.state_dict(), model)
    del hf
    return model


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
    if getattr(args, "hf_checkpoint", None):
        load_hf_checkpoint(model, args.hf_checkpoint)
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


def run_telemetry_report(args) -> int:
    """``telemetry report``: the report of a run dir, as text or JSON; exit 1
    when the directory holds no spans and no metrics at all (a partial run
    still reports, with a "no data" note a section)."""
    from fedml_tpu_torch.telemetry.report import build_report, format_report

    report = build_report(args.run_dir)
    if not report["n_spans"] and not report["n_metrics"]:
        print(f"no spans or metrics recorded under {args.run_dir}", flush=True)
        return 1
    if args.as_json:
        report = {**report, "stitched_spans": len(report["stitched_spans"])}
        print(json.dumps(report, indent=1, sort_keys=True, default=str), flush=True)
    else:
        print(format_report(report), flush=True)
    return 0


def run_telemetry_doctor(args) -> int:
    """``telemetry doctor``: the triage of a run dir, as text or JSON; exit 1
    when the directory holds no telemetry of any kind."""
    from fedml_tpu_torch.telemetry.doctor import build_doctor, format_doctor

    triage = build_doctor(args.run_dir, straggler_threshold=args.straggler_threshold,
                          anomaly_threshold=args.anomaly_threshold)
    if "run" in triage["notes"]:
        print(triage["notes"]["run"], flush=True)
        return 1
    if args.as_json:
        print(json.dumps(triage, indent=1, sort_keys=True, default=str), flush=True)
    else:
        print(format_doctor(triage), flush=True)
    return 0


def run_telemetry_trace(args) -> int:
    """``telemetry trace``: the run dir's causal trace (``spans.jsonl`` and the
    live plane's ``spans_remote.jsonl`` on one clock-aligned timeline) and
    each round's critical path, as text or JSON, optionally exported to
    Perfetto; exit 1 on a dir with no spans or no round spans."""
    from fedml_tpu_torch.telemetry.report import load_programs
    from fedml_tpu_torch.telemetry.tracing import (
        assemble_trace,
        compute_critical_paths,
        summarize_critical_paths,
        write_perfetto,
    )

    run_dir = args.run_dir
    trace = assemble_trace(run_dir)
    if not trace.spans:
        print(f"no spans recorded under {run_dir}", flush=True)
        return 1
    rounds = [int(args.round_idx)] if args.round_idx is not None else None
    programs = load_programs(run_dir)
    cps = compute_critical_paths(trace, rounds=rounds, programs=programs or None)
    if args.perfetto_out:
        write_perfetto(trace, args.perfetto_out, critical_paths=cps, rounds=rounds)
        print(f"perfetto trace -> {args.perfetto_out} (load at https://ui.perfetto.dev)",
              file=sys.stderr, flush=True)
    if args.as_json:
        summary = summarize_critical_paths(cps)
        summary["schema"] = "fedml_tpu.telemetry.trace/v1"
        summary["run_dir"] = run_dir
        summary["nodes"] = trace.nodes
        summary["clocks"] = [trace.clocks[n].to_dict() for n in sorted(trace.clocks)]
        print(json.dumps(summary, indent=1, sort_keys=True, default=str), flush=True)
        return 0
    lines = [f"causal trace: {run_dir}",
             f"  nodes: {', '.join(trace.nodes)} (reference clock: {trace.ref_node})"]
    for node in sorted(trace.clocks):
        c = trace.clocks[node]
        if c.method == "reference":
            continue
        unc = (f"±{c.uncertainty_s * 1e3:.1f} ms" if c.uncertainty_s is not None
               else "unbounded")
        lines.append(f"  clock {node}: offset {c.offset_s * 1e3:+.1f} ms "
                     f"{unc} ({c.method}, {c.pairs} pair(s))")
    if not cps:
        lines.append("  no round spans found — nothing to walk")
        print("\n".join(lines), flush=True)
        return 1
    for cp in cps:
        d = cp.to_dict()
        lines.append(f"\nround {d['round']}: path {d['path_ms']:.1f} ms / "
                     f"wall {d['wall_ms']:.1f} ms (coverage {100 * d['coverage']:.0f}%)")
        for seg in cp.segments:
            label = seg.phase + (f" [{seg.program}]" if seg.program else "")
            lines.append(f"  {seg.duration_ms:>9.2f} ms  {seg.kind:<8s}"
                         f"{seg.node:<18s}{label}")
        st = d.get("straggler")
        if st:
            where = "ON the critical path" if st["on_critical_path"] else "has slack"
            lines.append(f"  straggler client {st['client']}: {where} "
                         f"(what-if savings {st['savings_ms']:.1f} ms)")
        for flag in d.get("flags") or []:
            lines.append(f"  note: {flag}")
    print("\n".join(lines), flush=True)
    return 0


def run_telemetry_watch(args) -> int:
    """``telemetry watch``: the live plane's per-node view of a scrape URL or
    a run dir; exit 1 when the target cannot be read."""
    from fedml_tpu_torch.telemetry.live import watch

    return watch(args.target, interval_s=args.interval, once=args.once)


def run_telemetry_profile(args) -> int:
    """``telemetry profile``: CMD's exit code, after running it with the
    trace arm exported; lists the captures made under the trace dir."""
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("telemetry profile: no command given", file=sys.stderr, flush=True)
        return 2
    env = {**os.environ, "FEDML_TRACE_ROUNDS": args.trace_rounds,
           "FEDML_TRACE_DIR": args.trace_dir}
    rc = subprocess.call(cmd, env=env)
    if os.path.isdir(args.trace_dir):
        for name in sorted(os.listdir(args.trace_dir)):
            print(f"trace: {os.path.join(args.trace_dir, name)}", file=sys.stderr,
                  flush=True)
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "telemetry":
        return {"profile": run_telemetry_profile, "doctor": run_telemetry_doctor,
                "report": run_telemetry_report, "trace": run_telemetry_trace,
                "watch": run_telemetry_watch}[args.tool](args)
    if args.command == "deploy":
        run_broker(args)
    elif args.command in ("chaos", "tree", "fa"):
        run = {"chaos": run_chaos, "tree": run_tree, "fa": run_fa}[args.command]
        out = run(args)
        print(json.dumps(out), flush=True)
        return 0 if out.get("completed", True) else 1
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
