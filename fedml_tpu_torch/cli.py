"""Command line of the port (argparse; counterpart of the ``serve`` command
of ``fedml_tpu/cli.py``).

    python -m fedml_tpu_torch.cli serve --model llama3_8b --quantize int8

boots a continuous-batching Llama endpoint on one CUDA device: weights
are drawn on the device in bf16 from seed 0, quantized in place (int8
through the dequant-matmul kernel, ``w8a8`` int8 activations and weights,
or packed ``int4``/``nf4``; the full-precision kernels are dropped as
their quantized twins are built), and served over HTTP (``POST /predict``,
``GET /ready``, ``GET /metrics``).
Checkpoint loading, the live bridge, SLO flags and the OpenAI surface wait
for later slices of the port.
"""
from __future__ import annotations

import argparse
import sys
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
    serve.add_argument("--quantize", default=None, choices=QUANTIZE_CHOICES,
                       help="int8 weights: int8/int8_pallas run every ≤128-row "
                            "matmul through the CUDA dequant-matmul kernel, "
                            "int8_dequant through plain PyTorch, w8a8/int8_w8a8 "
                            "also quantize activations (int8 x int8 -> int32); "
                            "int4/nf4 keep 4-bit packed weights")
    serve.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    return parser


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
    if args.command == "serve":
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
