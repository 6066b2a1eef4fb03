#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases — any failure raises, and the script then exits non-zero without
the final ``ok`` line:

(a) print the card's name and power limit; build every CUDA kernel of the
    port from ``fedml_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all
    started together) and print the build time and, for each kernel, its
    registers, dynamic shared memory and spill bytes;
(b) hold the int8 dequant-matmul kernel against its plain PyTorch version
    at every Llama-3-8B projection shape and 1/8/16/32/64/128 rows, row by
    row (each output row within 2^-8 of its own norm), show that two
    planted faults (one split's partial sum missing, the last 16 columns
    missing) fail that check and that two launches give the same bits, and
    time the kernel, the plain version and a one-call PyTorch yardstick
    with CUDA events, beside the card's bound for the same work, with each
    row count's sum over one pass's 225 launches;
(c) serve Llama-3-8B at full width (random bf16 weights from a seed,
    quantized to int8 in place) through the port's ``serve`` entry point:
    8 HTTP requests (4 concurrent) of 20–120 prompt tokens and 32 new tokens
    each, with the kernel's launch count read around exactly that run; then
    time steady decode at 8 slots, and check the served logits are finite
    and agree with the plain int8 lowering on a short prompt;
(d) hold the three flash-attention kernels (forward, dq, dk/dv) against
    their plain PyTorch versions in bf16 at Llama-3-8B's heads (B=1, 32 q
    heads over 8 KV heads, head_dim 128) for T=S=2048 causal (the training
    shape), T=S=1000 causal (ragged), T=S=512 full and T=256/S=512 causal
    (top-left alignment), row by row (``row_rel_err``), show at T=2048
    that two planted faults fail that check and that two launches of the
    backward give bit-identical dq, dk and dv, and time each kernel (with
    its achieved TFLOP/s), its plain version and
    ``scaled_dot_product_attention`` (forward; backward) beside the bound;
(e) after the serve phase's weights are freed, run federated LoRA rounds
    of Llama-3-8B at full width and depth through ``FedLLMAPI`` with the
    on-device round (rank 16, bf16 base, T=2048, batch 1, 4 of 8 clients ×
    2 local steps, 2 rounds, test each round), with the flash launch counts
    read around exactly ``train()`` and required to be 32 per forward and
    backward; print seconds per round, tokens/s, peak memory and the device
    busy share of one round (with its device time by kernel class); hold
    layer 0's attention output and LoRA gradients, every layer's flash
    output on the model's own activations, and the model's loss on one
    batch, kernels against plain versions;
(f) the quantized formats at Llama-3-8B's widths: what ``torch._int_mm``
    takes (16 rows or not; the weight's layout, timed both ways), the w8a8
    product against its plain version on the CPU at every
    projection shape and 1/8/16/17/128/2048 rows (activation codes and
    int32 accumulators bit for bit, outputs row by row); int4 and nf4
    quantized and dequantized on the card to the CPU's bits for layer 0's
    seven kernels and the LM head; one 225-launch pass at 8 and 128 rows
    timed for w8a8, nf4 dequant + matmul and bf16 ``torch.matmul`` beside
    the int8 kernel's (phase b) and each pass's bound; then Llama-3-8B
    served with ``--quantize w8a8`` and ``--quantize nf4`` (4 HTTP requests,
    2 concurrent, 16 new tokens each) with decode ms/step at 8 slots, TTFT
    and the served bytes, finite logits, and one prompt's greedy tokens
    equal to the plain lowering of the same quantized weights;
(g) after phase (e)'s weights are freed, phase (e) again over an nf4 base
    (QLoRA, ``base_quantize: nf4``): the same launch counts and checks, the
    packed base bit-identical before and after ``train()``, the
    ``quant/base_bytes`` gauge equal to the packed bytes, its round time,
    tokens/s, busy share, device time by class and peak memory beside
    phase (e)'s (the peak at least 5 GB lower); then one round over an int8
    base;
(h) the single-process FedAvg simulation through ``create_simulator``:
    ResNet-18 (GroupNorm, 2 groups) at full width on ``load_cifar10``'s
    stand-in at CIFAR-10's size (50,000 + 10,000 images of 32×32×3), 10 of
    10 hetero clients (α 0.5), batch 32, one epoch of SGD at lr 0.1, int8
    uplinks with error feedback, 3 rounds with a test each; it fails unless
    one client's 4 steps from the run's final weights on the card agree
    with the CPU's and with a float64 run, ``fused_weighted_sum`` on the card is
    within 1e-6 of decoding each upload and summing, the int8 and nf4 wire
    bytes of the run's delta are identical on the card and the CPU, the
    test loss falls from round 0 to round 2 and every round's parameters
    are finite and on the card; it prints each round's seconds, test loss
    and accuracy, encode and fused-aggregation ms, the steady round's
    training samples/s, the busy share of 20 profiled local steps, the
    peak memory and the uplink bytes against f32;
(i) cross-silo FedAvg on phase h's model and data (no hand kernel lies on
    this path either). (i1) ``run_cross_silo_inproc``'s federation over the
    in-process LOCAL transport on the card: 4 of 4 hetero silos (α 0.5),
    int8 uplinks with error feedback, 2 rounds; one client's first upload is
    posted twice. It fails unless the server reports 2 rounds, the test loss
    falls from round 0 to round 1, every upload that reached the server is
    an int8 delta at least 3.9x smaller than the f32 tree, and the duplicate
    was dropped once; it prints each round's seconds, test loss and
    accuracy, the steady round's training samples/s, the peak memory, and
    (CUDA events, the last round's work replayed) the encode, the fused
    aggregation and the layout conversions of a round. (i2) the port's
    ``PubSubBroker`` on an ephemeral localhost port, an object-store
    directory under a temp dir, and the server and 2 silos as three OS
    processes started through ``run_cross_silo_server`` /
    ``run_cross_silo_client`` with a config file the phase writes (a fixed
    ``PYTHONHASHSEED``), 1 round; it fails unless every process exits 0
    within CS_BROKER_TIMEOUT_S, the server reports 1 round and the broadcast
    went through the store, and prints the bytes published on the broker
    and written to the store, the ``safe_dumps`` / ``safe_loads`` ms of the
    broadcast and of one upload, and the round's wall. Each phase prints
    its seconds.

The last lines are the card line, one ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with code 2 and prints no result. The full per-shape results also go to
``results/chip_smoke.json``. ``--phases d`` (any subset of ``bcdefghi``) runs
(a) and the phases named, and prints no kernels or ok line (phase g sets
its round beside phase e's only when both run). ``--parent DIR`` builds the dequant and flash-forward kernels of
another checkout (DIR, e.g. the parent commit unpacked by ``git archive``)
and times them beside this tree's in phases b and d.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# (H, F) of every int8 projection of Llama-3-8B and how often one forward
# pass calls it: q/o 4096x4096, k/v 4096x1024, gate/up 4096x14336,
# down 14336x4096 in each of 32 layers, and the LM head 4096x128256
SLICE_SHAPES = {
    (4096, 4096): 2 * 32,
    (4096, 1024): 2 * 32,
    (4096, 14336): 2 * 32,
    (14336, 4096): 32,
    (4096, 128256): 1,
}
ROWS = (1, 8, 16, 32, 64, 128)   # decode slots and the serve path's prefill buckets
DECODE_ROWS = 8                 # the serve phase decodes 8 slots
LAUNCHES_PER_PASS = sum(SLICE_SHAPES.values())  # 225
N_REQUESTS, N_CONCURRENT, NEW_TOKENS = 8, 4, 32
KERNEL_SOURCES = ("dequant_matmul", "flash_attention")

# Flash attention at Llama-3-8B's heads (B=1, H=32 over Hkv=8, head_dim 128):
# (T, S, causal) — the training path's shape, one ragged against the 64-row
# tiles, one non-causal, one with T != S (top-left causal alignment)
FLASH_HEADS = (1, 32, 8, 128)
FLASH_SHAPES = ((2048, 2048, True), (1000, 1000, True), (512, 512, False),
                (256, 512, True))
# bf16 outputs and gradients are held row by row (see row_rel_err): every
# row's error within ROW_TOL of that row's own norm. The kernels round p and
# ds to bf16 before the second product of each pair (the plain versions keep
# f32) and round the result once, each ~2^-9 of relative noise; 2^-6 leaves
# a margin of ~4x, while a fault that drops one 64-key tile of a late row
# (~18% of its terms) misses it by ~10x. Rows below ROW_FLOOR of a typical
# row are held to that floor. lse sees no bf16 rounding (exact products, f32
# sums, fast exp): 1e-3 absolute.
ROW_TOL, ROW_FLOOR, LSE_TOL = 2.0 ** -6, 1e-3, 1e-3
# planted faults the row check must catch at the path's shape, T=S=2048
# causal: dk/dv that skips the last 64-row q tile, and dq that drops keys
# [128, 192) for rows from 512 on; the old limit (2e-2 of the tensor's
# largest magnitude) is printed beside the row check for comparison
FAULT_Q_TILE, FAULT_KEYS, FAULT_ROW0, OLD_REL_TOL = 64, (128, 192), 512, 2e-2
# dequant outputs row by row: both versions add exact products in f32 and
# round once to bf16 (2^-9 relative at most), so each row within 2^-8 of
# its own norm; planted faults at two split-K shapes must fail that check
DEQUANT_ROW_TOL = 2.0 ** -8
DEQUANT_FAULT_SHAPES = ((4096, 1024), (14336, 4096))

# Phase (e): federated LoRA rounds of Llama-3-8B at full width and depth
# (random bf16 base from seed 0, the repo's synthetic Markov token stream)
# through FedLLMAPI's on-device round; remat off, as the JAX bench runs it
TRAIN_ARGS = dict(
    model_size="llama3_8b", lora_rank=16, base_params_bf16=True, remat_policy="none",
    use_flash_attention=True, max_seq_length=2048, per_device_batch_size=1,
    client_num_in_total=8, client_num_per_round=4, local_steps_per_round=2,
    comm_round=2, on_device_round=True, vocab_size=128256, train_size=32,
    test_size=2, random_seed=0, learning_rate=1e-4, frequency_of_the_test=1)
# layer 0's attention (o_proj output per token, each LoRA gradient per rank
# component) through the kernels vs their plain versions, and every layer's
# flash output on the model's own activations, row by row within ROW_TOL;
# the whole model's loss on one batch within 1e-3 relative (17x the 5.9e-5
# measured on an H100)
LOSS_REL_TOL = 1e-3

# Phase (f): the w8a8 product's row counts (decode 1 and 8, both sides of
# torch._int_mm's 16-row limit, a prefill bucket and a long prefill), the
# 4-bit formats, and the serve runs of phase (f)
W8A8_ROWS = (1, 8, 16, 17, 128, 2048)
PASS_ROWS = (8, 128)
QUANT_SERVE_MODES = ("w8a8", "nf4")
QUANT_REQUESTS, QUANT_CONCURRENT, QUANT_NEW_TOKENS = 4, 2, 16
# layer 0's seven kernels and the LM head, by parameter name
LAYER0_KERNELS = {
    "layer_0.attn.q_proj.kernel": (4096, 4096), "layer_0.attn.k_proj.kernel": (4096, 1024),
    "layer_0.attn.v_proj.kernel": (4096, 1024), "layer_0.attn.o_proj.kernel": (4096, 4096),
    "layer_0.mlp.gate_proj.kernel": (4096, 14336), "layer_0.mlp.up_proj.kernel": (4096, 14336),
    "layer_0.mlp.down_proj.kernel": (14336, 4096), "lm_head": (4096, 128256),
}
# Phase (g): the QLoRA round's peak memory must sit at least this far below
# the bf16 round's (linear weights 15.0 GB in bf16, 4.22 GB in nf4)
QLORA_PEAK_MARGIN_GB = 5.0

# Phase (h): the single-process FedAvg simulation (ROADMAP A8 + A9):
# ResNet-18 with GroupNorm (2 groups) at full width on load_cifar10's
# stand-in at CIFAR-10's size (50,000 train and 10,000 test images of
# 32x32x3, 10 classes), 10 of 10 clients (hetero, alpha 0.5), batch 32, one
# local epoch of SGD at lr 0.1 (fedml_tpu/config/cross_silo/fedml_config.yaml),
# int8 uplinks with error feedback, 3 rounds with a test after each. The
# simulation runs convolutions and matmuls in full FP32 (TF32 off: the
# port's default for it). From the run's final weights one client's
# SP_CPU_STEPS steps run on the card, on the CPU and in float64 on the card;
# the card's float32 result must lie within SP_PARAM_TOL of each leaf's
# largest magnitude (floored at 1) of both. Four SGD steps at lr 0.1 on this
# unnormalized stand-in amplify rounding ~1e4-fold: on an H100's host CPU
# float32 landed 3.6e-4 to 7.0e-4 from float64 from trained weights, and
# 4.9e-3 from the initial ones, where the first step lifts the loss from
# ~3.4 to ~20; the stand-in differs per process (``hash`` in its seed), so
# the factor does too. TF32 rounds each product's inputs 8192 times coarser
# (2^-11 against 2^-24), which this amplification would carry to the
# weights' own scale: 1e-2 sits well above float32's spread and far below
# TF32's or a wrong kernel's.
SP_CONFIG = {
    "common_args": {"training_type": "simulation", "random_seed": 0},
    "data_args": {"dataset": "cifar10", "train_size": 50_000, "test_size": 10_000,
                  "partition_method": "hetero", "partition_alpha": 0.5},
    "model_args": {"model": "resnet18", "group_norm_channels": 2},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 10,
                   "client_num_per_round": 10, "comm_round": 3, "epochs": 1,
                   "batch_size": 32, "learning_rate": 0.1, "compression": "int8",
                   "frequency_of_the_test": 1},
}
SP_CPU_STEPS = 4
SP_PARAM_TOL = 1e-2
SP_FUSED_REL_TOL = 1e-6
SP_PROFILE_STEPS = 20
SP_CODECS = ("int8", "nf4")

# Phase (i), cross-silo FedAvg: phase h's model, data and training
# (``fedml_tpu/config/cross_silo/fedml_config.yaml``'s recipe at ResNet-18
# scale) split over 4 silos, int8 uplinks with error feedback, 2 rounds on
# the in-process LOCAL transport (i1); then one round of 2 silos over the TCP
# broker and the object store with the server and each silo in its own OS
# process (i2), started through the entry points with a config the phase
# writes. i2's processes share a fixed PYTHONHASHSEED: the stand-in's seed
# has ``hash("cifar10")`` in it, salted per process, and the three must draw
# the same data. An int8 upload carries 1 byte an element plus one f32 scale
# a leaf: 4.00x smaller than f32 for this model, so 3.9x is the floor.
CS_CONFIG = {
    "common_args": {"training_type": "cross_silo", "random_seed": 0,
                    "run_id": "chip_smoke_cross_silo"},
    "data_args": {"dataset": "cifar10", "train_size": 50_000, "test_size": 10_000,
                  "partition_method": "hetero", "partition_alpha": 0.5},
    "model_args": {"model": "resnet18", "group_norm_channels": 2},
    "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                   "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                   "batch_size": 32, "learning_rate": 0.1, "compression": "int8"},
    "comm_args": {"comm_backend": "LOCAL"},
}
CS_WIRE_RATIO = 3.9
CS_BROKER_SILOS = 2
CS_BROKER_TIMEOUT_S = 480        # i2: every process exits 0 within this
CS_HASHSEED = "0"
CS_TIMED_REPS = 5

# Published dense peaks (NVIDIA data sheets): memory bytes/s and bf16 FLOP/s.
PEAKS = (
    ("H100", "PCIE", 2.0e12, 756e12),
    ("H100", "NVL", 3.9e12, 835e12),
    ("H100", "", 3.35e12, 989e12),
    ("H200", "", 4.8e12, 989e12),
)


def card_peaks(name: str):
    up = name.upper()
    for family, variant, bw, flops in PEAKS:
        if family in up and variant in up:
            return bw, flops
    raise RuntimeError(f"no peak table entry for {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def build_kernels():
    """Build every kernel source in parallel; returns seconds and logs."""
    from fedml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for fut in [pool.submit(_build.build, n) for n in KERNEL_SOURCES]:
            fut.result()
    for n in KERNEL_SOURCES:
        _build.load(n)
    return time.perf_counter() - t0, dict(_build.build_logs)


def ptxas_report(log: str):
    """Per kernel of an ``nvcc -Xptxas -v`` log: {name<D>: registers, spill
    store and load bytes, stack frame bytes}."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            # the kernel's own name: the <length><name> pair that ends in _kernel
            base = next((mangled[m.end():m.end() + int(m.group())]
                         for m in re.finditer(r"\d+", mangled)
                         if mangled[m.end():m.end() + int(m.group())].endswith("_kernel")),
                        mangled)
            args = re.search(r"I((?:Li\d+E)+)E", mangled)
            name = base + (f"<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
                           if args else "")
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def device_ms(calls, reps: int) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls
    that rotate through ``calls``. A device-side sleep first backs the
    stream up, so host launch overhead never paces the measured calls."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parent_kernels(parent_dir: str):
    """The dequant-matmul and flash-forward kernels of another checkout
    (``parent_dir``), built from its sources with this tree's nvcc flags
    into ``results/parent_build`` and bound with ctypes from the argument
    lists of its ``extern "C"`` declarations: ``(dequant(x, q, scale),
    flash_fwd(q, k, v, causal, scale))`` on the current stream."""
    import ctypes
    import re

    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import quant

    out_dir = os.path.abspath(os.path.join("results", "parent_build"))
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(parent_dir, "fedml_tpu_torch", "ops", "csrc")

    def build(name):
        so = os.path.join(out_dir, f"lib{name}.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(csrc, f"{name}.cu")], check=True, capture_output=True)
        return ctypes.CDLL(so)

    def bind(lib, source, fn_name):
        with open(os.path.join(csrc, f"{source}.cu")) as f:
            decl = re.search(rf"int {fn_name}\(([^)]*)\)", f.read()).group(1)
        params = [p.split()[0] for p in decl.split(",")]
        fn = getattr(lib, fn_name)
        fn.argtypes = [{"int": ctypes.c_int, "float": ctypes.c_float}.get(p, ctypes.c_void_p)
                       for p in params]
        fn.restype = ctypes.c_int
        return fn, len(params)

    with ThreadPoolExecutor(2) as pool:
        dq_lib, fa_lib = pool.map(build, ("dequant_matmul", "flash_attention"))
    for lib in (dq_lib, fa_lib):
        lib.fedml_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    deq, n_deq = bind(dq_lib, "dequant_matmul", "fedml_dequant_matmul_bf16")
    fwd, _ = bind(fa_lib, "flash_attention", "fedml_flash_fwd_bf16")

    def dequant(x, q, scale):
        rows, h = x.shape
        f = q.shape[1]
        out = torch.empty((rows, f), dtype=torch.bfloat16, device=x.device)
        # this tree's split count where the entry point takes one (the
        # kernel before split-K has 8 parameters and no split)
        splits = [quant.dequant_splits(h, f)] if n_deq == 9 else []
        code = deq(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, h, f,
                   *splits, torch.cuda.current_stream().cuda_stream)
        _build.check(dq_lib, code, "parent dequant_matmul launch")
        return out

    def flash_fwd(q, k, v, causal, scale):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        b, h, t, d = q.shape
        code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                   b, h, k.shape[1], t, k.shape[2], d, int(causal), scale,
                   torch.cuda.current_stream().cuda_stream)
        _build.check(fa_lib, code, "parent flash forward launch")
        return out, lse

    return dequant, flash_fwd


def dequant_faults(quant, x, q, scale, want):
    """Two faulty results the row check must reject, made by the kernel on
    altered inputs: one split's partial sum missing (x zeroed over rank 0's
    H-rows: its whole partial sum is then 0) and the last 16 columns
    missing (their scales zeroed). Returns {fault: row measure}."""
    h, f = q.shape
    x_cut = x.clone()
    x_cut[:, :h // quant.dequant_splits(h, f)] = 0
    s_cut = scale.clone()
    s_cut[-16:] = 0
    out = {"missing_one_split": row_rel_err(quant.dequant_matmul_cuda(x_cut, q, scale), want),
           "missing_last_16_columns": row_rel_err(quant.dequant_matmul_cuda(x, q, s_cut), want)}
    print(f"    planted faults at H={h} F={f} ({quant.dequant_splits(h, f)} splits): "
          + ", ".join(f"{n} row measure {v:.4g}" for n, v in out.items())
          + f" (limit {DEQUANT_ROW_TOL:.4g})", flush=True)
    if not all(v > DEQUANT_ROW_TOL for v in out.values()):
        raise RuntimeError(f"the row check passes a planted dequant fault: {out}")
    return out


def kernel_phase(peak_bw: float, peak_flops: float, parent=None):
    """Phase (b): kernel vs plain version at every slice shape and row
    count, and the times of one pass's 225 launches at each row count."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = []
    for (h, f) in SLICE_SHAPES:
        w = torch.randn(h, f, device="cuda", generator=gen)
        qt = quant.quantize_int8(w, mode="kernel")
        del w
        # rotate through enough weight copies to exceed the 50 MB L2, as the
        # decode step does (7.5 GB of weights stream through once per step)
        n_copies = max(2, min(32, math.ceil(256e6 / (h * f))))
        qs = [qt.data] + [qt.data.clone() for _ in range(n_copies - 1)]
        ss = [qt.scale] + [qt.scale.clone() for _ in range(n_copies - 1)]
        qts = [q.t().contiguous() for q in qs]      # [F, H] for the yardstick
        s16 = qt.scale.to(torch.bfloat16)
        for rows in ROWS:
            x = torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
            got = quant.dequant_matmul_cuda(x, qt.data, qt.scale)
            again = quant.dequant_matmul_cuda(x, qt.data, qt.scale)
            want = quant.dequant_matmul_reference(x, qt.data, qt.scale, torch.bfloat16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            held = row_rel_err(got, want)
            identical = bool(torch.equal(got, again))
            if not (held <= DEQUANT_ROW_TOL and identical):
                raise RuntimeError(f"kernel disagrees with its plain version at H={h} F={f} "
                                   f"rows={rows}: row measure {held} > {DEQUANT_ROW_TOL}, "
                                   f"or two launches differ ({identical})")
            faults = (dequant_faults(quant, x, qt.data, qt.scale, want)
                      if (h, f) in DEQUANT_FAULT_SHAPES and rows == DECODE_ROWS else None)
            library = "torch._weight_int8pack_mm"
            try:
                torch._weight_int8pack_mm(x, qts[0], s16)
                lib_calls = [lambda i=i: torch._weight_int8pack_mm(x, qts[i], s16)
                             for i in range(n_copies)]
            except (RuntimeError, AttributeError):
                library = "x @ q.to(bf16) * scale"
                lib_calls = [lambda i=i: (x @ qs[i].to(torch.bfloat16)) * s16
                             for i in range(n_copies)]
            reps = 20 if h * f < 1e8 else 10
            kernel_calls = [lambda i=i: quant.dequant_matmul_cuda(x, qs[i], ss[i])
                            for i in range(n_copies)]
            ms = device_ms(kernel_calls, reps)
            parent_ms = None if parent is None else device_ms(
                [lambda i=i: parent(x, qs[i], ss[i]) for i in range(n_copies)], reps)
            plain_ms = device_ms(
                [lambda i=i: quant.dequant_matmul_reference(x, qs[i], ss[i],
                                                            torch.bfloat16)
                 for i in range(n_copies)], reps)
            library_ms = device_ms(lib_calls, reps)
            ms_again = device_ms(kernel_calls, reps)
            nbytes = h * f + 2 * rows * (h + f) + 4 * f
            flops = 2 * rows * h * f
            bytes_ms, flops_ms = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
            rec = dict(H=h, F=f, rows=rows, splits=quant.dequant_splits(h, f),
                       max_abs_err=err, row_measure=held, tol=DEQUANT_ROW_TOL,
                       bit_identical=identical, planted_faults=faults, ms=ms,
                       ms_again=ms_again, parent_ms=parent_ms, plain_ms=plain_ms,
                       library_ms=library_ms, library=library,
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                       weight_gb_per_s=h * f / ms / 1e6)
            results.append(rec)
            print(f"  H={h:5d} F={f:6d} rows={rows:3d}  row measure {held:.3g} (max abs "
                  f"{err:.3g})  kernel {ms:.4f} / {ms_again:.4f} ms  parent "
                  + ("not measured" if parent_ms is None else f"{parent_ms:.4f} ms")
                  + f"  plain {plain_ms:.4f} ms  {library} {library_ms:.4f} ms  bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})  "
                  f"{rec['weight_gb_per_s']:.0f} GB/s", flush=True)
        del qs, ss, qts, qt
        torch.cuda.empty_cache()
    print("  one pass of 225 launches (the sum over the shapes):", flush=True)
    for rows in ROWS:
        sums = {k: step_sum(results, k, rows) for k in
                ("ms", "ms_again", "parent_ms", "library_ms", "plain_ms", "bound_ms")}
        print(f"    rows={rows:3d}  kernel {sums['ms']:.4f} / {sums['ms_again']:.4f} ms  "
              "parent " + ("not measured" if sums["parent_ms"] is None
                           else f"{sums['parent_ms']:.4f} ms")
              + f"  torch._weight_int8pack_mm {sums['library_ms']:.4f} ms  plain "
              f"{sums['plain_ms']:.4f} ms  bound {sums['bound_ms']:.4f} ms", flush=True)
    return results


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows (the last dim: one query's or key's head vector,
    one token's hidden vector, one row of a gradient) of ``|got - want| /
    max(|want|, ROW_FLOOR * rms)`` in L2, with rms the root mean square of
    the plain rows' norms. The floor holds a row that cancels to rounding
    noise (causal dq's first row: p = 1 there, so dp - delta is 0 but for
    rounding) to a small share of a typical row instead of to its own noise.
    A non-finite value gives nan, which fails any limit."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    err = torch.linalg.vector_norm(g - w, dim=-1)
    ref = torch.linalg.vector_norm(w, dim=-1)
    ref = ref.clamp_min(ROW_FLOOR * ref.square().mean().sqrt())
    ratio = torch.where(ref > 0, err / ref.clamp_min(torch.finfo(torch.float32).tiny),
                        torch.where(err > 0, torch.inf, 0.0))
    if not torch.isfinite(g).all():
        return math.nan
    return ratio.max().item()


def old_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over the tensor's largest magnitude."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def attention_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs the masked attention computes: Σ_r min(r + 1, S)
    under the top-left causal mask, T·S without it."""
    if not causal:
        return t * s
    n = min(t, s)
    return n * (n + 1) // 2 + (t - n) * s


def flash_bounds(b, h, hkv, d, t, s, causal, peak_bw, peak_flops):
    """Least time of each kernel: max(FLOPs / peak, bytes / bandwidth), with
    every input read once and every output written once. Products: forward
    q k^T and p v (4 FLOPs per pair and dim), dq adds dO v^T and ds k (6),
    dk/dv q k^T, p^T dO, dO v^T and ds^T q (8)."""
    pairs = attention_pairs(t, s, causal)
    q_bytes, kv_bytes, rows = 2 * b * h * t * d, 2 * b * hkv * s * d, 4 * b * h * t
    work = {
        "flash_fwd": (4, 2 * q_bytes + 2 * kv_bytes + rows),
        "flash_bwd_dq": (6, 3 * q_bytes + 2 * kv_bytes + 2 * rows),
        "flash_bwd_dkv": (8, 2 * q_bytes + 4 * kv_bytes + 2 * rows),
    }
    out = {}
    for name, (per_pair, nbytes) in work.items():
        flops = per_pair * b * h * d * pairs
        flops_ms = flops / peak_flops * 1e3
        bytes_ms = nbytes / peak_bw * 1e3
        out[name] = (max(flops_ms, bytes_ms),
                     "operations" if flops_ms >= bytes_ms else "bytes", flops)
    return out


def planted_faults(fa, q, k, v, do, lse, delta, scale, want):
    """Two faulty backward results the row check must reject, made from the
    kernels' own outputs: dk/dv that skip the last q tile (the kernel run
    with those rows' lse at +inf, so their p and ds are 0), and dq that
    drops one 64-key tile for rows from FAULT_ROW0 on (the kernel's dq less
    that tile's share, which the plain version computes without a mask:
    every such row sees the whole tile). Returns {fault: {tensor: (row
    measure, old measure)}} and raises if the row check passes a fault."""
    lse_cut = lse.clone()
    lse_cut[..., -FAULT_Q_TILE:] = math.inf
    dk_f, dv_f = fa.flash_dkv_cuda(q, k, v, do, lse_cut, delta, True, scale)
    k0, k1 = FAULT_KEYS
    r0 = FAULT_ROW0
    share = fa.flash_dq_reference(q[:, :, r0:], k[:, :, k0:k1], v[:, :, k0:k1],
                                  do[:, :, r0:], lse[:, :, r0:], delta[:, :, r0:],
                                  False, scale)
    dq_f = fa.flash_dq_cuda(q, k, v, do, lse, delta, True, scale).float()
    dq_f[:, :, r0:] -= share.float()
    faults = {
        "dkv_skips_last_q_tile": {"dk": (dk_f, want["dk"]), "dv": (dv_f, want["dv"])},
        "dq_drops_a_kv_tile": {"dq": (dq_f, want["dq"])},
    }
    out = {}
    for fault, tensors in faults.items():
        out[fault] = {n: (row_rel_err(g, w), old_rel_err(g, w))
                      for n, (g, w) in tensors.items()}
        print(f"    planted fault {fault}: "
              + ", ".join(f"{n} row measure {r:.4g} (limit {ROW_TOL:.4g}), old measure "
                          f"{o:.4g} (limit {OLD_REL_TOL})" for n, (r, o) in out[fault].items()),
              flush=True)
        if not all(r > ROW_TOL for r, _ in out[fault].values()):
            raise RuntimeError(f"the row check passes the planted fault {fault}: "
                               f"{out[fault]}")
    return out


def flash_phase(peak_bw: float, peak_flops: float, parent_fwd=None):
    """Phase (d): the three flash-attention kernels against their plain
    versions in bf16, and their times beside the bound and a one-call
    PyTorch yardstick (``scaled_dot_product_attention`` and its backward)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from fedml_tpu_torch.ops import flash_attention as fa

    b, h, hkv, d = FLASH_HEADS
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = []
    for t, s, causal in FLASH_SHAPES:
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

        q, k, v, do = randn(b, h, t, d), randn(b, hkv, s, d), randn(b, hkv, s, d), \
            randn(b, h, t, d)
        out, lse = fa.flash_forward_cuda(q, k, v, causal, scale)
        delta = fa.attention_delta(do, out)
        dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, causal, scale)
        dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
        # each kernel's plain version on the same inputs (the backward ones
        # take the kernel's own lse and delta, so each kernel is held alone)
        out_p, lse_p = fa.flash_forward_reference(q, k, v, causal, scale)
        dq_p = fa.flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
        dk_p, dv_p = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        # {name: (max abs error, measure held, limit)}: lse absolute, the
        # bf16 tensors row by row
        errs = {}
        for name, got, want in (("out", out, out_p), ("lse", lse, lse_p), ("dq", dq, dq_p),
                                ("dk", dk, dk_p), ("dv", dv, dv_p)):
            err = (got.float() - want.float()).abs().max().item()
            held, tol = (err, LSE_TOL) if name == "lse" else (row_rel_err(got, want), ROW_TOL)
            errs[name] = (err, held if torch.isfinite(got).all() else math.nan, tol)
        print(f"  T={t:4d} S={s:4d} causal={int(causal)}  max abs error / held / limit: "
              + ", ".join(f"{n} {e:.3g} / {h_:.3g} / {tl:.3g}"
                          for n, (e, h_, tl) in errs.items()), flush=True)
        if not all(h_ <= tl for _, h_, tl in errs.values()):
            raise RuntimeError(f"a flash kernel disagrees with its plain version at "
                               f"T={t} S={s} causal={causal}: {errs}")
        faults = identical = None
        if (t, s, causal) == FLASH_SHAPES[0]:
            faults = planted_faults(fa, q, k, v, do, lse, delta, scale,
                                    dict(dq=dq_p, dk=dk_p, dv=dv_p))
            # the backward is deterministic: no atomics, a fixed sum order
            again = (fa.flash_dq_cuda(q, k, v, do, lse, delta, causal, scale),
                     *fa.flash_dkv_cuda(q, k, v, do, lse, delta, causal, scale))
            identical = {n: bool(torch.equal(a, b_)) for n, a, b_ in
                         zip(("dq", "dk", "dv"), (dq, dk, dv), again)}
            print(f"    two launches bit-identical: {identical}", flush=True)
            if not all(identical.values()):
                raise RuntimeError(f"two backward launches differ: {identical}")
            del again

        reps = 20
        ms = {
            "flash_fwd": device_ms([lambda: fa.flash_forward_cuda(q, k, v, causal, scale)],
                                   reps),
            "flash_bwd_dq": device_ms([lambda: fa.flash_dq_cuda(
                q, k, v, do, lse, delta, causal, scale)], reps),
            "flash_bwd_dkv": device_ms([lambda: fa.flash_dkv_cuda(
                q, k, v, do, lse, delta, causal, scale)], reps),
        }
        fwd_again = device_ms([lambda: fa.flash_forward_cuda(q, k, v, causal, scale)], reps)
        parent_fwd_ms = None if parent_fwd is None else device_ms(
            [lambda: parent_fwd(q, k, v, causal, scale)], reps)
        plain_ms = {
            "flash_fwd": device_ms([lambda: fa.flash_forward_reference(
                q, k, v, causal, scale)], 5),
            "flash_bwd_dq": device_ms([lambda: fa.flash_dq_reference(
                q, k, v, do, lse, delta, causal, scale)], 5),
            "flash_bwd_dkv": device_ms([lambda: fa.flash_dkv_reference(
                q, k, v, do, lse, delta, causal, scale)], 5),
        }
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o_lib = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)
        lib_fwd = device_ms([lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)],
                            reps)
        lib_bwd = device_ms([lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do, retain_graph=True)], reps)
        del qg, kg, vg, o_lib
        bounds = flash_bounds(b, h, hkv, d, t, s, causal, peak_bw, peak_flops)
        tflops = {n: v[2] / ms[n] / 1e9 for n, v in bounds.items()}
        rec = dict(T=t, S=s, causal=causal, errors=errs, planted_faults=faults,
                   bit_identical=identical, ms=ms, fwd_again_ms=fwd_again,
                   parent_fwd_ms=parent_fwd_ms, plain_ms=plain_ms,
                   library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
                   bound_ms={n: v[0] for n, v in bounds.items()},
                   bound_by={n: v[1] for n, v in bounds.items()}, tflops_per_s=tflops)
        results.append(rec)
        for n in ms:
            lib = lib_fwd if n == "flash_fwd" else lib_bwd
            print(f"    {n:14s} kernel {ms[n]:.4f} ms ({tflops[n]:.1f} TFLOP/s)  plain "
                  f"{plain_ms[n]:.4f} ms  bound {bounds[n][0]:.4f} ms ({bounds[n][1]})  "
                  f"{'sdpa fwd' if n == 'flash_fwd' else 'sdpa bwd (dq+dk+dv)'} "
                  f"{lib:.4f} ms", flush=True)
        print(f"    flash_fwd again {fwd_again:.4f} ms; parent's forward "
              + ("not measured" if parent_fwd_ms is None else f"{parent_fwd_ms:.4f} ms"),
              flush=True)
        print(f"    backward pair dq + dk/dv {ms['flash_bwd_dq'] + ms['flash_bwd_dkv']:.4f} ms "
              f"against sdpa bwd {lib_bwd:.4f} ms", flush=True)
        del q, k, v, do, out, lse, delta, dq, dk, dv, out_p, lse_p, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    return results


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def serve_phase():
    """Phase (c): Llama-3-8B int8 served over HTTP through the kernel."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.models.llm.llama import rope_tables
    from fedml_tpu_torch.ops import quant
    from fedml_tpu_torch.telemetry import get_registry

    args = build_parser().parse_args(
        ["serve", "--model", "llama3_8b", "--quantize", "int8", "--batch-slots",
         "8", "--max-len", "512", "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, runner = build_endpoint(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    model = engine.params
    cfg = model.cfg
    served_gb = quant.tree_bytes(model) / 1e9
    print(f"  booted llama3_8b int8 in {boot_s:.1f} s: {served_gb:.3f} GB of weights, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated", flush=True)
    runner.start()
    try:
        rng = np.random.default_rng(0)
        lens = rng.integers(20, 121, size=N_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
        bodies = [{"prompt_tokens": p, "max_new_tokens": NEW_TOKENS} for p in prompts]

        # --- the main path, with the launch count read around exactly it ---
        engine.oplog.clear()
        quant.DEQUANT_MATMUL_LAUNCHES = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CONCURRENT) as pool:
            first = list(pool.map(lambda b: post(runner.port, b), bodies[:N_CONCURRENT]))
        rest = [post(runner.port, b) for b in bodies[N_CONCURRENT:]]
        wall_s = time.perf_counter() - t0
        launches = quant.DEQUANT_MATMUL_LAUNCHES
        ops = list(engine.oplog)

        for r in first + rest:
            toks = r.get("tokens")
            if (not isinstance(toks, list) or len(toks) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab_size for t in toks)):
                raise RuntimeError(f"bad response: {r}")
        n_decode = sum(1 for op in ops if op[0] in ("decode", "decode_part"))
        n_prefill = sum(1 for op in ops if op[0] == "prefill")
        n_prefill_small = sum(1 for op in ops if op[0] == "prefill" and op[1] <= 128)
        expected = LAUNCHES_PER_PASS * (n_decode + n_prefill_small)
        print(f"  {N_REQUESTS} requests ({N_CONCURRENT} concurrent) in {wall_s:.2f} s: "
              f"{n_prefill} prefills ({n_prefill_small} of <=128 rows), {n_decode} "
              f"decode steps; kernel launches {launches} (expected >= {expected})",
              flush=True)
        if launches < expected or launches == 0:
            raise RuntimeError(f"the serve path launched the kernel {launches} "
                               f"times, expected at least {expected}")
        ttft = get_registry().histogram("serving/ttft_ms").snapshot()
        tpot = get_registry().histogram("serving/tpot_ms").snapshot()
        print(f"  TTFT over {ttft['count']} requests: p50 {ttft['p50']:.2f} ms, "
              f"p95 {ttft['p95']:.2f} ms, max {ttft['max']:.2f} ms; TPOT p50 "
              f"{tpot['p50']:.2f} ms, p95 {tpot['p95']:.2f} ms (engine histograms)",
              flush=True)
    finally:
        runner.stop()
        engine.stop()
    if engine.failure is not None:
        raise RuntimeError("serving engine failed") from engine.failure

    step_s, dev_step_ms, busy = steady_decode(engine, rng)

    # --- served outputs are right: the served model through the kernel
    # against the same int8 codes through the kernel's plain version (same
    # single rounding), on a 48-token prompt. One full-width block must
    # agree within 2e-2 of its largest output. Through all 32 layers of
    # random weights a 1-ulp bf16 difference is amplified (two roundings of
    # the same codes already differ by ~2% of the largest logit), so the
    # logits are held to finite values of the vocab width and a 2e-2
    # relative L2 distance, prefill and one decode step; the plain-PyTorch
    # int8 lowering's distance is printed beside it for scale. ---
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 48))).cuda()
    qts = [v for mod in model.modules() for v in vars(mod).values()
           if isinstance(v, quant.QuantizedTensor)]

    def run(mode):
        for q in qts:
            q.mode = mode
        with torch.inference_mode():
            x = torch.nn.functional.embedding(tokens, model.embed_tokens).to(cfg.dtype)
            cos, sin = rope_tables(torch.arange(48, device="cuda"), cfg.head_dim,
                                   cfg.rope_theta)
            block, _ = model.layer_0(x, cos, sin, model.init_kv_caches(1, 64)[0])
            caches = model.init_kv_caches(1, 64)
            lp, caches = model(tokens, kv_caches=caches)
            ld, _ = model(tokens[:, -1:], positions=torch.tensor([[48]], device="cuda"),
                          kv_caches=caches)
        return block, lp, ld

    kernel = quant.dequant_matmul_cuda
    try:
        k_out = run("kernel")
        quant.dequant_matmul_cuda = (  # route the kernel path to its plain version
            lambda x, q, s: quant.dequant_matmul_reference(x, q, s, torch.bfloat16))
        p_out = run("kernel")
        quant.dequant_matmul_cuda = kernel
        d_out = run("dequant")
    finally:
        quant.dequant_matmul_cuda = kernel
        for q in qts:
            q.mode = "kernel"

    def rel_max(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    for got in k_out[1:]:
        if not torch.isfinite(got).all() or got.shape[-1] != cfg.vocab_size:
            raise RuntimeError("served logits are not finite / of the vocab width")
    block_err = rel_max(k_out[0], p_out[0])
    vs_plain = (rel_l2(k_out[1], p_out[1]), rel_l2(k_out[2], p_out[2]))
    vs_dequant = (rel_l2(k_out[1], d_out[1]), rel_l2(k_out[2], d_out[2]))
    print(f"  layer_0 kernel vs plain version {block_err:.4g} of its max output; "
          f"logits finite, relative L2 to the plain version {vs_plain[0]:.4g} "
          f"(prefill), {vs_plain[1]:.4g} (decode); to the dequant lowering "
          f"{vs_dequant[0]:.4g}, {vs_dequant[1]:.4g}", flush=True)
    if block_err > 2e-2 or max(vs_plain) > 2e-2:
        raise RuntimeError(f"the kernel's model disagrees with its plain version: "
                           f"block {block_err}, logits {vs_plain}")
    mem = dict(allocated_gb=torch.cuda.memory_allocated() / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  memory allocated {mem['allocated_gb']:.3f} GB, peak {mem['peak_gb']:.3f} GB",
          flush=True)
    return dict(launches=launches, expected_launches=expected, decode_steps=n_decode,
                prefills=n_prefill, prefills_le128=n_prefill_small,
                http_wall_s=wall_s, ttft_ms=ttft, tpot_ms=tpot,
                decode_ms_per_step=step_s * 1e3, tokens_per_s=engine.n_slots / step_s,
                device_ms_per_step=dev_step_ms, device_busy_share=busy, boot_s=boot_s, served_weights_gb=served_gb,
                layer0_vs_plain=block_err, logits_l2_vs_plain=vs_plain,
                logits_l2_vs_dequant=vs_dequant, **mem)


def steady_decode(engine, rng, n_steps: int = 30, n_prof: int = 5):
    """Steady decode with every slot busy, the engine driven directly:
    ``(seconds a step on the host's clock, device ms a step from the
    profiler or None, busy share or None)``, printed."""
    vocab = engine.cfg.vocab_size
    for _ in range(engine.n_slots):
        engine.submit(rng.integers(0, vocab, size=64).tolist(),
                      max_new_tokens=n_steps + n_prof + 10)
    for _ in range(engine.n_slots):
        engine._admit(engine._requests.get_nowait())
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    step_s = (time.perf_counter() - t0) / n_steps
    # device time per step from the profiler's kernel records; the wall time
    # is the unprofiled one above (the profiler slows the host side)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            engine.step()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    dev_step_ms = dev_us / 1e3 / n_prof if dev_us > 0 else None
    busy = dev_step_ms / (step_s * 1e3) if dev_step_ms else None
    print(f"  decode at {engine.n_slots} slots: {step_s * 1e3:.2f} ms/step, "
          f"{engine.n_slots / step_s:.1f} tokens/s; device time "
          + ("not measured" if busy is None else
             f"{dev_step_ms:.2f} ms/step (profiler, {n_prof} steps), busy share {busy:.3f}"),
          flush=True)
    while engine.active_slots:  # finish the streams: every slot free again
        engine.step()
    return step_s, dev_step_ms, busy


def plain_flash_route():
    """Context manager routing the flash wrappers to their plain versions
    (same signatures), so the model runs the same code minus the kernels."""
    import contextlib

    from fedml_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def route():
        saved = (fa.flash_forward_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda)
        fa.flash_forward_cuda = fa.flash_forward_reference
        fa.flash_dq_cuda = fa.flash_dq_reference
        fa.flash_dkv_cuda = fa.flash_dkv_reference
        try:
            yield
        finally:
            fa.flash_forward_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda = saved

    return route()


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low or "flash_bwd" in low:
        return "flash attention (port kernels)"
    if "indexselect" in low or "scatter_gather" in low:
        return "gather (4-bit dequant lookups, embedding)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, rope, softmax/CE, optimizer)"


def train_step_flops(cfg, batch: int, t: int) -> float:
    """Model FLOPs of one LoRA training step: every projection and the LM
    head forward and its activation gradient (2 + 2 FLOPs per weight per
    token; the frozen base gets no weight gradient), the adapters' forward
    and both gradients (2 + 4), and the attention kernels' products
    (4 + 6 + 8 per (query, key) pair and head dim, causal)."""
    h, d, kv = cfg.hidden_size, cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    proj = 2 * h * h + 2 * h * kv + 3 * h * cfg.intermediate_size
    lora = cfg.lora_rank * (2 * (h + h) + 2 * (h + kv))
    tokens = batch * t
    per_layer = (4 * proj + 6 * lora) * tokens + 18 * batch * cfg.num_attention_heads \
        * d * attention_pairs(t, t, True)
    return cfg.num_hidden_layers * per_layer + 4 * h * cfg.vocab_size * tokens


def train_phase(light: bool = False, **overrides):
    """Phase (e), and with ``base_quantize`` in ``overrides`` phase (g):
    federated LoRA rounds of Llama-3-8B through FedLLMAPI. A quantized base
    must come out of ``train()`` bit-identical. ``light`` stops after
    ``train()`` (its round times, launches and peak memory)."""
    import types

    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import causal_lm_loss, rope_tables
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops.quant import named_quantized_weights
    from fedml_tpu_torch.telemetry import get_registry
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    from fedml_tpu_torch.train.llm.trainer import extract_lora

    args = types.SimpleNamespace(**{**TRAIN_ARGS, **overrides})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = FedLLMAPI(args, "cuda", load_synthetic_lm(args))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    engine, cfg = api.client.engine, api.cfg
    lora_n = sum(p.numel() for p in extract_lora(engine.model).values())
    def quantized_weights(model):
        return [q for _, q in named_quantized_weights(model)]

    base = quantized_weights(engine.model)
    base_bytes = sum(q.data.numel() * q.data.element_size() + 4 * q.scale.numel()
                     for q in base)
    print(f"  booted {args.model_size} (LoRA rank {cfg.lora_rank}, {lora_n} adapter parameters"
          + (f"; {len(base)} base kernels {args.base_quantize}, {base_bytes / 1e9:.3f} GB"
             if base else "")
          + f") in {boot_s:.1f} s: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)
    base_gauge = None
    if base and args.base_quantize in ("int4", "nf4"):
        base_gauge = get_registry().gauge("quant/base_bytes").value
        if base_gauge != base_bytes:
            raise RuntimeError(f"quant/base_bytes gauge {base_gauge} != the packed "
                               f"leaves' {base_bytes} bytes")
    # the frozen base, on the host (kept off the card: its peak is measured)
    base0 = [(q.data.cpu(), q.scale.cpu()) for q in base]

    rounds = []
    inner = api.train_one_round

    def recorded(r):
        rep = inner(r)
        rep["lora_b_max"] = max(float(v.abs().max()) for k, v in
                                api.global_exchange.items() if k.endswith("lora_b"))
        rounds.append(rep)
        return rep

    api.train_one_round = recorded
    # --- the main path, with the launch counts read around exactly it ---
    fa.FLASH_FWD_LAUNCHES = fa.FLASH_DQ_LAUNCHES = fa.FLASH_DKV_LAUNCHES = 0
    t0 = time.perf_counter()
    summary = api.train()
    train_wall_s = time.perf_counter() - t0
    launches = {"flash_fwd": fa.FLASH_FWD_LAUNCHES, "flash_bwd_dq": fa.FLASH_DQ_LAUNCHES,
                "flash_bwd_dkv": fa.FLASH_DKV_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frozen = all(torch.equal(q.data.cpu(), d0) and torch.equal(q.scale.cpu(), s0)
                 for q, (d0, s0) in zip(quantized_weights(engine.model), base0))
    if base:
        print(f"  quantized base bit-identical after train(): {frozen} ({len(base0)} "
              f"kernels" + ("" if base_gauge is None else
                            f"; quant/base_bytes gauge {base_gauge:.0f} B = the packed "
                            f"leaves' bytes") + ")", flush=True)
    if not frozen or len(quantized_weights(engine.model)) != len(base0):
        raise RuntimeError("the quantized base changed in train()")

    layers, clients = cfg.num_hidden_layers, args.client_num_per_round
    steps = clients * args.local_steps_per_round * args.comm_round
    evals = len(api.test_history)
    expected = {"flash_fwd": layers * (steps + evals), "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
    tokens_per_round = (clients * args.local_steps_per_round * args.per_device_batch_size
                        * args.max_seq_length)
    for rep in rounds:
        print(f"  round {rep['round']}: {rep['round_sec']:.3f} s, train loss "
              f"{rep['train_loss']:.4f}, test loss {rep.get('test_loss', float('nan')):.4f}, "
              f"global lora_b max |.| {rep['lora_b_max']:.3g}", flush=True)
    steady = rounds[-1]["round_sec"]
    step_flops = train_step_flops(cfg, args.per_device_batch_size, args.max_seq_length)
    round_flops = step_flops * clients * args.local_steps_per_round
    print(f"  train(): {args.comm_round} rounds in {train_wall_s:.2f} s (with "
          f"{evals} evals); steady round {steady:.3f} s = "
          f"{tokens_per_round / steady:.1f} tokens/s, {round_flops / steady / 1e12:.1f} "
          f"TFLOP/s of model FLOPs ({step_flops:.4g} a step); peak memory {peak_gb:.3f} GB; "
          f"launches {launches} (expected {expected})", flush=True)
    if launches != expected or min(launches.values()) == 0:
        raise RuntimeError(f"flash launches {launches} != expected {expected}")
    if not all(math.isfinite(r["train_loss"]) and math.isfinite(r["test_loss"])
               for r in rounds):
        raise RuntimeError(f"non-finite losses: {rounds}")
    if not rounds[0]["lora_b_max"] > 0:
        raise RuntimeError("the global lora_b is still zero after round 0")
    result = dict(launches=launches, expected_launches=expected, rounds=rounds,
                  summary={k: v for k, v in summary.items() if isinstance(v, (int, float))},
                  boot_s=boot_s, train_wall_s=train_wall_s,
                  tokens_per_round=tokens_per_round, tokens_per_s=tokens_per_round / steady,
                  steady_round_s=steady, step_flops=step_flops,
                  model_tflops_per_s=round_flops / steady / 1e12, peak_gb=peak_gb,
                  lora_params=lora_n, base_quantize=getattr(args, "base_quantize", ""),
                  base_bytes=base_bytes, base_kernels=len(base))
    if light:
        return result

    # --- device busy share of one round: profiler device time over the
    # unprofiled wall of the same round ---
    xs, ys, ms, w = api.round_batch(args.comm_round)

    def one_round():
        _, _, new_global, loss = api._fed_round(engine.params, engine.opt_state,
                                                api.global_exchange, xs, ys, ms, w)
        return float(loss)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    round_wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_round()
    by_class, by_kernel = {}, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            ms_ = e.self_device_time_total / 1e3
            by_kernel.append((ms_, e.count, e.key))
            c = kernel_class(e.key)
            by_class[c] = by_class.get(c, 0.0) + ms_
    dev_ms = sum(by_class.values())
    busy = dev_ms / (round_wall_s * 1e3) if dev_ms else None
    print(f"  one round: {round_wall_s * 1e3:.1f} ms unprofiled wall; device time "
          + ("not measured" if busy is None else
             f"{dev_ms:.1f} ms (profiler), busy share {busy:.3f}"), flush=True)
    for c, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {c}: {v:.1f} ms", flush=True)
    by_kernel.sort(reverse=True)
    for ms_, count, key in by_kernel[:12]:
        print(f"    {ms_:9.2f} ms  x{count:<6d} {key[:90]}", flush=True)

    # --- layer 0's attention (with its LoRA adapters, as trained), forward
    # and backward, kernels vs plain versions: the o_proj output, not the
    # block's, which the residual stream dominates ---
    gen = torch.Generator(device="cuda").manual_seed(99)
    t = args.max_seq_length
    x = torch.randn(1, t, cfg.hidden_size, device="cuda", generator=gen).to(cfg.dtype)
    dout = torch.randn(1, t, cfg.hidden_size, device="cuda", generator=gen).to(cfg.dtype)
    cos, sin = rope_tables(torch.arange(t, device="cuda"), cfg.head_dim, cfg.rope_theta)
    block = engine.model.layer_0
    lora = extract_lora(block.attn)

    def attn_run():
        out, _ = block.attn(block.input_norm(x), cos, sin)
        return [out.detach()] + list(torch.autograd.grad(out, list(lora.values()), dout))

    got = attn_run()
    with plain_flash_route():
        want = attn_run()
    # rows: the output's tokens, and each adapter gradient's rank components
    # (lora_a is [in, rank]: its columns; lora_b is [rank, out]: its rows)
    attn_errs = {name: row_rel_err(g.T, w_.T) if name.endswith("lora_a")
                 else row_rel_err(g, w_)
                 for name, g, w_ in zip(["o_proj output", *lora], got, want)}
    attn_err = max(attn_errs.values())
    # --- the whole model on one test batch: every layer's flash output on
    # the model's own activations against the plain forward on the same
    # q, k, v, and the loss through the kernels vs through the plain versions ---
    xt, yt = (torch.as_tensor(a[:1], device="cuda").long() for a in
              api.dataset.test_data_global)
    m1 = torch.ones(1, device="cuda")
    layer_errs = []

    def checked_flash(q, k, v):
        out = fa.flash_attention(q, k, v, causal=True)
        layer_errs.append(row_rel_err(out, fa.flash_forward_reference(q, k, v, True)[0]))
        return out

    checked_loss = causal_lm_loss(lambda m, x_: m(x_, attention_fn=checked_flash))
    with torch.no_grad():
        loss_k = float(checked_loss(engine.model, xt, yt, m1)[0])
        with plain_flash_route():
            loss_p = float(engine._loss_fn(engine.model, xt, yt, m1)[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    layer_err = max(layer_errs)
    print(f"  layer_0 attention fwd+bwd, kernels vs plain versions, row measure: "
          + ", ".join(f"{n.removeprefix('params/')} {e:.4g}" for n, e in attn_errs.items())
          + f" (limit {ROW_TOL:.4g}); flash output of each of {len(layer_errs)} layers on "
          f"the model's activations: worst {layer_err:.4g} (layer "
          f"{layer_errs.index(layer_err)}); model loss {loss_k:.5f} vs {loss_p:.5f} "
          f"plain ({loss_rel:.3g} relative, limit {LOSS_REL_TOL})", flush=True)
    if not (attn_err <= ROW_TOL and len(layer_errs) == cfg.num_hidden_layers
            and layer_err <= ROW_TOL and loss_rel <= LOSS_REL_TOL
            and math.isfinite(loss_k)):
        raise RuntimeError(f"the kernels' model disagrees with the plain versions: "
                           f"attention {attn_errs}, layers {layer_errs}, loss {loss_rel}")
    return dict(result, round_wall_s=round_wall_s, device_ms_per_round=dev_ms,
                device_busy_share=busy, device_ms_by_class=by_class,
                top_kernels=[dict(ms=m_, count=c_, name=k_) for m_, c_, k_ in by_kernel[:20]],
                attention_row_err=attn_errs, layer_flash_row_err=layer_errs,
                loss_kernel=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel)


def int_mm_needs():
    """Phase (f), part 0: what ``torch._int_mm`` needs on this card, which
    the w8a8 path is built around: whether it takes 16 rows (the path pads
    fewer than INT_MM_MIN_ROWS to that count), and its time at 32 rows
    with the int8 weight row-major against column-major (the layout
    ``QuantizedTensor`` stores in w8a8 mode)."""
    gen = torch.Generator(device="cuda").manual_seed(97)
    out = {}
    for (h, f) in ((4096, 4096), (4096, 128256)):
        w = torch.randint(-127, 128, (h, f), device="cuda", generator=gen,
                          dtype=torch.int32).to(torch.int8)
        x16 = torch.randint(-127, 128, (16, h), device="cuda", generator=gen,
                            dtype=torch.int32).to(torch.int8)
        try:
            torch._int_mm(x16, w)
            refused = None
        except RuntimeError as e:
            refused = str(e).splitlines()[0]
        x = torch.cat([x16, x16])
        col = w.t().contiguous().t()
        row_ms = device_ms([lambda: torch._int_mm(x, w)], 10)
        col_ms = device_ms([lambda: torch._int_mm(x, col)], 10)
        out[f"{h}x{f}"] = dict(refuses_16_rows=refused, row_major_ms=row_ms,
                               column_major_ms=col_ms)
        print(f"  torch._int_mm at K={h} N={f}: 16 rows "
              + (f"refused ({refused})" if refused else "taken")
              + f"; 32 rows {row_ms:.4f} ms row-major, {col_ms:.4f} ms column-major",
              flush=True)
        del w, col
    torch.cuda.empty_cache()
    return out


def w8a8_check():
    """Phase (f), part 1: the w8a8 product on the card (``torch._int_mm``,
    fewer than 32 rows padded) against its plain version on the CPU (an
    exact float64 product) at every projection shape and W8A8_ROWS rows:
    activation codes, row scales and int32 accumulators bit for bit, the
    bf16 outputs row by row within DEQUANT_ROW_TOL."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(5678)
    out = []
    for (h, f) in SLICE_SHAPES:
        qt = quant.quantize_int8(torch.randn(h, f, device="cuda", generator=gen), mode="w8a8")
        xs = [torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
              for rows in W8A8_ROWS]
        # the plain version once for all row counts (rows are independent)
        t0 = time.perf_counter()
        xq_c, xs_c = quant.quantize_rows_int8(torch.cat(xs).cpu())
        acc_c = quant.int8_product(xq_c, qt.data.cpu())
        want_c = quant.w8a8_rescale(acc_c, xs_c, qt.scale.cpu(), torch.bfloat16)
        cpu_s = time.perf_counter() - t0
        r0 = 0
        for rows, x in zip(W8A8_ROWS, xs):
            sl = slice(r0, r0 + rows)
            r0 += rows
            xq, xsc = quant.quantize_rows_int8(x)
            acc = quant.int8_product(xq, qt.data)
            got = qt.matmul(x, torch.bfloat16).cpu()
            rec = dict(H=h, F=f, rows=rows,
                       codes_identical=bool(torch.equal(xq.cpu(), xq_c[sl])),
                       row_scales_identical=bool(torch.equal(xsc.cpu(), xs_c[sl])),
                       acc_identical=bool(torch.equal(acc.cpu(), acc_c[sl])),
                       out_identical=bool(torch.equal(got, want_c[sl])),
                       row_measure=row_rel_err(got, want_c[sl]))
            out.append(rec)
            if not (rec["codes_identical"] and rec["row_scales_identical"]
                    and rec["acc_identical"] and rec["row_measure"] <= DEQUANT_ROW_TOL):
                raise RuntimeError(f"w8a8 on the card disagrees with the CPU: {rec}")
        print(f"  w8a8 H={h:5d} F={f:6d}: codes, row scales and int32 accumulators "
              f"bit-identical to the CPU at rows {W8A8_ROWS}; outputs row measure "
              f"<= {max(r['row_measure'] for r in out[-len(W8A8_ROWS):]):.3g} (limit "
              f"{DEQUANT_ROW_TOL:.4g}), bit-identical "
              f"{all(r['out_identical'] for r in out[-len(W8A8_ROWS):])}; CPU plain "
              f"version {cpu_s:.1f} s", flush=True)
        del qt, xs, xq_c, xs_c, acc_c, want_c
        torch.cuda.empty_cache()
    return out


def quant4_check():
    """Phase (f), part 2: int4 and nf4 quantization of layer 0's seven
    kernel shapes and the LM head's on the card and on the CPU from the
    same bf16 weights: packed bytes, scales and the bf16 dequantized weight
    bit for bit."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(8765)
    out = {}
    for fmt in ("int4", "nf4"):
        for name, (h, f) in LAYER0_KERNELS.items():
            w = (torch.randn(h, f, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
            q, q_c = quant.quantize_int4(w, fmt=fmt), quant.quantize_int4(w.cpu(), fmt=fmt)
            same = (torch.equal(q.data.cpu(), q_c.data) and torch.equal(q.scale.cpu(), q_c.scale)
                    and torch.equal(q.dequantize(torch.bfloat16).cpu(),
                                    q_c.dequantize(torch.bfloat16)))
            out[f"{fmt} {name}"] = same
            if not same:
                raise RuntimeError(f"{fmt} {name}: the card's bytes or dequantized "
                                   f"weight differ from the CPU's")
            del w, q, q_c
        print(f"  {fmt}: packed bytes, scales and bf16 dequantized weights of layer 0's "
              f"seven kernels and the LM head bit-identical on the card and the CPU",
              flush=True)
    torch.cuda.empty_cache()
    return out


def quant_pass_times(peak_bw: float, peak_flops: float, int8_results=None):
    """Phase (f), part 3: one pass of the 225 projections at PASS_ROWS rows,
    timed with CUDA events for w8a8, nf4 dequant + matmul, nf4 dequant alone
    and bf16 ``torch.matmul``, beside the int8 dequant kernel's pass (phase
    b) and each pass's bound: the larger of its bytes (the weights, x and
    the output, each once) over the bandwidth and its products over the
    type's peak (int8 on the tensor cores at twice the bf16 rate)."""
    from fedml_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(2468)
    per = []
    for (h, f), count in SLICE_SHAPES.items():
        w = torch.randn(h, f, device="cuda", generator=gen) * 0.02
        n_copies = max(2, min(32, math.ceil(256e6 / (h * f))))  # beyond the 50 MB L2
        w8 = quant.quantize_int8(w, mode="w8a8")
        w4 = quant.quantize_int4(w, fmt="nf4")
        wb = w.to(torch.bfloat16)
        del w
        w8s = [w8] + [quant.QuantizedTensor(w8.data.clone(), w8.scale.clone(), mode="w8a8")
                      for _ in range(n_copies - 1)]
        w4s = [w4] + [quant.QuantizedTensor4(w4.data.clone(), w4.scale.clone(), w4.shape,
                                             fmt="nf4", block=w4.block)
                      for _ in range(n_copies - 1)]
        wbs = [wb] + [wb.clone() for _ in range(n_copies - 1)]
        reps = 20 if h * f < 1e8 else 10
        for rows in PASS_ROWS:
            x = torch.randn(rows, h, device="cuda", generator=gen).to(torch.bfloat16)
            with torch.inference_mode():
                ms = {
                    "w8a8": device_ms([lambda i=i: quant.matmul_maybe_quantized(
                        x, w8s[i], torch.bfloat16) for i in range(n_copies)], reps),
                    "nf4": device_ms([lambda i=i: quant.matmul_maybe_quantized(
                        x, w4s[i], torch.bfloat16) for i in range(n_copies)], reps),
                    "nf4_dequant": device_ms([lambda i=i: w4s[i].dequantize(torch.bfloat16)
                                              for i in range(n_copies)], reps),
                    "bf16": device_ms([lambda i=i: x @ wbs[i] for i in range(n_copies)], reps),
                }
            act = 2 * rows * (h + f)
            flops = 2 * rows * h * f
            bounds = {
                "w8a8": max((h * f + 4 * f + act) / peak_bw, flops / (2 * peak_flops)),
                "nf4": max((w4.data.numel() + 4 * w4.scale.numel() + act) / peak_bw,
                           flops / peak_flops),
                "nf4_dequant": (w4.data.numel() + 4 * w4.scale.numel() + 2 * h * f) / peak_bw,
                "bf16": max((2 * h * f + act) / peak_bw, flops / peak_flops),
            }
            per.append(dict(H=h, F=f, rows=rows, count=count, ms=ms,
                            bound_ms={k: v * 1e3 for k, v in bounds.items()}))
        del w8s, w4s, wbs, w8, w4, wb
        torch.cuda.empty_cache()
    passes = {}
    for rows in PASS_ROWS:
        recs = [r for r in per if r["rows"] == rows]
        p = {k: sum(r["count"] * r["ms"][k] for r in recs) for k in recs[0]["ms"]}
        b = {k: sum(r["count"] * r["bound_ms"][k] for r in recs) for k in recs[0]["ms"]}
        int8_ms = None if int8_results is None else step_sum(int8_results, "ms", rows)
        int8_bound = None if int8_results is None else step_sum(int8_results, "bound_ms", rows)
        passes[rows] = dict(ms=p, bound_ms=b, int8_kernel_ms=int8_ms,
                            int8_kernel_bound_ms=int8_bound)
        print(f"  one pass of {LAUNCHES_PER_PASS} projections at {rows} rows (ms, bound ms): "
              + ", ".join(f"{k} {p[k]:.4f} ({b[k]:.4f})" for k in p)
              + "; int8 dequant kernel (phase b) "
              + ("not measured" if int8_ms is None else f"{int8_ms:.4f} ({int8_bound:.4f})"),
              flush=True)
    return dict(per_shape=per, passes=passes)


def quant_serve(mode: str):
    """Phase (f), part 4: Llama-3-8B served with ``--quantize mode``
    through the ``serve`` entry point: QUANT_REQUESTS HTTP requests,
    QUANT_CONCURRENT at a time, then steady decode at 8 slots; finite
    logits of the vocab width; one short prompt's greedy tokens equal to
    the plain lowering of the same quantized weights (w8a8: the exact int8
    product in plain PyTorch; nf4: a bf16 model built from the dequantized
    weights)."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.ops import quant
    from fedml_tpu_torch.serving import ContinuousBatchingEngine

    args = build_parser().parse_args(
        ["serve", "--model", "llama3_8b", "--quantize", mode, "--batch-slots", "8",
         "--max-len", "512", "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, runner = build_endpoint(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    model, cfg = engine.params, engine.cfg
    served_bytes = quant.tree_bytes(model)
    print(f"  {mode}: booted {args.model_size} in {boot_s:.1f} s: tree_bytes {served_bytes} "
          f"({served_bytes / 1e9:.3f} GB), {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          f"allocated", flush=True)
    # every request's TTFT, unbucketed, as the engine hands it to the monitor
    ttfts = []
    record = runner.monitor.record_stream

    def record_stream(ttft_ms, tpot_ms, tps):
        ttfts.append(ttft_ms)
        record(ttft_ms, tpot_ms, tps)

    runner.monitor.record_stream = record_stream
    rng = np.random.default_rng(1)
    runner.start()
    try:
        lens = rng.integers(20, 121, size=QUANT_REQUESTS)
        bodies = [{"prompt_tokens": rng.integers(0, cfg.vocab_size, size=int(n)).tolist(),
                   "max_new_tokens": QUANT_NEW_TOKENS} for n in lens]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(QUANT_CONCURRENT) as pool:
            resps = list(pool.map(lambda b: post(runner.port, b), bodies))
        wall_s = time.perf_counter() - t0
        for r in resps:
            toks = r.get("tokens")
            if (not isinstance(toks, list) or len(toks) != QUANT_NEW_TOKENS
                    or not all(0 <= t < cfg.vocab_size for t in toks)):
                raise RuntimeError(f"bad response: {r}")
        deadline = time.time() + 5
        while len(ttfts) < QUANT_REQUESTS and time.time() < deadline:
            time.sleep(0.01)
        http_ttfts = list(ttfts)
        print(f"  {mode}: {QUANT_REQUESTS} requests ({QUANT_CONCURRENT} concurrent) in "
              f"{wall_s:.2f} s; TTFT ms {[round(t, 2) for t in http_ttfts]}", flush=True)
    finally:
        runner.stop()
        engine.stop()
    if engine.failure is not None:
        raise RuntimeError("serving engine failed") from engine.failure
    step_s, dev_step_ms, busy = steady_decode(engine, rng)

    # logits finite and of the vocab width, prefill and one decode step
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 48))).cuda()
    with torch.inference_mode():
        caches = model.init_kv_caches(1, 64)
        lp, caches = model(tokens, kv_caches=caches)
        ld, _ = model(tokens[:, -1:], positions=torch.tensor([[48]], device="cuda"),
                      kv_caches=caches)
    if not all(torch.isfinite(t).all() and t.shape[-1] == cfg.vocab_size for t in (lp, ld)):
        raise RuntimeError(f"{mode}: served logits are not finite / of the vocab width")
    del caches, lp, ld

    # one short prompt's greedy tokens against the plain lowering
    prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()

    def greedy(eng):
        eng.start()
        try:
            return eng.generate(prompt, max_new_tokens=QUANT_NEW_TOKENS)
        finally:
            eng.stop()

    got = greedy(engine)
    if mode == "w8a8":
        product = quant.int8_product_cuda
        quant.int8_product_cuda = quant.int8_product_reference
        try:
            want = greedy(engine)
        finally:
            quant.int8_product_cuda = product
        plain = "the exact int8 product in plain PyTorch (float64)"
    else:
        bf16 = quant._shallow_module_copy(model)
        for m in bf16.modules():
            for k, v in list(vars(m).items()):
                if isinstance(v, quant.QuantizedTensor4):
                    delattr(m, k)
                    m.register_parameter(k, torch.nn.Parameter(
                        v.dequantize(torch.bfloat16), requires_grad=False))
        want = greedy(ContinuousBatchingEngine(bf16, batch_slots=engine.n_slots,
                                               max_len=engine.max_len))
        plain = "a bf16 model of the dequantized weights"
        del bf16
    print(f"  {mode}: greedy tokens of a 24-token prompt {got[:8]}... equal to {plain}: "
          f"{got == want}", flush=True)
    if got != want:
        raise RuntimeError(f"{mode}: greedy tokens {got} != the plain lowering's {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return dict(mode=mode, boot_s=boot_s, tree_bytes=served_bytes, http_wall_s=wall_s,
                ttft_ms=http_ttfts, decode_ms_per_step=step_s * 1e3,
                tokens_per_s=engine.n_slots / step_s, device_ms_per_step=dev_step_ms,
                device_busy_share=busy, greedy_tokens=got, greedy_equal_plain=got == want,
                peak_gb=peak_gb)


def quant_phase(peak_bw: float, peak_flops: float, int8_results=None):
    """Phase (f): the quantized formats at Llama-3-8B's widths."""
    out = dict(int_mm=int_mm_needs(), w8a8=w8a8_check(), quant4=quant4_check(),
               passes=quant_pass_times(peak_bw, peak_flops, int8_results))
    for mode in QUANT_SERVE_MODES:
        out[f"serve_{mode}"] = quant_serve(mode)
        gc.collect()  # this mode's engine and weights are gone
        torch.cuda.empty_cache()
    return out


def qlora_phase(bf16_round):
    """Phase (g): phase (e) over an nf4 base, set beside phase (e)'s round
    (``bf16_round``), then one round over an int8 base."""
    nf4 = train_phase(base_quantize="nf4")
    gc.collect()
    torch.cuda.empty_cache()
    int8 = train_phase(light=True, base_quantize="int8", comm_round=1)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  int8 base, one round: {int8['rounds'][0]['round_sec']:.3f} s (the first round, "
          f"with first-call costs), peak memory {int8['peak_gb']:.3f} GB", flush=True)
    rows = [("steady round s", "steady_round_s", "{:.3f}"),
            ("tokens/s", "tokens_per_s", "{:.1f}"),
            ("busy share", "device_busy_share", "{:.3f}"),
            ("device ms a round", "device_ms_per_round", "{:.1f}"),
            ("peak memory GB", "peak_gb", "{:.3f}")]
    if bf16_round is not None:
        print("  nf4 base beside phase (e)'s bf16 base, this run:", flush=True)
        for label, key, fmt in rows:
            a, b = nf4.get(key), bf16_round.get(key)
            print(f"    {label}: nf4 " + ("not measured" if a is None else fmt.format(a))
                  + " / bf16 " + ("not measured" if b is None else fmt.format(b)), flush=True)
        for c in sorted(set(nf4["device_ms_by_class"]) | set(bf16_round["device_ms_by_class"])):
            print(f"    {c}: nf4 {nf4['device_ms_by_class'].get(c, 0.0):.1f} ms / bf16 "
                  f"{bf16_round['device_ms_by_class'].get(c, 0.0):.1f} ms", flush=True)
        margin = bf16_round["peak_gb"] - nf4["peak_gb"]
        if margin < QLORA_PEAK_MARGIN_GB:
            raise RuntimeError(f"the nf4 round's peak {nf4['peak_gb']:.3f} GB is only "
                               f"{margin:.3f} GB below the bf16 round's (need "
                               f"{QLORA_PEAK_MARGIN_GB})")
    return dict(nf4=nf4, int8=int8)


def sp_kernel_class(name: str) -> str:
    low = name.lower()
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit")):
        return "convolution (cuDNN)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (elementwise: GroupNorm, ReLU, CE, optimizer, codecs)"


def _same_wire(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.cpu(), y.cpu())
               for pa, pb in zip(a.arrays, b.arrays) for x, y in zip(pa, pb))


def sp_phase(card: str):
    """Phase (h): the sp FedAvg simulation of ResNet-18 with int8 uplinks
    through ``create_simulator`` on the card, with its checks (see the
    module doc)."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import derive_key, fused_weighted_sum, get_codec
    from fedml_tpu_torch.compression import tree_delta
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.aggregator import agg_operator
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.convert import to_reference_layout
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.simulator import create_simulator

    args = load_arguments_from_dict(SP_CONFIG)
    t0 = time.perf_counter()
    ds = load_federated(args)
    data_s = time.perf_counter() - t0
    model = create(args, ds.class_num)
    torch.cuda.reset_peak_memory_stats()
    sim = create_simulator(args, "cuda", ds, model)
    api = sim.fl_trainer
    params0 = {k: v.clone() for k, v in api.global_params.items()}
    n_params = sum(v.numel() for v in params0.values())
    sizes = [ds.train_data_local_num_dict[c] for c in range(args.client_num_in_total)]
    print(f"  {card}: resnet18 (GroupNorm, 2 groups), {n_params} parameters in "
          f"{len(params0)} leaves; cifar10 stand-in {ds.train_data_num} train / "
          f"{ds.test_data_num} test images of {ds.train_data_global[0].shape[1:]} made "
          f"in {data_s:.1f} s; client sizes {sizes}", flush=True)

    # the main path: create_simulator(...).run(), round by round
    rounds, uplinks = [], {}
    inner_round = api.train_one_round
    orig_agg = agg_operator.FedMLAggOperator.agg_compressed

    def capture(args_, raw_list, global_params, **kw):
        uplinks["pairs"], uplinks["global"] = raw_list, global_params
        return orig_agg(args_, raw_list, global_params, **kw)

    def recorded(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = inner_round(r)
        torch.cuda.synchronize()
        rep["round_sec"] = time.perf_counter() - t0
        rep["on_cuda"] = all(v.is_cuda for v in api.global_params.values())
        rep["finite"] = all(bool(torch.isfinite(v).all()) for v in api.global_params.values())
        rounds.append(rep)
        print(f"  {card}: round {r}: {rep['round_sec']:.3f} s, test loss "
              f"{rep['test_loss']:.5f}, test acc {rep['test_acc']:.4f}, encode "
              f"{rep['encode_ms']:.2f} ms, fused aggregation {rep['aggregate_ms']:.2f} ms, "
              f"params on cuda {rep['on_cuda']}", flush=True)
        return rep

    api.train_one_round = recorded
    agg_operator.FedMLAggOperator.agg_compressed = staticmethod(capture)
    try:
        summary = sim.run()
    finally:
        agg_operator.FedMLAggOperator.agg_compressed = staticmethod(orig_agg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(r["on_cuda"] and r["finite"] for r in rounds):
        raise RuntimeError("a round's parameters left the card or are not finite")
    losses = [r["test_loss"] for r in rounds]
    if not (len(rounds) == args.comm_round and losses[-1] < losses[0]):
        raise RuntimeError(f"the test loss did not fall from round 0: {losses}")

    # card against CPU: the largest client's first SP_CPU_STEPS batches,
    # from the run's final weights; and in float64 on the card
    x, y = ds.train_data_local_dict[int(np.argmax(sizes))]
    final = {k: v.clone() for k, v in api.global_params.items()}
    n = SP_CPU_STEPS * args.batch_size
    trained = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32),
                    ("cuda", torch.float64)):
        tr = ClassificationTrainer(model, args)
        tr.set_pad_to_batches(SP_CPU_STEPS)
        t0 = time.perf_counter()
        w, m = tr.train({k: v.to(dev, dt) for k, v in final.items()}, (x[:n], y[:n]),
                        dev, args)
        trained[dev, dt] = ({k: v.cpu().double() for k, v in w.items()}, m,
                            time.perf_counter() - t0)

    def leaf_err(a, b):
        return max(float((a[k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                   for k, v in b.items())

    exact = trained["cuda", torch.float64][0]
    card32, cpu32 = trained["cuda", torch.float32][0], trained["cpu", torch.float32][0]
    card_vs_cpu, card_vs_64, cpu_vs_64 = (leaf_err(card32, cpu32), leaf_err(card32, exact),
                                          leaf_err(cpu32, exact))
    moved = max(float((cpu32[k] - final[k].cpu()).abs().max()) for k in final)
    print(f"  one client from the final weights, {SP_CPU_STEPS} steps of batch "
          f"{args.batch_size} (FP32, TF32 off), "
          f"worst leaf of its magnitude: card vs CPU {card_vs_cpu:.3g} (limit "
          f"{SP_PARAM_TOL}); against float64: card {card_vs_64:.3g} (limit "
          f"{SP_PARAM_TOL}), CPU {cpu_vs_64:.3g}; train loss "
          + ", ".join(f"{d} {t}: {r[1]['train_loss']:.6f} in {r[2]:.2f} s"
                      for (d, t), r in trained.items())
          + f"; the steps moved the weights by up to {moved:.3g}", flush=True)
    if not (card_vs_cpu <= SP_PARAM_TOL and card_vs_64 <= SP_PARAM_TOL and moved > 0):
        raise RuntimeError(f"the card's local steps disagree with the CPU's: "
                           f"{card_vs_cpu}, {card_vs_64} vs {cpu_vs_64}")

    # the fused sum of the last round's uploads against decode-then-sum
    pairs = uplinks["pairs"]
    cts = [ct for _, ct in pairs]
    w = agg_operator.FedMLAggOperator._weights(args, pairs)
    fused = fused_weighted_sum(cts, w)
    codec = get_codec(args.compression)
    decoded = [codec.decode(ct) for ct in cts]
    fused_err = 0.0
    for k, v in fused.items():
        ref = sum(float(wi) * d[k].double() for wi, d in zip(w, decoded))
        scale = float(ref.abs().max())
        err = float((v.double() - ref).abs().max())
        fused_err = max(fused_err, err / scale if scale else err)
    print(f"  fused_weighted_sum of round {args.comm_round - 1}'s {len(cts)} int8 uploads "
          f"on the card vs decode-and-sum in float64: worst leaf {fused_err:.3g} of its "
          f"magnitude (limit {SP_FUSED_REL_TOL})", flush=True)
    if not fused_err <= SP_FUSED_REL_TOL:
        raise RuntimeError(f"fused_weighted_sum disagrees with decode-and-sum: {fused_err}")

    # codec bits: the run's delta under the same key, on the card and the CPU
    delta = to_reference_layout(tree_delta(api.global_params, params0))
    delta_cpu = {k: v.cpu() for k, v in delta.items()}
    key = derive_key(args.random_seed, 0, 0)
    codec_ok = {}
    for spec in SP_CODECS:
        c = get_codec(spec)
        codec_ok[spec] = _same_wire(c.encode(delta, key=key, is_delta=True),
                                    c.encode(delta_cpu, key=key, is_delta=True))
    print(f"  codec bits, the run's {n_params}-element delta under derive_key(0, 0, 0), "
          f"card vs CPU: " + ", ".join(f"{k} {'identical' if v else 'DIFFER'}"
                                       for k, v in codec_ok.items()), flush=True)
    if not all(codec_ok.values()):
        raise RuntimeError(f"codec wire bytes differ between the card and the CPU: {codec_ok}")

    # busy share of local training, the bulk of a round: SP_PROFILE_STEPS
    # steps of the largest client from the final weights, profiled, over the
    # unprofiled wall of the same window (a whole round is ~1.2 M kernels,
    # too many to profile inside the script's time limit)
    tr = ClassificationTrainer(model, args)
    tr.set_pad_to_batches(SP_PROFILE_STEPS)
    window = (x[:SP_PROFILE_STEPS * args.batch_size], y[:SP_PROFILE_STEPS * args.batch_size])
    tr.train(api.global_params, window, "cuda", args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(api.global_params, window, "cuda", args)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.train(api.global_params, window, "cuda", args)
        torch.cuda.synchronize()
    by_class = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            c = sp_kernel_class(e.key)
            by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    dev_ms = sum(by_class.values())
    busy = dev_ms / (window_s * 1e3) if dev_ms else None
    steady = rounds[-1]["round_sec"]
    samples = ds.train_data_num
    raw_bytes = 4 * n_params
    wire = rounds[-1]["uplink_bytes"]
    print(f"  {card}: steady round {steady:.3f} s (with its test) = "
          f"{samples / steady:.1f} training samples/s; {SP_PROFILE_STEPS} local steps: "
          f"{window_s * 1e3:.1f} ms wall, device time "
          + ("not measured" if busy is None else
             f"{dev_ms:.1f} ms (profiler), busy share {busy:.3f}")
          + f"; peak memory {peak_gb:.3f} GB; encode {rounds[-1]['encode_ms']:.2f} ms and "
          f"fused aggregation {rounds[-1]['aggregate_ms']:.2f} ms a round; uplink "
          f"{sum(wire) / len(wire):.0f} B a client (int8) vs {raw_bytes} B (f32), "
          f"{raw_bytes * len(wire) / sum(wire):.3f}x", flush=True)
    for c, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {c}: {v:.1f} ms", flush=True)
    return dict(rounds=[{k: v for k, v in r.items() if k != "clients"} for r in rounds],
                summary={k: v for k, v in summary.items() if isinstance(v, (int, float))},
                n_params=n_params, client_sizes=sizes, card_vs_cpu_err=card_vs_cpu,
                card_vs_float64_err=card_vs_64, cpu_vs_float64_err=cpu_vs_64,
                fused_rel_err=fused_err, codec_bits_identical=codec_ok,
                steady_round_s=steady, samples_per_s=samples / steady,
                profiled_steps=SP_PROFILE_STEPS, profiled_wall_ms=window_s * 1e3,
                profiled_device_ms=dev_ms, device_busy_share=busy,
                device_ms_by_class=by_class, peak_gb=peak_gb,
                uplink_bytes_per_client=sum(wire) / len(wire), f32_bytes=raw_bytes)


def _registry_flat(reg) -> dict:
    """The metrics registry as ``{name{labels}: value or histogram summary}``."""
    out = {}
    for m in reg._items():
        key = m.name + ("{" + ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
                        + "}" if m.labels else "")
        snap = m.snapshot()
        out[key] = (snap["value"] if "value" in snap else
                    {k: snap[k] for k in ("count", "sum", "max")})
    return out


def _events_ms(fn, reps: int = CS_TIMED_REPS) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls, CUDA events, after
    one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int = CS_TIMED_REPS) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls after a warm one."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def cross_silo_inproc(card: str):
    """Phase (i1): ``run_cross_silo_inproc``'s federation over LOCAL on the
    card, with its checks (see the module doc)."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.compression import (
        CompressedTree,
        ErrorFeedback,
        derive_key,
        get_codec,
        tree_delta,
    )
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
    from fedml_tpu_torch.models.convert import (
        from_reference_layout,
        from_wire_params,
        to_reference_layout,
        to_wire_params,
    )
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.telemetry import get_registry
    from fedml_tpu_torch.utils.serialization import safe_dumps, safe_loads

    args = load_arguments_from_dict(CS_CONFIG)
    t0 = time.perf_counter()
    ds = load_federated(args)
    data_s = time.perf_counter() - t0
    model = create(args, ds.class_num)
    LocalBroker.destroy(args.run_id)
    torch.cuda.reset_peak_memory_stats()
    server, clients = build_cross_silo_inproc(args, ds, model, "cuda")
    agg, smgr = server.fedml_aggregator, server.manager
    n_params = sum(v.numel() for v in agg.get_global_model_params().values())
    f32_bytes = 4 * n_params

    # what the run records: each upload as it reaches the aggregator, each
    # round's test and its end time, and the last round's broadcast and client
    # updates (for the timed replays below)
    uploads, rounds, last = [], [], {"updates": {}, "broadcast": None}
    add, test = agg.add_local_trained_result, agg.test_on_server_for_all_clients
    bcast = smgr._broadcast_payload

    def recorded_add(index, params, n, local_steps=None):
        uploads.append(dict(round=int(smgr.args.round_idx), index=index, n=int(n),
                            compressed=isinstance(params, CompressedTree),
                            codec=getattr(params, "codec", None),
                            delta=getattr(params, "is_delta", None),
                            wire=params.wire_nbytes() if isinstance(params, CompressedTree)
                            else None))
        return add(index, params, n, local_steps)

    def recorded_test(r):
        m = test(r)
        torch.cuda.synchronize()
        rounds.append(dict(round=r, end=time.perf_counter(),
                           test_loss=float(m["test_loss"]), test_acc=float(m["test_acc"])))
        return m

    def recorded_bcast(params):
        last["broadcast"] = bcast(params)
        return last["broadcast"]

    agg.add_local_trained_result, agg.test_on_server_for_all_clients = recorded_add, recorded_test
    smgr._broadcast_payload = recorded_bcast
    for c in clients:
        mgr = c.manager
        encode = mgr._encode_update

        def recorded_encode(weights, mgr=mgr, encode=encode):
            last["updates"][mgr.rank] = (weights, mgr._global_ref, mgr.round_idx)
            return encode(weights)

        mgr._encode_update = recorded_encode
    # the same upload posted twice: a resend keeps its message id, and the
    # server's dedup must drop the copy
    injected = []
    c1 = clients[0].manager
    send = c1.send_message

    def send_twice(msg):
        send(msg)
        if msg.get_type() == MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER and not injected:
            injected.append(msg.get("msg_id"))
            c1.com_manager.broker.post(0, msg)

    c1.send_message = send_twice
    dups0 = get_registry().counter("resilience/duplicates_dropped").value
    t_start = time.perf_counter()
    result = run_managers_to_completion([smgr] + [c.manager for c in clients], args.run_id,
                                        MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=900)
    wall = time.perf_counter() - t_start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dups = get_registry().counter("resilience/duplicates_dropped").value - dups0
    final = agg.get_global_model_params()
    for i, r in enumerate(rounds):
        r["round_s"] = r["end"] - (rounds[i - 1]["end"] if i else t_start)
        r["uploads"] = [u for u in uploads if u["round"] == r["round"]]
        r["samples"] = sum(u["n"] for u in r["uploads"])
        print(f"  {card}: round {r['round']}: {r['round_s']:.3f} s"
              + (" (with the handshake)" if i == 0 else "")
              + f", {len(r['uploads'])} uploads of {r['samples']} samples, test loss "
              f"{r['test_loss']:.5f}, test acc {r['test_acc']:.4f}", flush=True)
    ratios = [f32_bytes / u["wire"] for u in uploads if u["wire"]]
    bad = [u for u in uploads if not (u["compressed"] and u["codec"] == "int8" and u["delta"])]
    if result.get("rounds") != 2 or len(rounds) != 2:
        raise RuntimeError(f"the federation did not run 2 rounds: {result}")
    if not rounds[1]["test_loss"] < rounds[0]["test_loss"]:
        raise RuntimeError(f"the test loss did not fall: {[r['test_loss'] for r in rounds]}")
    if bad or len(ratios) != len(uploads) or min(ratios) < CS_WIRE_RATIO:
        raise RuntimeError(f"an upload was not an int8 delta at least {CS_WIRE_RATIO}x "
                           f"smaller than f32: {bad or min(ratios)}")
    if not (injected and dups == 1 and all(len(r["uploads"]) == 4 for r in rounds)):
        raise RuntimeError(f"the duplicate upload was not dropped once: injected "
                           f"{injected}, dropped {dups}, uploads a round "
                           f"{[len(r['uploads']) for r in rounds]}")
    if not all(v.is_cuda and bool(torch.isfinite(v).all()) for v in final.values()):
        raise RuntimeError("the global model left the card or is not finite")

    # the last round's work replayed alone, timed with CUDA events: the four
    # clients' encodes (delta in the reference's layout + error feedback),
    # the fused aggregation of their uploads, the layout conversions a round
    # makes (the decoded broadcast on the server and each client, and the
    # aggregate: 6 full trees in the port's layout from the reference's), and
    # the uncompressed message form's round trip
    codec = get_codec(args.compression)
    seed, efs = int(args.random_seed), {}
    updates = sorted(last["updates"].items())

    def encode_round():
        cts = []
        for rank, (w, ref, r) in updates:
            ef = efs.setdefault(rank, ErrorFeedback(codec))
            cts.append(ef.encode(to_reference_layout(tree_delta(w, ref)),
                                 key=derive_key(seed, r, rank)))
        return cts

    cts = encode_round()
    pairs = [(ds.train_data_local_num_dict[i], ct) for i, ct in enumerate(cts)]
    base = to_reference_layout(agg.get_upload_base() or final)
    encode_ms = _events_ms(encode_round)
    aggregate_ms = _events_ms(lambda: FedMLAggOperator.agg_compressed(args, pairs, base))
    convert_ms = _events_ms(lambda: from_reference_layout(to_reference_layout(final)))
    wire_form_ms = _events_ms(lambda: from_wire_params(to_wire_params(final), "cuda"))
    # the BROKER transport's (de)serialization of the same payloads, warm, on
    # the host's clock (safe_dumps ends in a device sync, safe_loads is
    # followed by one)
    ser = {}
    for name, obj in (("broadcast", last["broadcast"]), ("upload", cts[0])):
        blob = safe_dumps(obj)
        ser[f"{name}_dumps_ms"] = _host_ms(lambda: safe_dumps(obj))
        ser[f"{name}_loads_ms"] = _host_ms(
            lambda: (safe_loads(blob, "cuda"), torch.cuda.synchronize()))
        ser[f"{name}_bytes"] = len(blob)
    steady = rounds[-1]
    print(f"  {card}: steady round {steady['round_s']:.3f} s (with its 10,000-image test) = "
          f"{steady['samples'] / steady['round_s']:.1f} training samples/s; whole run "
          f"{wall:.3f} s; data made in {data_s:.1f} s; peak memory {peak_gb:.3f} GB",
          flush=True)
    print(f"  {card}: a round's encode (4 uploads) {encode_ms:.2f} ms, fused aggregation "
          f"{aggregate_ms:.2f} ms, layout conversion {convert_ms:.2f} ms a tree x 6 = "
          f"{6 * convert_ms:.2f} ms, message-form round trip {wire_form_ms:.3f} ms "
          f"(CUDA events, mean of {CS_TIMED_REPS}); uploads "
          f"{sum(u['wire'] for u in uploads) / len(uploads):.0f} B vs {f32_bytes} B f32 "
          f"(min {min(ratios):.3f}x); duplicate dropped {int(dups)}", flush=True)
    print(f"  {card}: warm safe_dumps / safe_loads onto the card (host clock, mean of "
          f"{CS_TIMED_REPS}): broadcast ({ser['broadcast_bytes']} B) "
          f"{ser['broadcast_dumps_ms']:.2f} / {ser['broadcast_loads_ms']:.2f} ms, one upload "
          f"({ser['upload_bytes']} B) {ser['upload_dumps_ms']:.2f} / "
          f"{ser['upload_loads_ms']:.2f} ms", flush=True)
    return dict(rounds=[{k: v for k, v in r.items() if k not in ("end", "uploads")}
                        for r in rounds], n_params=n_params, f32_bytes=f32_bytes,
                upload_bytes=[u["wire"] for u in uploads], min_ratio=min(ratios),
                duplicates_dropped=dups, wall_s=wall, data_s=data_s, peak_gb=peak_gb,
                steady_round_s=steady["round_s"],
                samples_per_s=steady["samples"] / steady["round_s"],
                encode_ms=encode_ms, aggregate_ms=aggregate_ms,
                layout_convert_ms_per_tree=convert_ms, wire_form_round_trip_ms=wire_form_ms,
                serialization_ms=ser,
                result={k: v for k, v in result.items() if isinstance(v, (int, float))})


# the code each process of phase (i2) runs: one entry point, as a user starts
# it with ``--cf config --rank r --role ...``, then its result and registry
CS_CHILD = r"""
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import fedml_tpu_torch
from chip_smoke import _registry_flat
from fedml_tpu_torch.telemetry import get_registry
t0 = time.perf_counter()
role = sys.argv[1]
fn = {"server": fedml_tpu_torch.run_cross_silo_server,
      "client": fedml_tpu_torch.run_cross_silo_client}[role]
result = fn()
torch.cuda.synchronize()
print("CHILD " + json.dumps({"role": role, "result": result,
                             "wall_s": time.perf_counter() - t0,
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                             "metrics": _registry_flat(get_registry())}), flush=True)
"""


def cross_silo_broker(card: str):
    """Phase (i2): a server and CS_BROKER_SILOS silos as OS processes over
    the port's broker and a shared object store (see the module doc)."""
    import shutil
    import tempfile

    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
    from fedml_tpu_torch.telemetry import get_registry

    here = os.path.dirname(os.path.abspath(__file__))
    published0 = get_registry().counter("broker/bytes_in").value
    work = tempfile.mkdtemp(prefix="chip_smoke_cs_")
    broker = PubSubBroker("127.0.0.1", 0).start()
    procs = []
    try:
        host, port = broker.address
        cfg = json.loads(json.dumps(CS_CONFIG))
        cfg["common_args"]["run_id"] = "chip_smoke_broker"
        cfg["train_args"].update(client_num_in_total=CS_BROKER_SILOS,
                                 client_num_per_round=CS_BROKER_SILOS, comm_round=1)
        cfg["comm_args"] = {"comm_backend": "BROKER", "broker_host": host,
                            "broker_port": port, "object_store_dir": os.path.join(work, "store"),
                            "payload_offload_bytes": 65536}
        path = os.path.join(work, "fedml_config.yaml")
        with open(path, "w") as f:  # YAML in its JSON form: the card has no PyYAML
            json.dump(cfg, f, indent=1)
        env = dict(os.environ, PYTHONHASHSEED=CS_HASHSEED,
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        for rank in range(CS_BROKER_SILOS + 1):
            role = "server" if rank == 0 else "client"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CS_CHILD, role, "--cf", path, "--rank", str(rank),
                 "--role", role], cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            left = max(1.0, CS_BROKER_TIMEOUT_S - (time.perf_counter() - t0))
            try:
                outs.append(p.communicate(timeout=left))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"a process of the broker federation did not exit within "
                                   f"{CS_BROKER_TIMEOUT_S} s") from None
        wall = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = "\n".join(err[-2000:] for _, err in outs)
            raise RuntimeError(f"the broker federation's processes exited {codes}:\n{tails}")
        kids = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("CHILD "))[6:])
                for out, _ in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        broker.stop()
        published = get_registry().counter("broker/bytes_in").value - published0
        shutil.rmtree(work, ignore_errors=True)
    server = kids[0]
    sm = server["metrics"]
    store_bytes = sum(k["metrics"].get("comm/offload_wire_bytes", 0) for k in kids)
    bcast_offloads = sm.get("comm/serialize_ms{part=offload}", {}).get("count", 0)

    def hist(m, key):
        h = m.get(key, {})
        return h["sum"] / h["count"] if h.get("count") else None

    round_ms = hist(sm, "cross_silo/round_ms")
    ser = dict(broadcast_dumps_ms=hist(sm, "comm/serialize_ms{part=offload}"),
               broadcast_loads_ms=hist(kids[1]["metrics"], "comm/deserialize_ms{part=offload}"),
               upload_dumps_ms=hist(kids[1]["metrics"], "comm/serialize_ms{part=offload}"),
               upload_loads_ms=hist(sm, "comm/deserialize_ms{part=offload}"))
    if server["result"].get("rounds") != 1:
        raise RuntimeError(f"the broker federation's server did not run 1 round: "
                           f"{server['result']}")
    if bcast_offloads != CS_BROKER_SILOS or None in ser.values():
        raise RuntimeError(f"the broadcast did not go through the object store: "
                           f"{bcast_offloads} offloads, {ser}")
    print(f"  {card}: {CS_BROKER_SILOS + 1} processes exited 0 in {wall:.3f} s (limit "
          f"{CS_BROKER_TIMEOUT_S} s); server result {server['result']}", flush=True)
    print(f"  {card}: the round {round_ms:.1f} ms (broadcast to test, the server's "
          f"clock); bytes published on the broker {published:.0f}, written to the store "
          f"{store_bytes:.0f} (the broadcast {CS_BROKER_SILOS}x, each upload once); "
          f"safe_dumps / safe_loads ms (each process's first, cold): broadcast "
          f"{ser['broadcast_dumps_ms']:.2f} / {ser['broadcast_loads_ms']:.2f}, one upload "
          f"{ser['upload_dumps_ms']:.2f} / {ser['upload_loads_ms']:.2f}; process walls "
          + ", ".join(f"{k['role']} {k['wall_s']:.1f} s" for k in kids), flush=True)
    return dict(wall_s=wall, round_ms=round_ms, broker_bytes_published=published,
                store_bytes_written=store_bytes, serialization_ms=ser,
                result=server["result"], process_walls_s=[k["wall_s"] for k in kids],
                peak_gb=[k["peak_gb"] for k in kids])


def step_sum(results, key, rows=DECODE_ROWS):
    """One pass's total over its 225 launches at ``rows`` rows (None where
    a time was not measured)."""
    by = {(r["H"], r["F"]): r[key] for r in results if r["rows"] == rows}
    if any(v is None for v in by.values()):
        return None
    return sum(n * by[s] for s, n in SLICE_SHAPES.items())


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="bcdefghi",
                        help="phases to run after (a), e.g. 'd' for the flash kernels "
                             "alone (default: all; only a full run prints the kernels "
                             "and ok lines)")
    parser.add_argument("--parent", default=None, metavar="DIR",
                        help="a checkout whose dequant and flash-forward kernels are "
                             "timed beside this tree's (phases b and d)")
    opts = parser.parse_args(argv)
    phases = opts.phases
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from fedml_tpu_torch.ops import flash_attention as fa  # fails outside the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peak_bw, peak_flops = card_peaks(name)
    print(f"(a) {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"peaks {peak_bw / 1e12:.2f} TB/s, {peak_flops / 1e12:.0f} TFLOP/s bf16",
          flush=True)
    build_s, logs = build_kernels()
    print(f"    built {len(KERNEL_SOURCES)} kernel(s) in {build_s:.2f} s", flush=True)
    ptxas = {}
    for n, log in logs.items():
        ptxas.update(ptxas_report(log))
        for ln in log.splitlines():
            if "warning" in ln.lower():
                print(f"    {n}: {ln.strip()}", flush=True)
    from fedml_tpu_torch.ops import quant

    smem = {**fa.kernel_smem_bytes(), **quant.kernel_smem_bytes()}
    for kname, info in sorted(ptxas.items()):
        print(f"    {kname}: {info.get('registers')} registers, "
              f"{smem.get(kname, 'static')} bytes of dynamic shared memory, spill stores "
              f"{info.get('spill_stores')} / loads {info.get('spill_loads')} bytes, stack "
              f"{info.get('stack')} bytes", flush=True)

    results = serve = flash = train = quantized = qlora = sp = cross_silo = None
    phase_s = {}
    parent_dequant = parent_fwd = None
    if opts.parent:
        t0 = time.perf_counter()
        parent_dequant, parent_fwd = parent_kernels(opts.parent)
        print(f"    built the kernels of {opts.parent} in {time.perf_counter() - t0:.2f} s",
              flush=True)
    def timed(name, fn):
        """Run one phase and print its seconds; the card is emptied after."""
        t0 = time.perf_counter()
        out = fn()
        gc.collect()  # the phase's models and engines are gone
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t0
        print(f"    phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    if "b" in phases:
        print("(b) dequant_matmul vs plain version", flush=True)
        results = timed("b", lambda: kernel_phase(peak_bw, peak_flops, parent_dequant))
    if "c" in phases:
        print("(c) serve llama3_8b int8", flush=True)
        serve = timed("c", serve_phase)
    if "d" in phases:
        print("(d) flash attention kernels vs plain versions", flush=True)
        flash = timed("d", lambda: flash_phase(peak_bw, peak_flops, parent_fwd))
    if "e" in phases:
        print("(e) federated LoRA rounds of llama3_8b through FedLLMAPI", flush=True)
        train = timed("e", train_phase)
    if "f" in phases:
        print("(f) quantized formats: w8a8 and 4-bit, then llama3_8b served with "
              "--quantize w8a8 and nf4", flush=True)
        quantized = timed("f", lambda: quant_phase(peak_bw, peak_flops, results))
    if "g" in phases:
        print("(g) QLoRA rounds of llama3_8b through FedLLMAPI: nf4 base, then one "
              "round over an int8 base", flush=True)
        qlora = timed("g", lambda: qlora_phase(train))
    if "h" in phases:
        print("(h) the sp FedAvg simulation: resnet18 on the cifar10 stand-in, int8 "
              "uplinks", flush=True)
        sp = timed("h", lambda: sp_phase(card))
    if "i" in phases:
        print("(i1) cross-silo FedAvg in process (LOCAL): resnet18 on the cifar10 "
              "stand-in, 4 silos, int8 uplinks, 2 rounds", flush=True)
        inproc = timed("i1", lambda: cross_silo_inproc(card))
        print(f"(i2) cross-silo FedAvg over the broker: a server and {CS_BROKER_SILOS} "
              "silos as processes, 1 round", flush=True)
        cross_silo = dict(inproc=inproc, broker=timed("i2", lambda: cross_silo_broker(card)))
    os.makedirs("results", exist_ok=True)
    record = {"card": card, "torch": torch.__version__, "build_s": build_s, "ptxas": ptxas,
              "shapes": results, "serve": serve, "flash": flash, "train": train,
              "quantized": quantized, "qlora": qlora, "sp": sp, "cross_silo": cross_silo,
              "phase_s": phase_s}
    if sorted(phases) != list("bcdefghi"):
        with open(os.path.join("results", "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
        print(f"phases {phases} passed (a partial run prints no kernels or ok line)")
        return 0

    kernels = [{
        "name": "dequant_matmul",
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/dequant_matmul.cu",
        "replaces": "fedml_tpu/ops/quant.py:374",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": step_sum(results, "ms"),
        "plain_ms": step_sum(results, "plain_ms"),
        "bound_ms": step_sum(results, "bound_ms"),
        "bound_by": "bytes",
        "library_ms": step_sum(results, "library_ms"),
        "times_are": f"one decode step: the sum over its {LAUNCHES_PER_PASS} "
                     f"launches at {DECODE_ROWS} rows",
        "parent_ms": step_sum(results, "parent_ms"),
        "prefill_128_rows_ms": step_sum(results, "ms", 128),
        "prefill_128_rows_bound_ms": step_sum(results, "bound_ms", 128),
        "pass_ms_by_rows": {rows: step_sum(results, "ms", rows) for rows in ROWS},
        "library": sorted({r["library"] for r in results}),
    }]
    path = flash[0]  # T = S = 2048, causal: the training path's shape
    errs = {n: max(r["errors"][n][0] for r in flash) for n in ("out", "dq", "dk", "dv")}
    for kname, line, err, lib in (
            ("flash_fwd", 63, errs["out"], path["library_fwd_ms"]),
            ("flash_bwd_dq", 168, errs["dq"], path["library_bwd_ms"]),
            ("flash_bwd_dkv", 224, max(errs["dk"], errs["dv"]), path["library_bwd_ms"])):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "fedml_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][kname],
            "max_abs_err": err,
            "ms": path["ms"][kname],
            "plain_ms": path["plain_ms"][kname],
            "bound_ms": path["bound_ms"][kname],
            "bound_by": path["bound_by"][kname],
            "library_ms": lib,
            **({"parent_ms": path["parent_fwd_ms"]} if kname == "flash_fwd" else {}),
            "times_are": "one launch at B=1, H=32, Hkv=8, T=S=2048, D=128, causal",
            "library": ("torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True, enable_gqa=True)"
                        + ("" if kname == "flash_fwd" else
                           " backward: dq, dk and dv together (compare with "
                           "flash_bwd_dq + flash_bwd_dkv)")),
        })
    with open(os.path.join("results", "chip_smoke.json"), "w") as f:
        json.dump(dict(record, kernels=kernels), f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
