#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases — any failure raises, and the script then exits non-zero without
the final ``ok`` line:

(a) print the card's name and power limit; build every CUDA kernel of the
    port from ``fedml_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all
    started together) and print the build time and ptxas report;
(b) hold the int8 dequant-matmul kernel against its plain PyTorch version
    at every Llama-3-8B projection shape and 1/8/16/128 rows, and time the
    kernel, the plain version and a one-call PyTorch yardstick with CUDA
    events, beside the card's bound for the same work;
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
    that two planted faults fail that check, and time each kernel, its
    plain version and ``scaled_dot_product_attention`` (forward; backward)
    beside the bound;
(e) after the serve phase's weights are freed, run federated LoRA rounds
    of Llama-3-8B at full width and depth through ``FedLLMAPI`` with the
    on-device round (rank 16, bf16 base, T=2048, batch 1, 4 of 8 clients ×
    2 local steps, 2 rounds, test each round), with the flash launch counts
    read around exactly ``train()`` and required to be 32 per forward and
    backward; print seconds per round, tokens/s, peak memory and the device
    busy share of one round (with its device time by kernel class); hold
    layer 0's attention output and LoRA gradients, every layer's flash
    output on the model's own activations, and the model's loss on one
    batch, kernels against plain versions.

The last lines are the card line, one ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with code 2 and prints no result. The full per-shape results also go to
``results/chip_smoke.json``.
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
ROWS = (1, 8, 16, 128)
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


def kernel_phase(peak_bw: float, peak_flops: float):
    """Phase (b): kernel vs plain version at every slice shape and row count."""
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
            want = quant.dequant_matmul_reference(x, qt.data, qt.scale, torch.bfloat16)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # one bf16 ulp of the largest output: both sums are exact products
            # added in f32 in different orders, then rounded once to bf16
            tol = 2.0 ** -7 * want.float().abs().max().item()
            if not (math.isfinite(err) and err <= tol and torch.isfinite(got).all()):
                raise RuntimeError(f"kernel disagrees with its plain version at "
                                   f"H={h} F={f} rows={rows}: {err} > {tol}")
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
            ms = device_ms([lambda i=i: quant.dequant_matmul_cuda(x, qs[i], ss[i])
                            for i in range(n_copies)], reps)
            plain_ms = device_ms(
                [lambda i=i: quant.dequant_matmul_reference(x, qs[i], ss[i],
                                                            torch.bfloat16)
                 for i in range(n_copies)], reps)
            library_ms = device_ms(lib_calls, reps)
            nbytes = h * f + 2 * rows * (h + f) + 4 * f
            flops = 2 * rows * h * f
            bytes_ms, flops_ms = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
            rec = dict(H=h, F=f, rows=rows, max_abs_err=err, tol=tol, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms, library=library,
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                       weight_gb_per_s=h * f / ms / 1e6)
            results.append(rec)
            print(f"  H={h:5d} F={f:6d} rows={rows:3d}  err {err:.4g} (tol {tol:.4g})"
                  f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"{library} {library_ms:.4f} ms  bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']})  {rec['weight_gb_per_s']:.0f} GB/s", flush=True)
        del qs, ss, qts, qt
        torch.cuda.empty_cache()
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
        flops_ms = per_pair * b * h * d * pairs / peak_flops * 1e3
        bytes_ms = nbytes / peak_bw * 1e3
        out[name] = (max(flops_ms, bytes_ms),
                     "operations" if flops_ms >= bytes_ms else "bytes")
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


def flash_phase(peak_bw: float, peak_flops: float):
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
        faults = None
        if (t, s, causal) == FLASH_SHAPES[0]:
            faults = planted_faults(fa, q, k, v, do, lse, delta, scale,
                                    dict(dq=dq_p, dk=dk_p, dv=dv_p))

        reps = 20
        ms = {
            "flash_fwd": device_ms([lambda: fa.flash_forward_cuda(q, k, v, causal, scale)],
                                   reps),
            "flash_bwd_dq": device_ms([lambda: fa.flash_dq_cuda(
                q, k, v, do, lse, delta, causal, scale)], reps),
            "flash_bwd_dkv": device_ms([lambda: fa.flash_dkv_cuda(
                q, k, v, do, lse, delta, causal, scale)], reps),
        }
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
        rec = dict(T=t, S=s, causal=causal, errors=errs, planted_faults=faults, ms=ms,
                   plain_ms=plain_ms, library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
                   bound_ms={n: v[0] for n, v in bounds.items()},
                   bound_by={n: v[1] for n, v in bounds.items()})
        results.append(rec)
        for n in ms:
            lib = lib_fwd if n == "flash_fwd" else lib_bwd
            print(f"    {n:14s} kernel {ms[n]:.4f} ms  plain {plain_ms[n]:.4f} ms  "
                  f"bound {bounds[n][0]:.4f} ms ({bounds[n][1]})  "
                  f"{'sdpa fwd' if n == 'flash_fwd' else 'sdpa bwd (dq+dk+dv)'} "
                  f"{lib:.4f} ms", flush=True)
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

    # --- steady decode at 8 slots, engine driven directly ---
    for _ in range(engine.n_slots):
        engine.submit(rng.integers(0, cfg.vocab_size, size=64).tolist(),
                      max_new_tokens=48)
    for _ in range(engine.n_slots):
        engine._admit(engine._requests.get_nowait())
    for _ in range(2):
        engine.step()
    n_steps = 30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    step_s = (time.perf_counter() - t0) / n_steps
    # device time per step from the profiler's kernel records; the wall time
    # is the unprofiled one above (the profiler slows the host side)
    n_prof = 5
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


def train_phase():
    """Phase (e): federated LoRA rounds of Llama-3-8B through FedLLMAPI."""
    import types

    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import causal_lm_loss, rope_tables
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    from fedml_tpu_torch.train.llm.trainer import extract_lora

    args = types.SimpleNamespace(**TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = FedLLMAPI(args, "cuda", load_synthetic_lm(args))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    engine, cfg = api.client.engine, api.cfg
    lora_n = sum(p.numel() for p in extract_lora(engine.model).values())
    print(f"  booted {args.model_size} (LoRA rank {cfg.lora_rank}, {lora_n} adapter parameters) "
          f"in {boot_s:.1f} s: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated",
          flush=True)

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
    return dict(launches=launches, expected_launches=expected, rounds=rounds,
                summary={k: v for k, v in summary.items() if isinstance(v, (int, float))},
                boot_s=boot_s, train_wall_s=train_wall_s, round_wall_s=round_wall_s,
                tokens_per_round=tokens_per_round, tokens_per_s=tokens_per_round / steady,
                step_flops=step_flops, model_tflops_per_s=round_flops / steady / 1e12,
                peak_gb=peak_gb, device_ms_per_round=dev_ms, device_busy_share=busy,
                device_ms_by_class=by_class,
                top_kernels=[dict(ms=m_, count=c_, name=k_) for m_, c_, k_ in by_kernel[:20]],
                attention_row_err=attn_errs, layer_flash_row_err=layer_errs,
                loss_kernel=loss_k, loss_plain=loss_p,
                loss_rel_err=loss_rel, lora_params=lora_n)


def step_sum(results, key):
    """One decode step's total over its 225 launches at DECODE_ROWS rows."""
    by = {(r["H"], r["F"]): r[key] for r in results if r["rows"] == DECODE_ROWS}
    return sum(n * by[s] for s, n in SLICE_SHAPES.items())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from fedml_tpu_torch.ops import quant  # noqa: F401 - fails outside the repo

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
    for n, log in logs.items():
        print(f"    {n}: " + " | ".join(ln.strip() for ln in log.splitlines()
                                         if "registers" in ln), flush=True)

    print("(b) dequant_matmul vs plain version", flush=True)
    results = kernel_phase(peak_bw, peak_flops)
    print("(c) serve llama3_8b int8", flush=True)
    serve = serve_phase()
    gc.collect()  # the serve phase's engine and weights are gone
    torch.cuda.empty_cache()
    print("(d) flash attention kernels vs plain versions", flush=True)
    flash = flash_phase(peak_bw, peak_flops)
    print("(e) federated LoRA rounds of llama3_8b through FedLLMAPI", flush=True)
    train = train_phase()

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
            "times_are": "one launch at B=1, H=32, Hkv=8, T=S=2048, D=128, causal",
            "library": ("torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True, enable_gqa=True)"
                        + ("" if kname == "flash_fwd" else
                           " backward: dq, dk and dv together (compare with "
                           "flash_bwd_dq + flash_bwd_dkv)")),
        })
    os.makedirs("results", exist_ok=True)
    with open(os.path.join("results", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "shapes": results,
                   "serve": serve, "flash": flash, "train": train, "kernels": kernels},
                  f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
