"""Continuous-batching decode engine over the Llama KV cache — counterpart
of ``fedml_tpu/serving/llm_engine.py``, with the same scheduling.

The engine owns a fixed pool of batch slots, each with its own row in a
shared ``[B, H_kv, S, D]`` KV cache per layer, and runs

- a **prefill** per request: the prompt, padded to a power-of-two bucket,
  runs in one forward pass over a view of its slot's cache rows (written in
  place);
- one **decode** step for the whole pool — every active slot advances one
  token per step whenever its request arrived (continuous batching);
- a **grouped decode** during a weight swap, when streams pinned to two
  weight generations must each decode against their own model.

Greedy argmax runs on the device and only the ``[B]`` int32 tokens are
read back. With ``quantize`` set to ``int8`` (or ``int8_pallas`` /
``pallas``) every projection and the LM head of a ≤128-row call go through
the hand-written CUDA dequant-matmul; ``int8_dequant`` is the plain
PyTorch lowering; ``w8a8`` (or ``int8_w8a8``) quantizes each activation
row to int8 and multiplies int8 × int8 into int32 (``torch._int_mm`` on
CUDA); ``int4`` and ``nf4`` keep the weights packed two codes a byte and
dequantize each per call. The per-request ``req/*`` span tree waits for
the serving slice (ROADMAP A7, on A12a's span layer).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.ops.quant import quantize_params_int4, quantize_params_int8
from fedml_tpu_torch.serving.live.slots import ModelSlots, SlotLease
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.telemetry.profiling import wrap_program

logger = logging.getLogger(__name__)

INT8_MODES = {"int8": "kernel", "int8_pallas": "kernel", "pallas": "kernel",
              "int8_dequant": "dequant", "int8_w8a8": "w8a8", "w8a8": "w8a8"}


class TokenStream(queue.Queue):
    """The per-request token queue: yields ints then a final ``None``.

    ``round_idx`` names the weight generation that served it (set at
    admission); ``error`` holds the engine's exception if the engine died
    before the stream finished.
    """

    round_idx: Optional[int] = None
    error: Optional[BaseException] = None


@dataclass
class _Slot:
    request_id: int = -1
    out: Optional[TokenStream] = None
    last_token: int = 0
    generated: int = 0
    max_new: int = 0
    temperature: float = 0.0
    rng: Optional[np.random.Generator] = None
    eos_id: Optional[int] = None
    active: bool = False
    tokens: List[int] = field(default_factory=list)
    lease: Optional[SlotLease] = None
    t_admit_mono: float = 0.0
    tok_mono: List[float] = field(default_factory=list)


def _on_device(t_dev: torch.device, want: torch.device) -> bool:
    return t_dev.type == want.type and (want.index is None
                                        or t_dev.index == want.index)


class ContinuousBatchingEngine:
    """Schedules generation requests onto a fixed slot pool.

    ``model`` is a ``LlamaForCausalLM`` holding its weights on ``device``.
    With ``quantize`` set (``int8``, ``int8_pallas``, ``pallas``,
    ``int8_dequant``, ``w8a8``, ``int8_w8a8``, ``int4`` or ``nf4``),
    ``quantize_donate=True`` quantizes that model in place, dropping each
    full-precision kernel as its quantized twin is built — the caller's
    model is then the served one. By default the engine serves a quantized
    copy and the caller's model is untouched.
    """

    def __init__(
        self,
        model: Any,
        batch_slots: int = 4,
        max_len: int = 256,
        quantize: Optional[str] = None,
        quantize_donate: bool = False,
        quantize_min_size: int = 65536,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if not _on_device(model.device, self.device):
            raise ValueError(f"model weights are on {model.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = model.cfg
        param_transform = None
        min_size = int(quantize_min_size)
        if quantize in INT8_MODES:
            mode = INT8_MODES[quantize]
            model = quantize_params_int8(model, mode=mode, min_size=min_size,
                                         donate=quantize_donate)
            # published generations land in the same int8 representation;
            # ModelSlots.stage hands the transform a private copy
            param_transform = lambda m: quantize_params_int8(  # noqa: E731
                m, mode=mode, min_size=min_size, donate=True)
        elif quantize in ("int4", "nf4"):
            fmt = quantize
            model = quantize_params_int4(model, fmt=fmt, min_size=min_size,
                                         donate=quantize_donate)
            param_transform = lambda m: quantize_params_int4(  # noqa: E731
                m, fmt=fmt, min_size=min_size, donate=True)
        elif quantize is not None:
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        self.model_slots = ModelSlots(model, transform=param_transform)
        self._round_in_use = self.model_slots.live_round
        self._last_step_end: Optional[float] = None
        self.n_slots = int(batch_slots)
        self.max_len = int(max_len)
        cfg = self.cfg
        shape = (self.n_slots, cfg.num_key_value_heads, self.max_len, cfg.head_dim)
        self.caches = [
            (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.num_hidden_layers)
        ]
        self.lengths = np.zeros((self.n_slots,), np.int32)
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self._buckets = []
        b = 16  # smallest prompt bucket
        while b < self.max_len:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_len)
        self._requests: "queue.Queue" = queue.Queue()
        self._req_counter = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self.failure: Optional[BaseException] = None
        # each prefill stalls every active decode stream: admit at most this
        # many queued requests between decode steps
        self.admit_per_step = 1
        self.oplog: deque = deque(maxlen=4096)  # ("prefill"|"decode", ...)
        # cataloged (telemetry.profiling) under the reference's names: one
        # prefill variant per prompt bucket and one decode-group variant per
        # group size, by design
        self._prefill = wrap_program("serve/prefill", self._prefill, multi_shape=True)
        self._decode = wrap_program("serve/decode", self._decode)
        self._decode_group = wrap_program("serve/decode_group", self._decode_group,
                                          multi_shape=True)

        # request observability: TTFT / TPOT attribution and saturation
        # gauges; the per-token seam is one perf_counter + list append
        reg = get_registry()
        self._h_ttft = reg.histogram("serving/ttft_ms")
        self._h_tpot = reg.histogram("serving/tpot_ms")
        self._g_tps = reg.gauge("serving/tokens_per_s")
        self._g_occupancy = reg.gauge("serving/batch_occupancy")
        self._g_queue_depth = reg.gauge("serving/queue_depth")
        self._g_tokens_in_flight = reg.gauge("serving/tokens_in_flight")
        self._g_kv_used = reg.gauge("serving/kv_bytes_in_use")
        self._g_kv_alloc = reg.gauge("serving/kv_bytes_allocated")
        self._kv_alloc_bytes = float(sum(
            k.numel() * k.element_size() + v.numel() * v.element_size()
            for k, v in self.caches))
        self._g_kv_alloc.set(self._kv_alloc_bytes)

    @property
    def params(self) -> Any:
        """The currently published weight generation (live slot's model)."""
        return self.model_slots.live_params

    # -- device programs ----------------------------------------------------
    def _prefill(self, model, tokens: torch.Tensor, slot: int, true_len: int):
        """tokens [1, P] (padded): fill the slot's cache rows in place and
        return the next-token logits at the prompt's true end + argmax."""
        sub = [(k[slot:slot + 1], v[slot:slot + 1], 0) for k, v in self.caches]
        p_len = tokens.shape[1]
        logits, _ = model(tokens, positions=torch.arange(
            p_len, device=self.device)[None], kv_caches=sub)
        last = logits[0, true_len - 1]
        return last, torch.argmax(last).to(torch.int32)

    def _decode(self, model, last_tokens: torch.Tensor, lengths: torch.Tensor):
        """One token for every slot: [B] → [B, V] logits + greedy [B]."""
        sub = [(k, v, lengths) for k, v in self.caches]
        logits, _ = model(last_tokens[:, None], positions=lengths[:, None],
                          kv_caches=sub)
        logits = logits[:, 0, :]
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    def _decode_group(self, model, last_tokens, lengths, idx: torch.Tensor):
        """Advance only the slot rows in ``idx`` with THIS model; the other
        rows (the other weight generation's) are untouched."""
        idx_len = lengths[idx]
        sub = [(k[idx], v[idx], idx_len) for k, v in self.caches]
        logits, new_sub = model(last_tokens[idx][:, None],
                                positions=idx_len[:, None], kv_caches=sub)
        for (k, v), (nk, nv, _) in zip(self.caches, new_sub):
            k[idx] = nk
            v[idx] = nv
        logits = logits[:, 0, :]
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    # -- public API ---------------------------------------------------------
    def submit(
        self,
        prompt_tokens: List[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> TokenStream:
        """Enqueue a generation request; returns its token stream."""
        if self.failure is not None:
            raise RuntimeError("serving engine failed") from self.failure
        if len(prompt_tokens) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(prompt_tokens)}) + max_new({max_new_tokens}) "
                f"exceeds max_len={self.max_len}"
            )
        out = TokenStream()
        with self._lock:
            self._req_counter += 1
            rid = self._req_counter
        self._requests.put(
            (rid, list(map(int, prompt_tokens)), int(max_new_tokens),
             float(temperature), int(seed), eos_id, out)
        )
        return out

    def generate(self, prompt_tokens, max_new_tokens=32, temperature=0.0,
                 seed=0, eos_id=None) -> List[int]:
        """Blocking convenience wrapper: returns the full generation."""
        q = self.submit(prompt_tokens, max_new_tokens, temperature, seed, eos_id)
        toks = []
        while True:
            t = q.get()
            if t is None:
                if q.error is not None:
                    raise RuntimeError("serving engine failed") from q.error
                return toks
            toks.append(t)

    def start(self) -> "ContinuousBatchingEngine":
        if self._thread is None:
            self._stopping.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def active_slots(self) -> int:
        return sum(s.active for s in self.slots)

    # -- engine loop --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.max_len

    def _sample(self, slot: _Slot, logits: np.ndarray) -> int:
        if slot.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / slot.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(slot.rng.choice(len(p), p=p))

    def _note_slot_use(self, lease: SlotLease) -> None:
        """Swap-stall accounting: the first admission on a freshly published
        slot reports the pause since the last device step (0 if idle)."""
        if lease.round_idx is None or lease.round_idx == self._round_in_use:
            return
        prev = self._round_in_use
        self._round_in_use = lease.round_idx
        if prev is None:
            return
        stall_ms = 0.0
        if self.active_slots and self._last_step_end is not None:
            stall_ms = max(0.0, (time.perf_counter() - self._last_step_end) * 1e3)
        self.model_slots.record_swap_stall(lease.round_idx, stall_ms)

    def _retire(self, slot: _Slot) -> None:
        if slot.tok_mono:
            self._finish_request_obs(slot)
        slot.out.put(None)
        slot.active = False
        if slot.lease is not None:
            slot.lease.release()
            slot.lease = None
        self._sample_saturation()

    def _finish_request_obs(self, slot: _Slot) -> None:
        """One retired stream's TTFT / TPOT / tokens-per-s, into the registry
        and the endpoint monitor; runs once per request, off the per-token
        path, and never kills the stream."""
        try:
            first, last = slot.tok_mono[0], slot.tok_mono[-1]
            ttft_ms = (first - slot.t_admit_mono) * 1e3
            tpot_ms = [(b - a) * 1e3
                       for a, b in zip(slot.tok_mono, slot.tok_mono[1:])]
            gen_s = last - slot.t_admit_mono
            tps = len(slot.tok_mono) / gen_s if gen_s > 0 else 0.0
            self._h_ttft.observe(ttft_ms)
            for v in tpot_ms:
                self._h_tpot.observe(v)
            self._g_tps.set(round(tps, 3))
            monitor = getattr(self.model_slots, "monitor", None)
            if monitor is not None:
                monitor.record_stream(ttft_ms, tpot_ms, tps)
        except Exception:  # noqa: BLE001 - observability must not kill
            logger.exception("request observability failed")

    def _sample_saturation(self) -> None:
        """Refresh occupancy, queue depth, tokens in flight, KV bytes."""
        active_tokens = 0
        n_active = 0
        for i, s in enumerate(self.slots):
            if s.active:
                n_active += 1
                active_tokens += int(self.lengths[i])
        self._g_occupancy.set(n_active / self.n_slots)
        self._g_queue_depth.set(float(self._requests.qsize()))
        self._g_tokens_in_flight.set(float(active_tokens))
        self._g_kv_used.set(self._kv_alloc_bytes * active_tokens
                            / (self.n_slots * self.max_len))

    def _admit(self, req) -> None:
        rid, prompt, max_new, temp, seed, eos, out = req
        slot_idx = next(i for i, s in enumerate(self.slots) if not s.active)
        t_admit_mono = time.perf_counter()
        # pin the request to the CURRENT weight generation for its lifetime
        lease = self.model_slots.acquire()
        self._note_slot_use(lease)
        p = self._bucket(len(prompt))
        self.oplog.append(("prefill", p, self.active_slots))
        padded = np.zeros((1, p), np.int64)
        padded[0, : len(prompt)] = prompt
        with torch.inference_mode():
            last_logits, greedy = self._prefill(
                lease.params, torch.from_numpy(padded).to(self.device),
                slot_idx, len(prompt))
            greedy = int(greedy)
            if temp > 0.0:
                last_logits = last_logits.cpu().numpy()
        self._last_step_end = time.perf_counter()
        slot = self.slots[slot_idx]
        slot.lease = lease
        out.round_idx = lease.round_idx
        slot.request_id = rid
        slot.out = out
        slot.generated = 0
        slot.max_new = max_new
        slot.temperature = temp
        slot.rng = np.random.default_rng(seed)
        slot.eos_id = eos
        slot.active = True
        slot.tokens = []
        slot.t_admit_mono = t_admit_mono
        slot.tok_mono = []
        self.lengths[slot_idx] = len(prompt)
        self._sample_saturation()
        if slot.temperature > 0.0:
            self._emit(slot_idx, logits=last_logits)
        else:
            self._emit(slot_idx, tok=greedy)

    def _emit(self, slot_idx: int, logits: Optional[np.ndarray] = None,
              tok: Optional[int] = None) -> None:
        """Stream one token for a slot; retire on EOS/max."""
        slot = self.slots[slot_idx]
        if tok is None:
            tok = self._sample(slot, logits)
        slot.last_token = tok
        slot.generated += 1
        slot.tokens.append(tok)
        slot.tok_mono.append(time.perf_counter())
        slot.out.put(tok)
        if (slot.eos_id is not None and tok == slot.eos_id) or (
            slot.generated >= slot.max_new
        ):
            self._retire(slot)

    def _loop(self) -> None:
        # inference mode is thread-local: it is entered on the engine thread
        with torch.inference_mode():
            try:
                self._run()
            except Exception as exc:  # noqa: BLE001 - end every stream loudly
                logger.exception("serving engine failed")
                self._fail_all(exc)

    def _run(self) -> None:
        while not self._stopping.is_set():
            # admit waiting requests into free slots — at most
            # admit_per_step per decode step while decodes are in flight
            admitted = 0
            while self.active_slots < self.n_slots:
                if self.active_slots and admitted >= self.admit_per_step:
                    break
                try:
                    if self.active_slots:
                        req = self._requests.get_nowait()
                    else:
                        req = self._requests.get(timeout=0.2)
                except queue.Empty:
                    break
                self._admit(req)
                admitted += 1
            if self.active_slots == 0:
                continue
            self.step()

    def _fail_all(self, exc: BaseException) -> None:
        """The engine died: end every active and queued stream with the
        error, so no caller waits forever."""
        self.failure = exc
        outs = [s.out for s in self.slots if s.active]
        while True:
            try:
                outs.append(self._requests.get_nowait()[-1])
            except queue.Empty:
                break
        for out in outs:
            out.error = exc
            out.put(None)

    def step(self) -> None:
        """One batched decode step for every active slot.

        When every active stream leases the same weight generation, the
        whole pool decodes in one pass; during a swap transition the step
        partitions by generation (oldest round first) and advances each
        group with its own model.
        """
        with torch.inference_mode():
            self._step()

    def _step(self) -> None:
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return
        groups: Dict[int, List[int]] = {}
        leases: Dict[int, SlotLease] = {}
        for i in active:
            lease = self.slots[i].lease
            key = id(lease._slot)
            groups.setdefault(key, []).append(i)
            leases[key] = lease
        last = torch.tensor([s.last_token for s in self.slots],
                            dtype=torch.long).to(self.device)
        lengths = torch.tensor(self.lengths, device=self.device)
        greedy_by: Dict[int, int] = {}
        logits_by: Dict[int, np.ndarray] = {}
        if len(groups) == 1:
            (key,) = groups
            self.oplog.append(("decode", len(active), 0))
            logits_dev, greedy_dev = self._decode(leases[key].params, last, lengths)
            # pull the [B, V] logits only if some active slot samples
            need = any(self.slots[i].temperature > 0.0 for i in active)
            logits = logits_dev.cpu().numpy() if need else None
            greedy = greedy_dev.cpu().numpy()
            for i in active:
                greedy_by[i] = int(greedy[i])
                if logits is not None:
                    logits_by[i] = logits[i]
        else:
            order = sorted(groups, key=lambda k: (
                -1 if leases[k].round_idx is None else leases[k].round_idx))
            for key in order:
                idxs = groups[key]
                self.oplog.append(("decode_part", len(idxs), 0))
                logits_dev, greedy_dev = self._decode_group(
                    leases[key].params, last, lengths,
                    torch.tensor(idxs, dtype=torch.long).to(self.device))
                need = any(self.slots[i].temperature > 0.0 for i in idxs)
                logits = logits_dev.cpu().numpy() if need else None
                greedy = greedy_dev.cpu().numpy()
                for j, i in enumerate(idxs):
                    greedy_by[i] = int(greedy[j])
                    if logits is not None:
                        logits_by[i] = logits[j]
        for i in active:
            slot = self.slots[i]
            # this step wrote the slot's last token at position lengths[i]
            self.lengths[i] += 1
            if self.lengths[i] >= self.max_len:
                self._retire(slot)
                continue
            if slot.temperature > 0.0:
                self._emit(i, logits=logits_by[i])
            else:
                self._emit(i, tok=greedy_by[i])
        self._last_step_end = time.perf_counter()
        self._sample_saturation()
