"""The port's serving stack (``fedml_tpu_torch/serving``) on the CPU:
greedy token streams identical to the reference engine's, model-slot lease
semantics, and an HTTP round trip through the inference runner."""
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from fedml_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from fedml_tpu.models.llm.llama import LlamaForCausalLM as JaxLlama
from fedml_tpu.serving.llm_engine import ContinuousBatchingEngine as JaxEngine
from fedml_tpu_torch.cli import build_endpoint, build_parser
from fedml_tpu_torch.models.llm.convert import from_jax_params, load_weights
from fedml_tpu_torch.models.llm.llama import LlamaConfig, LlamaForCausalLM
from fedml_tpu_torch.ops import quant as tq
from fedml_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EndpointMonitor,
    FedMLInferenceRunner,
    FedMLPredictor,
    LlamaPredictor,
)
from fedml_tpu_torch.serving.live.slots import ModelSlots


@pytest.fixture(scope="module")
def shared_tiny():
    """(jax model, jax params, port model) on the same fp32 tiny weights."""
    jm = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, use_flash=False))
    params = meta.unbox(jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, use_flash=False),
                          device="cpu")
    load_weights(tm, from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _drive(eng, prompts, max_new):
    """Run the engine loop's admission policy synchronously to completion."""
    qs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(500):
        admitted = 0
        while eng.active_slots < eng.n_slots and not eng._requests.empty():
            if eng.active_slots and admitted >= eng.admit_per_step:
                break
            eng._admit(eng._requests.get())
            admitted += 1
        if eng.active_slots == 0 and eng._requests.empty():
            break
        eng.step()
    streams = []
    for q in qs:
        toks = []
        while (t := q.get_nowait()) is not None:
            toks.append(t)
        streams.append(toks)
    return streams, list(eng.oplog)


@pytest.mark.parametrize("quantize", [None, "int8_dequant"])
def test_greedy_streams_identical_to_reference_engine(shared_tiny, quantize):
    jm, params, tm = shared_tiny
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 11, 19)]
    want, want_ops = _drive(JaxEngine(jm, params, batch_slots=2, max_len=64,
                                      quantize=quantize, quantize_min_size=1024),
                            prompts, 7)
    eng = ContinuousBatchingEngine(tm, batch_slots=2, max_len=64, quantize=quantize,
                                   quantize_min_size=1024, device="cpu")
    got, got_ops = _drive(eng, prompts, 7)
    assert got == want
    assert got_ops == want_ops  # same prefill buckets, same decode batches
    assert all(len(s) == 7 for s in got)
    if quantize:  # the engine served a quantized copy; the caller's model is intact
        assert isinstance(eng.params.layer_0.mlp.gate_proj.kernel, tq.QuantizedTensor)
        assert isinstance(tm.layer_0.mlp.gate_proj.kernel, torch.nn.Parameter)


def test_engine_thread_serves_and_rejects_bad_modes(shared_tiny):
    _, _, tm = shared_tiny
    eng = ContinuousBatchingEngine(tm, batch_slots=2, max_len=32, device="cpu").start()
    try:
        outs = [eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(3)]
        toks = [[t for t in iter(q.get, None)] for q in outs]
        assert [len(t) for t in toks] == [4, 4, 4]
        assert toks[0] == toks[1] == toks[2]  # same prompt, greedy
    finally:
        eng.stop()
    assert eng.failure is None
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(tm, quantize="int3", device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        ContinuousBatchingEngine(tm, quantize="nf4", device="cpu")
    with pytest.raises(ValueError):
        eng.submit([1] * 30, max_new_tokens=8)


def test_model_slots_publish_and_lease_semantics():
    transformed = []
    slots = ModelSlots({"gen": 0}, transform=lambda p: transformed.append(p) or p)
    assert slots.live_round is None
    lease0 = slots.acquire()
    assert slots.publish_payload({"gen": 1}, round_idx=1)
    assert transformed == [{"gen": 1}]  # the transform ran on a copy
    assert slots.live_params == {"gen": 1} and slots.live_round == 1
    assert lease0.params == {"gen": 0}  # a held lease keeps its generation
    old = lease0._slot
    lease0.release()
    lease0.release()  # idempotent
    assert old.reclaimed.is_set() and old.params is None
    assert not slots.publish({"gen": 0}, round_idx=1)  # stale: dropped
    assert not slots.publish_payload({"gen": -1}, round_idx=0)
    assert slots.stale_drops == 2 and slots.live_round == 1
    with slots.acquire() as lease:
        assert slots.publish({"gen": 2}, round_idx=2)
        assert lease.round_idx == 1 and lease.params == {"gen": 1}
    assert slots.swap_count == 2


def test_grouped_decode_pins_streams_to_their_generation(shared_tiny):
    """A swap mid-stream: the in-flight stream finishes on its admission
    weights (grouped decode), the next stream runs on the new ones."""
    _, _, tm = shared_tiny
    eng = ContinuousBatchingEngine(tm, batch_slots=2, max_len=64, device="cpu")
    ref, _ = _drive(ContinuousBatchingEngine(tm, batch_slots=1, max_len=64,
                                             device="cpu"), [[3, 1, 4, 1, 5]], 6)
    q0 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
    eng._admit(eng._requests.get())
    eng.step()
    other = LlamaForCausalLM(tm.cfg, device="cpu", seed=7)
    assert eng.model_slots.publish(other, round_idx=1)
    q1 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
    eng._admit(eng._requests.get())
    while eng.active_slots:
        eng.step()
    assert any(op[0] == "decode_part" for op in eng.oplog)
    got0 = [t for t in iter(q0.get, None)]
    assert got0 == ref[0] and q0.round_idx is None and q1.round_idx == 1
    assert len([t for t in iter(q1.get, None)]) == 6


class _Echo(FedMLPredictor):
    def predict(self, request):
        if request.get("stream"):
            return iter([{"token": 1}, {"done": True}])
        if request.get("boom"):
            raise ValueError("boom")
        return {"echo": request}


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_http_round_trip_through_runner_and_engine(shared_tiny):
    _, _, tm = shared_tiny
    eng = ContinuousBatchingEngine(tm, batch_slots=2, max_len=32, device="cpu")
    monitor = EndpointMonitor("tiny-test")
    runner = FedMLInferenceRunner(LlamaPredictor(eng), host="127.0.0.1", port=0,
                                  monitor=monitor).start()
    eng.model_slots.monitor = monitor
    try:
        base = f"http://127.0.0.1:{runner.port}"
        want = eng.generate([5, 6, 7], max_new_tokens=5)
        results = [None] * 3

        def call(i):
            results[i] = json.loads(_http(base + "/predict", {
                "prompt_tokens": [5, 6, 7], "max_new_tokens": 5})[1])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [r["tokens"] for r in results] == [want] * 3
        status, body = _http(base + "/predict", {"prompt_tokens": [5, 6, 7],
                                                 "max_new_tokens": 3, "stream": True})
        chunks = [json.loads(ln) for ln in body.decode().splitlines()]
        assert chunks[-1] == {"done": True} and [c["token"] for c in chunks[:-1]] == want[:3]
        # the runner records a request after its body has gone out (as the
        # reference runner does), so the fourth may land just after the
        # client has read the end of the stream: poll until it does
        deadline = time.monotonic() + 5.0
        ready = json.loads(_http(base + "/ready")[1])
        while ready["requests"] < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
            ready = json.loads(_http(base + "/ready")[1])
        assert ready["ready"] is True and ready["requests"] == 4
        assert ready["errors"] == 0 and "ttft_p95_ms" in ready
        status, metrics = _http(base + "/metrics")
        assert status == 200 and b"serving_ttft_ms_count" in metrics
    finally:
        runner.stop()
        eng.stop()


def test_runner_errors_and_shedding():
    runner = FedMLInferenceRunner(_Echo(), host="127.0.0.1", port=0,
                                  monitor=EndpointMonitor("echo")).start()
    try:
        base = f"http://127.0.0.1:{runner.port}"
        assert json.loads(_http(base + "/predict", {"a": 1})[1]) == {"echo": {"a": 1}}
        with pytest.raises(urllib.error.HTTPError) as err:
            _http(base + "/predict", {"boom": True})
        assert err.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as err:
            _http(base + "/nope", {})
        assert err.value.code == 404
        snap = runner.monitor.snapshot()
        assert snap["requests"] == 2 and snap["errors"] == 1
    finally:
        runner.stop()


def test_cli_serve_builds_a_cpu_endpoint():
    args = build_parser().parse_args(
        ["serve", "--model", "tiny", "--device", "cpu", "--port", "0",
         "--batch-slots", "2", "--max-len", "64", "--quantize", "int8"])
    engine, runner = build_endpoint(args)
    try:
        assert engine.cfg.param_dtype == torch.bfloat16
        assert engine.generate([1, 2, 3], max_new_tokens=2).__len__() == 2
    finally:
        runner.stop()
        engine.stop()
    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", "--quantize", "int4"])
