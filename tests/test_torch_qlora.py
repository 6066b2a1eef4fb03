"""QLoRA in the port (``base_quantize``: int8, int4, nf4) against the
reference's JAX trainer, on the CPU, in fp32 on the tiny model with the
shapes of ``tests/test_qlora.py``: the reference's quantized base is
carried into the port byte for byte (``from_jax_params``), so both train
LoRA adapters over identical codes."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from fedml_tpu.ops import quant as jq
from fedml_tpu.train.llm import trainer as jtrainer
from fedml_tpu_torch.models.llm.convert import (
    exchange_to_numpy,
    from_jax_params,
    load_weights,
    to_exchange,
)
from fedml_tpu_torch.models.llm.llama import LlamaConfig
from fedml_tpu_torch.ops import quant as tq
from fedml_tpu_torch.train.llm import trainer as ttrainer

SEQ, BATCH, VOCAB = 16, 4, 256
FORMATS = ["int8", "int4", "nf4"]


def _jargs(fmt, **kw):
    """The reference test's ``_QArgs`` (its mesh over 8 virtual devices)."""
    base = dict(max_seq_length=SEQ, per_device_batch_size=BATCH,
                gradient_accumulation_steps=1, learning_rate=1e-2, mesh_dp=1,
                mesh_fsdp=4, mesh_tp=2, mesh_sp=1, random_seed=0, base_quantize=fmt,
                base_quantize_min_size=1024)
    base.update(kw)
    return type("QArgs", (), base)()


def _targs(fmt, **kw):
    return _jargs(fmt, mesh_fsdp=1, mesh_tp=1, **kw)


def _quant_leaves_to_numpy(tree):
    def conv(leaf):
        if isinstance(leaf, jq.QuantizedTensor4):
            return (np.asarray(leaf.data), np.asarray(leaf.scale), leaf.orig_shape,
                    leaf.fmt, leaf.block)
        if isinstance(leaf, jq.QuantizedTensor):
            return (np.asarray(leaf.data), np.asarray(leaf.scale))
        return np.asarray(leaf)

    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(
        x, (jq.QuantizedTensor, jq.QuantizedTensor4)))


def _quantized(model):
    return [q for _, q in tq.named_quantized_weights(model)]


def _load_reference_base(ttr, jparams):
    """Install the reference trainer's weights (its quantized base as is)
    into the port trainer; ``load_weights`` keeps the trainer's own int8
    mode (``dequant``, as there)."""
    load_weights(ttr.model, from_jax_params(_quant_leaves_to_numpy(jparams)))


def _qpair(fmt, seed=0, lora_b_seed=7):
    """(JAX trainer, port trainer) over the same quantized tiny base, with
    nonzero lora_b so every adapter gets a gradient."""
    jtr = jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32), _jargs(fmt))
    jtr.init(seed=seed)
    rng = np.random.default_rng(lora_b_seed)
    lora = {k: (rng.normal(size=v.shape) * 0.05).astype(np.float32)
            if k.endswith("lora_b") else np.asarray(v)
            for k, v in jtrainer.extract_lora(jtr.params).items()}
    jtr.params = jtrainer.merge_lora(jtr.params, {k: jnp.asarray(v) for k, v in lora.items()})
    ttr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32),
                              _targs(fmt), device="cpu")
    ttr.init(seed=seed)
    _load_reference_base(ttr, jtr.params)
    return jtr, ttr


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, VOCAB, size=shape).astype(np.int32)
    return xs, ((xs + 1) % VOCAB).astype(np.int32)


def _close(got, want, rtol=0.0, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fmt", FORMATS)
def test_init_quantizes_the_base_and_keeps_adapters_trainable(fmt):
    ttr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32),
                              _targs(fmt), device="cpu")
    ttr.init(seed=0)
    qs = _quantized(ttr.model)
    # q/k/v/o and gate/up/down of both layers, and the LM head
    assert len(qs) == 2 * 7 + 1
    kind = tq.QuantizedTensor if fmt == "int8" else tq.QuantizedTensor4
    assert all(isinstance(q, kind) for q in qs)
    if fmt == "int8":
        assert {q.mode for q in qs} == {"dequant"}
    else:
        assert {q.fmt for q in qs} == {fmt} and {q.block for q in qs} == {64}
    names = {n for n, _ in ttr.model.named_parameters()}
    assert not any(n.endswith(("kernel", "lm_head")) for n in names)
    assert set(ttr._trainable) == {k for k in ttr._trainable if "lora" in k}
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in ttr._trainable.values())
    assert set(ttr.opt_state.mu) == set(ttr._trainable)


@pytest.mark.parametrize("fmt", FORMATS)
def test_one_step_loss_and_every_lora_gradient_match_jax(fmt):
    jtr, ttr = _qpair(fmt)
    x, y = _batch((BATCH, SEQ))
    m = np.ones((BATCH,), np.float32)
    params = jtr.params
    wrt = jtrainer.extract_trainable(params)

    def loss_of(t):
        return jtr._loss_fn(jtrainer.merge_trainable(params, t), jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(m))

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(wrt)
    trainable = ttrainer.extract_trainable(ttr.model)
    loss, _ = ttr._loss_fn(ttr.model, torch.from_numpy(x).long(), torch.from_numpy(y).long(),
                           torch.from_numpy(m))
    t_grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
    assert set(t_grads) == set(j_grads) and len(t_grads) == 16
    _close(float(loss.detach()), float(j_loss))
    for k in j_grads:
        assert float(np.abs(np.asarray(j_grads[k])).max()) > 0, k
        _close(t_grads[k].numpy(), j_grads[k])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("rounds", [1, 3])
def test_federated_round_matches_jax_and_keeps_the_base_frozen(fmt, rounds):
    """The fused round over a quantized base, against the reference's
    (2e-4 / 2e-5, as the bf16-free round test), with the packed base
    bit-frozen through it (the twin of the reference's
    ``test_qlora_4bit_base_trains_and_fused_round_runs``)."""
    n_clients, steps = 2, 2
    jtr, ttr = _qpair(fmt)
    w = np.asarray([1.0, 3.0], np.float32)
    j_fed = jtr.compile_federated_round(n_clients, steps)
    t_fed = ttr.compile_federated_round(n_clients, steps)
    p, o = jax.tree.map(jnp.copy, jtr.params), jax.tree.map(jnp.copy, jtr.opt_state)
    base0 = [(q.data.clone(), q.scale.clone()) for q in _quantized(ttr.model)]
    g_t = to_exchange(ttr.model)
    g_first = {k: v.clone() for k, v in g_t.items()}
    for r in range(rounds):
        xs, ys = _batch((n_clients, steps, BATCH, SEQ), seed=20 + r)
        ms = np.ones((n_clients, steps, BATCH), np.float32)
        g_j = {k: jnp.asarray(v) for k, v in exchange_to_numpy(g_t).items()}
        p, o, j_global, j_loss = j_fed(p, o, g_j, xs, ys, ms, w)
        params, state, g_t, t_loss = t_fed(ttr.params, ttr.opt_state, g_t, xs, ys, ms, w)
        assert params is ttr.model and state is ttr.opt_state
        _close(float(t_loss), float(j_loss), rtol=2e-4, atol=2e-5)
        assert set(g_t) == set(j_global)
        for k in j_global:
            _close(g_t[k].numpy(), j_global[k], rtol=2e-4, atol=2e-5)
    base1 = _quantized(ttr.model)
    assert len(base1) == len(base0) == 15
    for (d0, s0), q in zip(base0, base1):
        assert torch.equal(q.data, d0) and torch.equal(q.scale, s0)
    assert any(not torch.equal(g_t[k], g_first[k]) for k in g_t)


def test_base_quantize_validation_matches_reference():
    cfg = LlamaConfig.tiny(lora_rank=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="must be one of"):
        ttrainer.LLMTrainer(cfg, _targs("int3"), device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=4), _jargs("int3"))
    no_lora = LlamaConfig.tiny(lora_rank=0, dtype=torch.float32)
    for fmt in FORMATS:
        with pytest.raises(ValueError, match="lora_rank"):
            ttrainer.LLMTrainer(no_lora, _targs(fmt), device="cpu")
    with pytest.raises(ValueError, match="lora_rank"):
        jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=0), _jargs("nf4"))
    # the format is case-insensitive, as in the reference
    assert ttrainer.LLMTrainer(cfg, _targs("NF4"), device="cpu").base_quantize == "nf4"


def _kernel_numels(model):
    return {q.data.numel() if isinstance(q, tq.QuantizedTensor) else q.size
            for q in _quantized(model)}


@pytest.mark.parametrize("fmt", FORMATS)
def test_no_dequantized_base_weight_is_saved_for_backward(fmt):
    """In a QLoRA forward, no saved floating tensor has the element count
    of a quantized kernel; the same model with its dequantized kernels as
    frozen plain weights saves them (the check has teeth). The batch is
    [1, 12] tokens, so no activation has a kernel's element count."""
    ttr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32),
                              _targs(fmt), device="cpu")
    ttr.init(seed=0)
    sizes = _kernel_numels(ttr.model)
    assert sizes == {64 * 64, 64 * 32, 64 * 128, 64 * 256}
    x, y = (torch.from_numpy(a).long() for a in _batch((1, 12), seed=4))
    m = torch.ones(1)

    def saved_during_forward(model):
        saved = []

        def pack(t):
            saved.append((t.numel(), t.is_floating_point()))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = ttr._loss_fn(model, x, y, m)
        return saved, loss

    saved, loss = saved_during_forward(ttr.model)
    assert saved
    assert not [n for n, fl in saved if fl and n in sizes]
    grads = torch.autograd.grad(loss, list(ttr._trainable.values()))
    assert all(torch.isfinite(g).all() for g in grads)

    plain = copy.deepcopy(ttr.model)
    for mod in plain.modules():
        for k, v in list(vars(mod).items()):
            if isinstance(v, (tq.QuantizedTensor, tq.QuantizedTensor4)):
                delattr(mod, k)
                mod.register_parameter(k, torch.nn.Parameter(v.dequantize(),
                                                             requires_grad=False))
    saved_plain, _ = saved_during_forward(plain)
    assert [n for n, fl in saved_plain if fl and n in sizes]


def test_fedllm_api_passes_base_quantize_through_and_matches_jax():
    """``FedLLMAPI`` reads the three ``base_quantize*`` args from the flat
    args bag, as the reference's does: two nf4 rounds (block 32) against
    the reference's loop, losses within 1e-4, the packed base frozen."""
    import fedml_tpu
    from fedml_tpu.arguments import load_arguments_from_dict
    from fedml_tpu.data import load_federated
    from fedml_tpu.train.llm.run_fedllm import FedLLMAPI as JaxFedLLMAPI
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.configurations import from_args
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    args = fedml_tpu.init(load_arguments_from_dict({
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "synthetic_lm", "max_seq_length": SEQ,
                      "vocab_size": 32, "train_size": 64, "test_size": 16},
        "model_args": {"model": "llama", "model_size": "tiny", "lora_rank": 4,
                       "base_quantize": "nf4", "base_quantize_min_size": 1024,
                       "base_quantize_block": 32},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                       "client_num_per_round": 2, "comm_round": 2, "epochs": 1,
                       "batch_size": BATCH, "per_device_batch_size": BATCH,
                       "learning_rate": 5e-3, "mesh_dp": 1, "mesh_fsdp": 4,
                       "mesh_tp": 2, "mesh_sp": 1, "frequency_of_the_test": 1,
                       "on_device_round": True},
    }))
    j_api = JaxFedLLMAPI(args, None, load_federated(args),
                         cfg=JaxLlamaConfig.tiny(lora_rank=4, vocab_size=32,
                                                 dtype=jnp.float32))
    targs = copy.copy(args)
    targs.mesh_dp = targs.mesh_fsdp = targs.mesh_tp = targs.mesh_sp = 1
    model_args = from_args(targs)[0]
    assert (model_args.base_quantize, model_args.base_quantize_min_size,
            model_args.base_quantize_block) == ("nf4", 1024, 32)
    t_api = FedLLMAPI(targs, "cpu", load_synthetic_lm(targs),
                      cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))
    engine = t_api.client.engine
    qs = _quantized(engine.model)
    assert qs and {(q.fmt, q.block) for q in qs} == {("nf4", 32)}
    _load_reference_base(engine, j_api.client.engine.params)
    t_api.global_exchange = to_exchange(engine.model)
    base0 = [q.data.clone() for q in _quantized(engine.model)]
    for r in range(2):
        j_rep, t_rep = j_api.train_one_round(r), t_api.train_one_round(r)
        _close(t_rep["train_loss"], j_rep["train_loss"])
        _close(t_rep["test_loss"], j_rep["test_loss"])
    for d0, q in zip(base0, _quantized(engine.model)):
        assert torch.equal(q.data, d0)


def test_jax_int8_base_loads_into_an_int8_trainer_in_its_mode():
    """A JAX int8 QLoRA base carried into a port trainer with
    ``base_quantize: int8`` keeps the trainer's ``dequant`` mode (no hand
    patch after ``load_weights``) and trains: the loss and every LoRA
    gradient against the JAX trainer's at 1e-4."""
    jtr, ttr = _qpair("int8")
    qs = _quantized(ttr.model)
    assert len(qs) == 15 and {q.mode for q in qs} == {"dequant"}
    x, y = _batch((BATCH, SEQ), seed=3)
    m = np.ones((BATCH,), np.float32)
    params = jtr.params
    wrt = jtrainer.extract_trainable(params)

    def loss_of(t):
        return jtr._loss_fn(jtrainer.merge_trainable(params, t), jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(m))

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(wrt)
    trainable = ttrainer.extract_trainable(ttr.model)
    loss, _ = ttr._loss_fn(ttr.model, torch.from_numpy(x).long(),
                           torch.from_numpy(y).long(), torch.from_numpy(m))
    t_grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
    _close(float(loss.detach()), float(j_loss))
    assert set(t_grads) == set(j_grads)
    for k in j_grads:
        _close(t_grads[k].numpy(), j_grads[k])


@pytest.mark.parametrize("quantize,mode", [("int8_dequant", "dequant"), ("w8a8", "w8a8")])
def test_load_weights_keeps_each_engine_mode(quantize, mode):
    """``load_weights`` of a JAX int8 tree into an ``int8_dequant`` and a
    ``w8a8`` engine: every quantized weight stays in its engine's mode, and
    the ``w8a8`` codes are column-major, as the constructor makes them."""
    from fedml_tpu_torch.models.llm.llama import LlamaForCausalLM
    from fedml_tpu_torch.serving import ContinuousBatchingEngine

    jtr = jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32),
                              _jargs("int8"))
    jtr.init(seed=1)
    weights = from_jax_params(_quant_leaves_to_numpy(jtr.params))
    model = LlamaForCausalLM(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32),
                             device="cpu")
    eng = ContinuousBatchingEngine(model, batch_slots=2, max_len=32, quantize=quantize,
                                   quantize_min_size=1024, device="cpu")
    load_weights(eng.params, weights)
    qs = _quantized(eng.params)
    assert len(qs) == 15 and {q.mode for q in qs} == {mode}
    for name, q in tq.named_quantized_weights(eng.params):
        assert torch.equal(q.data, weights[name].data)
        assert torch.equal(q.scale, weights[name].scale)
        if mode == "w8a8":
            assert q.data.stride() == (1, q.data.shape[0])
        else:
            assert q.data.is_contiguous()
