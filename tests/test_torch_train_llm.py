"""The port's federated LoRA training (``fedml_tpu_torch/train/llm``)
against the reference's JAX trainer and FedLLM loop, on the CPU, in fp32,
with the reference's weights carried across by ``from_jax_params``."""
import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from fedml_tpu.train.llm import trainer as jtrainer
from fedml_tpu_torch.models.llm.convert import (
    exchange_to_numpy,
    from_exchange,
    from_jax_params,
    load_weights,
    to_exchange,
)
from fedml_tpu_torch.models.llm.llama import LlamaConfig
from fedml_tpu_torch.train.llm import trainer as ttrainer

SEQ, BATCH, VOCAB = 16, 4, 256


class _JArgs:
    """The JAX trainer's args, as ``tests/test_fed_round_on_device.py``."""
    max_seq_length = SEQ
    per_device_batch_size = BATCH
    gradient_accumulation_steps = 1
    learning_rate = 1e-2
    mesh_dp, mesh_fsdp, mesh_tp, mesh_sp = 1, 4, 2, 1
    random_seed = 0


class _TArgs(_JArgs):
    mesh_dp, mesh_fsdp, mesh_tp, mesh_sp = 1, 1, 1, 1


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _pair(jargs=_JArgs, targs=_TArgs, seed=0, lora_b_seed=7, **cfg_kw):
    """(JAX trainer, port trainer) on the same tiny fp32 weights, with
    nonzero lora_b so every adapter gets a gradient."""
    jtr = jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32), jargs())
    jtr.init(seed=seed)
    rng = np.random.default_rng(lora_b_seed)
    lora = {k: (rng.normal(size=v.shape) * 0.05).astype(np.float32)
            if k.endswith("lora_b") else np.asarray(v)
            for k, v in jtrainer.extract_lora(jtr.params).items()}
    jtr.params = jtrainer.merge_lora(jtr.params, {k: jnp.asarray(v) for k, v in lora.items()})
    ttr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32, **cfg_kw),
                              targs(), device="cpu")
    ttr.init(seed=seed)
    load_weights(ttr.model, from_jax_params(_np_tree(jtr.params)))
    return jtr, ttr


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, VOCAB, size=shape).astype(np.int32)
    return xs, ((xs + 1) % VOCAB).astype(np.int32)


def _close(got, want, rtol=0.0, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _jax_loss_and_grads(jtr, x, y, m):
    params = jtr.params
    wrt = jtrainer.extract_trainable(params)

    def loss_of(t):
        return jtr._loss_fn(jtrainer.merge_trainable(params, t), x, y, m)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(wrt)
    return float(loss), grads


def _port_loss_and_grads(ttr, x, y, m):
    trainable = ttrainer.extract_trainable(ttr.model)
    loss, _ = ttr._loss_fn(ttr.model, torch.from_numpy(x).long(),
                           torch.from_numpy(y).long(), torch.from_numpy(m))
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return float(loss.detach()), dict(zip(trainable, grads))


def test_one_step_loss_and_every_lora_gradient_match_jax():
    jtr, ttr = _pair()
    x, y = _batch((BATCH, SEQ))
    m = np.ones((BATCH,), np.float32)
    j_loss, j_grads = _jax_loss_and_grads(jtr, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(m))
    t_loss, t_grads = _port_loss_and_grads(ttr, x, y, m)
    assert set(t_grads) == set(j_grads) and len(t_grads) == 16
    _close(t_loss, j_loss)
    for k in j_grads:
        assert float(np.abs(np.asarray(j_grads[k])).max()) > 0, k
        _close(t_grads[k].numpy(), j_grads[k])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(policy):
    _, plain = _pair(remat=False)
    _, remat = _pair(remat=True, remat_policy=policy)
    x, y = _batch((BATCH, SEQ), seed=1)
    m = np.ones((BATCH,), np.float32)
    la, ga = _port_loss_and_grads(plain, x, y, m)
    lb, gb = _port_loss_and_grads(remat, x, y, m)
    assert la == pytest.approx(lb, abs=1e-6)
    for k in ga:
        _close(gb[k].numpy(), ga[k].numpy(), atol=1e-6)


def test_optimizer_chain_matches_optax():
    """clip_by_global_norm → adamw(warmup_cosine_decay) with weight decay,
    5 updates, clipping firing: the hand-written chain against optax."""
    rng = np.random.default_rng(3)
    params = {f"p{i}": rng.normal(size=s).astype(np.float32)
              for i, s in enumerate([(8, 4), (4, 16), (3,)])}
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.05, 2, 6)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(sched, weight_decay=0.1))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    ours = ttrainer.OptaxAdamW(ttrainer.warmup_cosine_decay(0.05, 2, 6), 0.5, 0.1)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = ours.init(t_params)
    for step in range(5):
        grads = {k: (rng.normal(size=v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        assert np.sqrt(sum((g ** 2).sum() for g in grads.values())) > 0.5  # clips
        upd, j_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        ours.update_(t_params, {k: torch.from_numpy(g) for k, g in grads.items()}, t_state)
        for k in params:
            _close(t_params[k].numpy(), j_params[k], rtol=1e-6, atol=1e-7)
        for k in params:
            _close(t_state.mu[k].numpy(), j_state[1][0].mu[k], rtol=1e-6, atol=1e-8)
            _close(t_state.nu[k].numpy(), j_state[1][0].nu[k], rtol=1e-6, atol=1e-9)
    assert t_state.count == int(j_state[1][0].count) == 5
    assert [ours.schedule(c) for c in range(3)] == pytest.approx(
        [float(sched(c)) for c in range(3)], abs=1e-9)
    assert ours.schedule(0) == 0.0


def test_trainer_steps_match_jax_with_warmup_and_clipping():
    class JArgs(_JArgs):
        warmup_steps, max_steps, max_grad_norm, weight_decay = 2, 10, 0.05, 0.01
        gradient_accumulation_steps = 2

    class TArgs(JArgs):
        mesh_dp, mesh_fsdp, mesh_tp, mesh_sp = 1, 1, 1, 1

    jtr, ttr = _pair(JArgs, TArgs)
    for s in range(5):
        xs, ys = _batch((2, BATCH, SEQ), seed=10 + s)
        m = np.ones((2, BATCH), np.float32)
        _close(ttr.step(xs, ys, m), jtr.step(xs, ys, m))
        j_lora = jtrainer.extract_lora(jtr.params)
        for k, v in to_exchange(ttr.model).items():
            _close(v.numpy(), j_lora[k], atol=2e-5)
    j_eval = jtr.evaluate(*_batch((BATCH, SEQ), seed=99))
    t_eval = ttr.evaluate(*_batch((BATCH, SEQ), seed=99))
    _close(t_eval["eval_loss"], j_eval["eval_loss"])
    assert t_eval["eval_acc"] == pytest.approx(j_eval["eval_acc"])


def _copy(t):
    return jax.tree.map(jnp.copy, t)


def test_attention_fn_replaces_the_attention_op():
    from fedml_tpu_torch.ops.flash_attention import reference_attention

    _, ttr = _pair()
    x = torch.from_numpy(_batch((2, SEQ))[0]).long()
    calls = []

    def attention_fn(q, k, v):
        calls.append(q.shape)
        return reference_attention(q, k, v, causal=True)

    with torch.no_grad():
        got = ttr.model(x, attention_fn=attention_fn)
        want = ttr.model(x)  # use_flash: the flash op's plain version on the CPU
    assert len(calls) == ttr.cfg.num_hidden_layers
    _close(got.numpy(), want.numpy(), atol=1e-5)


def test_client_trainer_local_training_matches_jax():
    """``LLMClientTrainer.train``: shuffled local epochs with the reference's
    seed, the trailing partial batch padded and masked."""
    from fedml_tpu.train.llm.federated import LLMClientTrainer as JaxClient
    from fedml_tpu_torch.train.llm.federated import LLMClientTrainer

    class JArgs(_JArgs):
        epochs = 2
        learning_rate = 1e-3

    class TArgs(JArgs):
        mesh_dp, mesh_fsdp, mesh_tp, mesh_sp = 1, 1, 1, 1

    cfg_j = JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32)
    j_client = JaxClient(cfg_j, JArgs())
    t_client = LLMClientTrainer(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32), TArgs(),
                                device="cpu")
    load_weights(t_client.engine.model, from_jax_params(_np_tree(j_client.engine.params)))
    for c in (j_client, t_client):
        c.set_id(2)
        c.set_round(1)
    data = _batch((10, SEQ), seed=5)  # 10 rows, batch 4: a padded last batch
    g = exchange_to_numpy(t_client.get_exchange_params())
    j_new, j_metrics = j_client.train({k: jnp.asarray(v) for k, v in g.items()}, data,
                                      None, JArgs())
    t_new, t_metrics = t_client.train(g, data, None, TArgs())
    _close(t_metrics["train_loss"], j_metrics["train_loss"])
    assert t_metrics["train_samples"] == j_metrics["train_samples"] == 10
    for k, v in t_new.items():
        _close(v.numpy(), j_new[k], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("rounds", [1, 3])
def test_federated_round_matches_jax_fused_round(rounds):
    n_clients, steps = 3, 2
    jtr, ttr = _pair()
    w = np.asarray([1.0, 2.0, 3.0], np.float32)
    j_fed = jtr.compile_federated_round(n_clients, steps)
    t_fed = ttr.compile_federated_round(n_clients, steps)
    p, o = _copy(jtr.params), _copy(jtr.opt_state)
    g_t = to_exchange(ttr.model)
    for r in range(rounds):
        xs, ys = _batch((n_clients, steps, BATCH, SEQ), seed=20 + r)
        ms = np.ones((n_clients, steps, BATCH), np.float32)
        # the JAX round takes the port's global adapters as numpy: the two
        # stay fed the same state round after round
        g_j = {k: jnp.asarray(v) for k, v in exchange_to_numpy(g_t).items()}
        p, o, j_global, j_loss = j_fed(p, o, g_j, xs, ys, ms, w)
        params, state, g_t, t_loss = t_fed(ttr.params, ttr.opt_state, g_t, xs, ys, ms, w)
        assert params is ttr.model and state is ttr.opt_state
        _close(float(t_loss), float(j_loss), rtol=2e-4, atol=2e-5)
        assert set(g_t) == set(j_global)
        for k in j_global:
            assert g_t[k].dtype == torch.float32
            _close(g_t[k].numpy(), j_global[k], rtol=2e-4, atol=2e-5)
        live = jtrainer.extract_lora(p)  # the LAST client's adapters
        for k, v in ttrainer.extract_lora(ttr.model).items():
            _close(v.detach().numpy(), live[k], rtol=2e-4, atol=2e-5)
    assert ttr.opt_state.count == rounds * n_clients * steps  # carried across clients


def test_federated_round_guards():
    _, ttr = _pair()
    fed = ttr.compile_federated_round(2, 1)
    xs, ys = _batch((2, 1, BATCH, SEQ))
    ms = np.ones((2, 1, BATCH), np.float32)
    with pytest.raises(ValueError, match="in place"):
        fed(copy.deepcopy(ttr.model), ttr.opt_state, to_exchange(ttr.model), xs, ys, ms,
            np.ones(2, np.float32))
    with pytest.raises(ValueError, match="built for"):
        fed(ttr.params, ttr.opt_state, to_exchange(ttr.model), xs[:1], ys[:1], ms[:1],
            np.ones(1, np.float32))
    with pytest.raises(NotImplementedError, match="LoRA adapters only"):
        ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=0, dtype=torch.float32), _TArgs(),
                            device="cpu")


def test_exchange_round_trips_and_numpy_direction():
    _, ttr = _pair()
    ex = to_exchange(ttr.model)
    assert all(k.startswith("params/layer_") and "lora" in k for k in ex)
    arrays = exchange_to_numpy(ex)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in arrays.values())
    zeroed = {k: np.zeros_like(a) for k, a in arrays.items()}
    from_exchange(ttr.model, zeroed)
    assert all(float(v.abs().max()) == 0 for v in to_exchange(ttr.model).values())
    ttr.load_exchange_state(arrays)
    for k, v in ttr.exchange_state().items():
        assert torch.equal(v, ex[k])
    with pytest.raises(ValueError, match="shape"):
        from_exchange(ttr.model, {next(iter(ex)): np.zeros((1, 1), np.float32)})


def _data_args(**kw):
    base = dict(max_seq_length=12, vocab_size=40, train_size=50, test_size=9,
                random_seed=3, client_num_in_total=4)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [{}, dict(random_seed=11, client_num_in_total=7)])
def test_synthetic_lm_and_client_sampling_equal_the_reference(kw):
    from fedml_tpu.data.data_loader import load_synthetic_lm as j_load
    from fedml_tpu.simulation.sampling import sample_clients as j_sample
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm as t_load
    from fedml_tpu_torch.simulation.sampling import sample_clients as t_sample

    jd, td = j_load(_data_args(**kw)), t_load(_data_args(**kw))
    for a, b in zip(jd.as_tuple(), td.as_tuple()):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(a[key], tuple):
                    for x, y in zip(a[key], b[key]):
                        np.testing.assert_array_equal(x, y)
                else:
                    assert a[key] == b[key]
        else:
            assert a == b
    args = types.SimpleNamespace(client_num_in_total=kw.get("client_num_in_total", 8),
                                 client_num_per_round=3, random_seed=kw.get("random_seed", 0))
    for r in range(6):
        assert t_sample(args, r) == j_sample(args, r)


def _fedllm_args():
    import fedml_tpu
    from fedml_tpu.arguments import load_arguments_from_dict

    return fedml_tpu.init(load_arguments_from_dict({
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "synthetic_lm", "max_seq_length": SEQ,
                      "vocab_size": 32, "train_size": 64, "test_size": 16},
        "model_args": {"model": "llama", "model_size": "tiny", "lora_rank": 4},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                       "client_num_per_round": 2, "comm_round": 2, "epochs": 1,
                       "batch_size": BATCH, "per_device_batch_size": BATCH,
                       "learning_rate": 5e-3, "mesh_dp": 1, "mesh_fsdp": 4,
                       "mesh_tp": 2, "mesh_sp": 1, "frequency_of_the_test": 1,
                       "on_device_round": True},
    }))


def _port_args(args, **kw):
    targs = copy.copy(args)
    targs.mesh_dp = targs.mesh_fsdp = targs.mesh_tp = targs.mesh_sp = 1
    for k, v in kw.items():
        setattr(targs, k, v)
    return targs


def test_fedllm_api_on_device_matches_jax():
    from fedml_tpu.data import load_federated
    from fedml_tpu.train.llm.run_fedllm import FedLLMAPI as JaxFedLLMAPI
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    args = _fedllm_args()
    j_api = JaxFedLLMAPI(args, None, load_federated(args),
                         cfg=JaxLlamaConfig.tiny(lora_rank=4, vocab_size=32,
                                                 dtype=jnp.float32))
    targs = _port_args(args)
    t_api = FedLLMAPI(targs, "cpu", load_synthetic_lm(targs),
                      cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))
    engine = t_api.client.engine
    load_weights(engine.model, from_jax_params(_np_tree(j_api.client.engine.params)))
    t_api.global_exchange = to_exchange(engine.model)
    for r in range(2):
        j_rep, t_rep = j_api.train_one_round(r), t_api.train_one_round(r)
        _close(t_rep["train_loss"], j_rep["train_loss"])
        _close(t_rep["test_loss"], j_rep["test_loss"])
        assert t_rep["test_acc"] == pytest.approx(j_rep["test_acc"], abs=1e-6)
    # FedLLMAPI.train() summarises the last test report
    t_api.args.comm_round = 1
    out = t_api.train()
    assert out["rounds"] == 1 and np.isfinite(out["test_loss"])


def test_entry_points_default_to_cuda_and_deferred_paths_raise(monkeypatch, tmp_path):
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(lora_rank=4, vocab_size=40, dtype=torch.float32)
    args = _data_args(per_device_batch_size=2, client_num_per_round=2, comm_round=1,
                      on_device_round=True, local_steps_per_round=1)
    ds = load_synthetic_lm(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.LLMTrainer(cfg, args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FedLLMAPI(args, None, ds, cfg=cfg)
    api = FedLLMAPI(args, "cpu", ds, cfg=cfg)
    assert api.client.engine.device.type == "cpu"
    assert np.isfinite(api.train()["test_loss"])

    # the host-loop round (no longer deferred) runs on the CPU when asked
    host = FedLLMAPI(_data_args(per_device_batch_size=2, client_num_per_round=2,
                                comm_round=1, on_device_round=False), "cpu", ds, cfg=cfg)
    assert not host.on_device and np.isfinite(host.train()["test_loss"])
    with pytest.raises(ValueError, match="base_quantize"):
        ttrainer.LLMTrainer(cfg, _data_args(base_quantize="int3"), device="cpu")
    assert ttrainer.LLMTrainer(cfg, _data_args(base_quantize="int8"),
                               device="cpu").base_quantize == "int8"
    with pytest.raises(NotImplementedError, match="A11"):
        ttrainer.LLMTrainer(cfg, _data_args(mesh_fsdp=4), device="cpu")
    # round checkpoints (no longer deferred) write the reference's format
    path = api.client.engine.save_checkpoint(str(tmp_path), 0)
    assert sorted(os.listdir(path)) == ["manifest.json", "state.pt"]


# -- the host-loop round, checkpoints and serve --checkpoint -----------------
@pytest.fixture
def trust_reset():
    from fedml_tpu.core.security.defender import FedMLDefender as JDefender
    from fedml_tpu_torch.core.security.defender import FedMLDefender as TDefender

    yield
    JDefender.reset()
    TDefender.reset()


def _host_loop_pair(**train):
    """(JAX FedLLMAPI, port FedLLMAPI) with the host-loop round on the same
    tiny fp32 weights and data; ``train`` switches trust-stack hooks on in
    both packages' singletons."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import load_federated
    from fedml_tpu.train.llm.run_fedllm import FedLLMAPI as JaxFedLLMAPI
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    args = _fedllm_args()
    args.on_device_round = False
    for k, v in train.items():
        setattr(args, k, v)
    fedml_tpu.init(args)
    j_api = JaxFedLLMAPI(args, None, load_federated(args),
                         cfg=JaxLlamaConfig.tiny(lora_rank=4, vocab_size=32,
                                                 dtype=jnp.float32))
    targs = fedml_tpu_torch.init(_port_args(args))
    t_api = FedLLMAPI(targs, "cpu", load_synthetic_lm(targs),
                      cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))
    engine = t_api.client.engine
    load_weights(engine.model, from_jax_params(_np_tree(j_api.client.engine.params)))
    t_api.global_exchange = to_exchange(engine.model)
    return j_api, t_api


@pytest.mark.parametrize("train", [
    {}, {"enable_defense": True, "defense_type": "norm_diff_clipping", "norm_bound": 2.0}],
    ids=["plain", "norm_diff_clipping"])
def test_fedllm_api_host_loop_matches_jax(train, trust_reset):
    """Two host-loop rounds (the hook chain around every client's payload)
    beside the JAX package's: each round's test loss within 1e-4 and
    accuracy within 1e-6, the global adapters within 1e-4."""
    j_api, t_api = _host_loop_pair(**train)
    assert not t_api.on_device
    for r in range(2):
        j_rep, t_rep = j_api.train_one_round(r), t_api.train_one_round(r)
        _close(t_rep["test_loss"], j_rep["test_loss"])
        assert t_rep["test_acc"] == pytest.approx(j_rep["test_acc"], abs=1e-6)
        for k, v in exchange_to_numpy(t_api.global_exchange).items():
            _close(v, np.asarray(j_api.global_exchange[k]))
    if train:  # the clip ran: every client payload's norm was bounded
        norm = np.sqrt(sum(float((v.double() ** 2).sum())
                           for v in t_api.global_exchange.values()))
        assert norm <= 2.0 + 1e-4


def test_on_device_round_refuses_live_hooks(trust_reset):
    import fedml_tpu_torch
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    targs = fedml_tpu_torch.init(_port_args(
        _fedllm_args(), enable_defense=True, defense_type="norm_diff_clipping"))
    with pytest.raises(ValueError, match="defense"):
        FedLLMAPI(targs, "cpu", load_synthetic_lm(targs),
                  cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="A13"):
        FedLLMAPI(_port_args(_fedllm_args(), enable_fhe=True), "cpu",
                  load_synthetic_lm(targs),
                  cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))


def test_host_loop_checkpoints_the_tested_global_and_loads_back(tmp_path, trust_reset):
    """With ``save_every_rounds: 1`` and a test every round, each round's
    checkpoint holds the global adapters (the reference saves the engine's
    live adapters, which the test has just loaded); a fresh engine restored
    from it gives the round's test loss bit for bit; the JAX package's
    orbax checkpoint of the same round holds the same keys, values within
    1e-4."""
    from fedml_tpu_torch.core.checkpoint import read_round_dir
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    j_api, t_api = _host_loop_pair(checkpoint_dir=str(tmp_path / "port"),
                                   save_every_rounds=1)
    j_api.args.checkpoint_dir = str(tmp_path / "jax")
    reps, globals_ = [], []
    for r in range(2):
        reps.append(t_api.train_one_round(r))
        globals_.append({k: v.clone() for k, v in t_api.global_exchange.items()})
        j_api.train_one_round(r)
    for r, (rep, glob) in enumerate(zip(reps, globals_)):
        assert rep["checkpoint"] == str(tmp_path / "port" / f"round_{r}")
        assert rep["checkpoint_bytes"] > 0
        saved = read_round_dir(rep["checkpoint"])
        assert set(saved) == set(glob)
        assert all(torch.equal(saved[k], glob[k]) for k in saved)  # every tested round
    want = jtrainer.restore_checkpoint_into(
        j_api.client.engine.params, str(tmp_path / "jax" / "round_1"), lora_only=True)
    for k, v in jtrainer.extract_lora(want).items():
        _close(saved[k].numpy(), np.asarray(v))

    fresh = FedLLMAPI(t_api.args, "cpu", load_synthetic_lm(t_api.args),
                      cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))
    load_weights(fresh.client.engine.model,
                 from_jax_params(_np_tree(j_api.client.engine.params)))
    fresh.client.engine.load_checkpoint(reps[1]["checkpoint"])
    x, y = fresh.dataset.test_data_global
    n = min(len(x), fresh.client.engine.batch_size * 8)
    again = fresh.client.engine.evaluate(np.asarray(x[:n]), np.asarray(y[:n]))
    assert again["eval_loss"] == reps[1]["test_loss"]


def test_checkpoint_round_trip_lora_merges_full_replaces(tmp_path):
    """A LoRA payload merges into the given base (the base untouched); a
    full payload replaces every parameter; a payload that does not fit the
    model raises."""
    tr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, vocab_size=40,
                                              dtype=torch.float32), _TArgs(), device="cpu")
    tr.init(seed=0)
    rng = np.random.default_rng(3)
    lora = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
            for k, v in to_exchange(tr.model).items()}
    from_exchange(tr.model, lora)
    path = tr.save_checkpoint(str(tmp_path), 7)
    assert path == str(tmp_path / "round_7")
    other = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, vocab_size=40,
                                                 dtype=torch.float32), _TArgs(), device="cpu")
    other.init(seed=1)
    base = {n: p.detach().clone() for n, p in other.model.named_parameters()
            if "lora" not in n}
    other.load_checkpoint(path)
    assert all(torch.equal(p, lora[k]) for k, p in to_exchange(other.model).items())
    assert all(torch.equal(p, base[n]) for n, p in other.model.named_parameters()
               if "lora" not in n)
    full = {ttrainer.ref_path(n): p.detach().clone() for n, p in tr.model.named_parameters()}
    from fedml_tpu_torch.core.checkpoint import write_round_dir

    write_round_dir(str(tmp_path / "full"), full, 0)
    ttrainer.restore_checkpoint_into(other.model, str(tmp_path / "full"), lora_only=False)
    assert all(torch.equal(p, full[ttrainer.ref_path(n)])
               for n, p in other.model.named_parameters())
    with pytest.raises(KeyError, match="do not match"):
        ttrainer.restore_checkpoint_into(other.model, str(tmp_path / "full"), lora_only=True)


def test_serve_checkpoint_through_build_endpoint(tmp_path, monkeypatch):
    """``serve --checkpoint DIR --lora-rank r``: build_endpoint restores the
    adapters before quantization, keeps them f32 beside the int8 base, and
    the endpoint's logits move with them (the unquantized model with the
    same adapters agrees within the int8 error). The tiny model's kernels
    sit below the quantizer's size floor, so the test lowers it to 1."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.models.llm.llama import LlamaForCausalLM
    from fedml_tpu_torch.ops.quant import QuantizedTensor
    from fedml_tpu_torch.serving import llm_engine

    quantize = llm_engine.quantize_params_int8
    monkeypatch.setattr(llm_engine, "quantize_params_int8",
                        lambda m, **kw: quantize(m, **{**kw, "min_size": 1}))

    def parse(*extra):
        return build_parser().parse_args(
            ["serve", "--model", "tiny", "--quantize", "int8_dequant", "--device", "cpu",
             "--port", "0", "--lora-rank", "4", *extra])

    a = parse()
    cfg_model = LlamaForCausalLM(
        LlamaConfig.from_args(types.SimpleNamespace(model_size="tiny", lora_rank=4,
                                                    base_params_bf16=True)),
        device="cpu", seed=0)
    rng = np.random.default_rng(5)
    lora = {k: torch.from_numpy((rng.normal(size=tuple(v.shape)) * 0.2).astype(np.float32))
            for k, v in to_exchange(cfg_model).items()}
    from fedml_tpu_torch.core.checkpoint import write_round_dir

    write_round_dir(str(tmp_path / "round_0"), lora, 0)
    tokens = torch.tensor([[1, 5, 9, 2, 7]])
    outs = {}
    for name, extra in (("ckpt", ("--checkpoint", str(tmp_path / "round_0"))), ("base", ())):
        engine, runner = build_endpoint(parse(*extra))
        try:
            model = engine.params
            assert all(torch.equal(p, lora[k]) for k, p in to_exchange(model).items()) == (
                name == "ckpt")
            assert all(p.dtype == torch.float32 for p in to_exchange(model).values())
            assert any(isinstance(v, QuantizedTensor) for m in model.modules()
                       for v in vars(m).values())
            with torch.inference_mode():
                outs[name] = model(tokens)[0].float()
        finally:
            runner.stop()
            engine.stop()
    assert torch.isfinite(outs["ckpt"]).all()
    assert (outs["ckpt"] - outs["base"]).abs().max() > 1e-3
    # the same restore on a bf16 model, unquantized: within the int8 error
    plain = LlamaForCausalLM(cfg_model.cfg, device="cpu", seed=0)
    ttrainer.restore_checkpoint_into(plain, str(tmp_path / "round_0"), lora_only=True)
    with torch.inference_mode():
        want = plain(tokens)[0].float()
    rel = (torch.linalg.vector_norm(outs["ckpt"] - want) / torch.linalg.vector_norm(want))
    assert float(rel) < 5e-2


def test_untested_round_checkpoints_the_last_clients_adapters(tmp_path, trust_reset):
    """The reference's behaviour, copied (ROADMAP §C): a round without a
    test checkpoints the engine's live adapters, which are the last
    client's, not the global ones; the JAX package's checkpoint of the same
    round holds the same adapters (1e-4)."""
    from fedml_tpu_torch.core.checkpoint import read_round_dir

    j_api, t_api = _host_loop_pair(checkpoint_dir=str(tmp_path / "port"),
                                   save_every_rounds=1, frequency_of_the_test=2,
                                   comm_round=3)
    j_api.args.checkpoint_dir = str(tmp_path / "jax")
    t_rep = [t_api.train_one_round(r) for r in range(2)][1]
    for r in range(2):
        j_api.train_one_round(r)
    assert "test_loss" not in t_rep  # round 1 of 3 is not a test round
    saved = read_round_dir(t_rep["checkpoint"])
    live = {k: v.detach() for k, v in
            ttrainer.extract_lora(t_api.client.engine.model).items()}
    assert all(torch.equal(saved[k], live[k]) for k in saved)
    assert not all(torch.equal(saved[k], t_api.global_exchange[k]) for k in saved)
    want = jtrainer.extract_lora(jtrainer.restore_checkpoint_into(
        j_api.client.engine.params, str(tmp_path / "jax" / "round_1"), lora_only=True))
    for k, v in want.items():
        _close(saved[k].numpy(), np.asarray(v))
