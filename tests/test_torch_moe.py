"""The port's mixture-of-experts Llama (``LlamaMoE`` in
``fedml_tpu_torch/models/llm/llama.py``) and its training against the
reference's flax model and JAX trainer, on the CPU, with the reference's
weights carried across by ``from_jax_params``.

Routing indices are compared exactly (the reference's are recorded from
``jax.lax.top_k``, the port's from ``LlamaMoE.route``); outputs within the
tolerance each test states."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from fedml_tpu.models.llm import llama as jl
from fedml_tpu.train.llm import trainer as jtrainer
from fedml_tpu_torch.models.llm import llama as tl
from fedml_tpu_torch.models.llm.convert import (
    exchange_to_numpy,
    from_jax_params,
    load_weights,
    ref_path,
    to_exchange,
)
from fedml_tpu_torch.train.llm import trainer as ttrainer

SEQ, BATCH, VOCAB = 16, 4, 256


class _JArgs:
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


def _jax_flat(tree):
    return {jtrainer._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs(dtype="f32", **kw):
    kw.setdefault("num_experts", 4)
    kw.setdefault("num_experts_per_tok", 2)
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jl.LlamaConfig.tiny(use_flash=False, dtype=jd, **kw),
            tl.LlamaConfig.tiny(use_flash=False, dtype=td, **kw))


class _JaxRoutes:
    """Records the reference's ``jax.lax.top_k`` indices (the model is
    applied eagerly, so they are concrete)."""

    def __init__(self, monkeypatch):
        self.idx = []
        orig = jax.lax.top_k

        def top_k(x, k):
            out = orig(x, k)
            self.idx.append(np.asarray(out[1]))
            return out

        monkeypatch.setattr(jax.lax, "top_k", top_k)


class _PortRoutes:
    def __init__(self, monkeypatch):
        self.idx = []
        orig = tl.LlamaMoE.route

        def route(mod, xg):
            out = orig(mod, xg)
            self.idx.append(out[2].cpu().numpy())
            return out

        monkeypatch.setattr(tl.LlamaMoE, "route", route)


def _moe_layer_pair(dtype="f32", seed=0, **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    x = np.random.default_rng(seed).normal(size=(2, 16, jcfg.hidden_size)).astype(np.float32)
    jm = jl.LlamaMoE(jcfg)
    params = meta.unbox(jm.init(jax.random.key(seed), jnp.asarray(x, jcfg.dtype)))
    tm = tl.LlamaMoE(tcfg, "cpu", torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name in ("router", "gate_proj", "up_proj", "down_proj"):
            getattr(tm, name).copy_(torch.from_numpy(np.array(params["params"][name],
                                                              np.float32)))
    return jm, params, tm, x


# group 24 pads S = 32 tokens to 48 (16 zero rows in the tail group, whose
# uniform probabilities tie); 32 and 1024 do not pad; 0.05 drops most tokens
MOE_CASES = {
    "pad_k2": dict(moe_group_size=24),
    "nopad_k2": dict(moe_group_size=32),
    "one_group": dict(moe_group_size=1024),
    "pad_k1": dict(moe_group_size=24, num_experts_per_tok=1),
    "capacity_drop": dict(moe_group_size=24, moe_capacity_factor=0.05),
    "pad_ties_take_capacity": dict(moe_group_size=24, moe_capacity_factor=0.5),
    "two_experts": dict(moe_group_size=8, num_experts=2),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_routing_and_aux_match_jax(case, monkeypatch):
    """Routing indices equal exactly; the FFN output within 1e-5 (f32); the
    aux term within 1e-6."""
    jm, params, tm, x = _moe_layer_pair(**MOE_CASES[case])
    jr, tr = _JaxRoutes(monkeypatch), _PortRoutes(monkeypatch)
    want, state = jm.apply(params, jnp.asarray(x), mutable=["intermediates"])
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    assert len(jr.idx) == len(tr.idx) == 1
    np.testing.assert_array_equal(tr.idx[0], jr.idx[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float(aux) == pytest.approx(
        float(state["intermediates"]["moe_aux_loss"][0]), abs=1e-6)
    if case == "capacity_drop":  # dropped tokens give zero rows
        assert int((got.abs().sum(-1) == 0).sum()) > 0
    if case.startswith("pad"):  # a padded row's uniform probabilities: expert 0 first
        assert (tr.idx[0][-1, -16:, 0] == 0).all()


def test_moe_forward_bf16_matches_jax(monkeypatch):
    """bf16 compute: routing (f32 router) equal exactly, outputs within 2^-7
    of the output's largest magnitude."""
    jm, params, tm, x = _moe_layer_pair("bf16", moe_group_size=24)
    jr, tr = _JaxRoutes(monkeypatch), _PortRoutes(monkeypatch)
    want = np.asarray(jm.apply(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tr.idx[0], jr.idx[0])
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("group", [1024, 8])
def test_identical_experts_equal_the_dense_mlp(group):
    """Every expert holding the same weights and ample capacity: the top-k
    combine (weights summing to 1) gives the dense MLP's output, the port's
    ``LlamaMLP`` on those weights, within 1e-5; the reference's MoE agrees."""
    jm, params, tm, x = _moe_layer_pair(num_experts=2, moe_capacity_factor=4.0,
                                        moe_group_size=group)
    with torch.no_grad():
        for name in ("gate_proj", "up_proj", "down_proj"):
            w = getattr(tm, name)
            w[1] = w[0]
    _, tcfg = _cfgs(num_experts=2)
    mlp = tl.LlamaMLP(tcfg, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name in ("gate_proj", "up_proj", "down_proj"):
            getattr(mlp, name).kernel.copy_(getattr(tm, name)[0])
        got, _ = tm(torch.from_numpy(x))
        dense = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    inner = {k: np.array(v) for k, v in params["params"].items()}
    for name in ("gate_proj", "up_proj", "down_proj"):
        inner[name][1] = inner[name][0]
    want = np.asarray(jm.apply({"params": {k: jnp.asarray(v) for k, v in inner.items()}},
                               jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_aux_counts_real_tokens_only():
    """A group size that pads reports the same load-balance term as one that
    does not (1e-6), and each equals the reference's."""
    auxes = {}
    for group in (32, 24):
        jm, params, tm, x = _moe_layer_pair(moe_group_size=group, moe_capacity_factor=8.0,
                                            seed=3)
        _, state = jm.apply(params, jnp.asarray(x), mutable=["intermediates"])
        with torch.no_grad():
            _, aux = tm(torch.from_numpy(x))
        assert float(aux) == pytest.approx(
            float(state["intermediates"]["moe_aux_loss"][0]), abs=1e-6)
        auxes[group] = float(aux)
    assert auxes[32] == pytest.approx(auxes[24], abs=1e-6)


def test_expert_initializer_follows_flax_fan_in():
    """flax's lecun_normal on a stacked ``[E, in, out]`` kernel takes fan-in
    ``E * in``: the drawn std is within 3% of sqrt(1 / (E * in)), not of
    sqrt(1 / in); the router is normal(0.02) in f32."""
    _, tcfg = _cfgs(num_experts=8, hidden_size=128, intermediate_size=256)
    moe = tl.LlamaMoE(tcfg, "cpu", torch.Generator().manual_seed(0))
    for name, fan_in in (("gate_proj", 8 * 128), ("down_proj", 8 * 256)):
        std = float(getattr(moe, name).std())
        assert std == pytest.approx(fan_in ** -0.5, rel=0.03), name
    assert moe.router.dtype == torch.float32
    assert float(moe.router.std()) == pytest.approx(0.02, rel=0.05)


def _model_pair(lora_rank=0, dtype="f32", seed=0, **kw):
    kw.setdefault("moe_group_size", 24)
    jcfg, tcfg = _cfgs(dtype, lora_rank=lora_rank, **kw)
    jm = jl.LlamaForCausalLM(jcfg)
    params = meta.unbox(jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32)))
    tm = tl.LlamaForCausalLM(tcfg, device="cpu")
    load_weights(tm, from_jax_params(_np_tree(params)))
    return jm, params, tm


def test_moe_model_logits_and_leaves_match_jax():
    """A 2-layer MoE Llama: every reference leaf (flattened with its
    ``_path_str``) is a port parameter of the same shape, key for key, and
    the logits agree within 1e-4 (f32)."""
    jm, params, tm = _model_pair()
    flat = _jax_flat(params)
    port = {ref_path(n): p for n, p in tm.named_parameters()}
    assert set(port) == set(flat)
    for k, v in flat.items():
        assert tuple(port[k].shape) == v.shape, k
        np.testing.assert_array_equal(port[k].detach().numpy(), v)
    assert flat["params/layer_1/moe/gate_proj"].shape == (4, 64, 128)
    toks = np.random.default_rng(0).integers(0, VOCAB, size=(2, 12)).astype(np.int32)
    want = np.asarray(jm.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_moe_kv_cache_decode_matches_jax_greedy_tokens():
    """A tiny MoE model served by the port's continuous-batching engine
    (KV-cache prefill and decode, two slots) gives the reference engine's
    greedy tokens."""
    from fedml_tpu.serving.llm_engine import ContinuousBatchingEngine as JaxEngine
    from fedml_tpu_torch.serving import ContinuousBatchingEngine
    from test_torch_serving import _drive

    jm, params, tm = _model_pair(moe_group_size=1024)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (5, 11, 19)]
    want, want_ops = _drive(JaxEngine(jm, params, batch_slots=2, max_len=64), prompts, 7)
    got, got_ops = _drive(ContinuousBatchingEngine(tm, batch_slots=2, max_len=64,
                                                   device="cpu"), prompts, 7)
    assert got == want and got_ops == want_ops
    assert all(len(s) == 7 for s in got)


# -- through the trainer ------------------------------------------------------

def _trainer_pair(lora_rank=4, jargs=_JArgs, targs=_TArgs, lora_b_seed=7, **kw):
    """(JAX trainer, port trainer) on the same tiny fp32 MoE weights, nonzero
    ``lora_b`` so every adapter gets a gradient."""
    kw.setdefault("moe_group_size", 24)
    jcfg, tcfg = _cfgs(lora_rank=lora_rank, **kw)
    jtr = jtrainer.LLMTrainer(jcfg, jargs())
    jtr.init(seed=0)
    if lora_rank:
        rng = np.random.default_rng(lora_b_seed)
        lora = {k: jnp.asarray((rng.normal(size=v.shape) * 0.05).astype(np.float32))
                for k, v in jtrainer.extract_lora(jtr.params).items() if k.endswith("lora_b")}
        jtr.params = jtrainer.merge_lora(jtr.params, lora)
    ttr = ttrainer.LLMTrainer(tcfg, targs(), device="cpu")
    ttr.init(seed=0)
    load_weights(ttr.model, from_jax_params(_np_tree(jtr.params)))
    return jtr, ttr


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, VOCAB, size=shape).astype(np.int32)
    return xs, ((xs + 1) % VOCAB).astype(np.int32)


def test_lora_mode_trains_the_router_and_freezes_the_experts():
    """Three LoRA steps beside the JAX trainer: the trained set is the
    adapters and the routers; losses within 1e-4, adapters and routers
    within 2e-5; the experts and every other base leaf bit-frozen."""
    jtr, ttr = _trainer_pair()
    trained = set(ttrainer.extract_trainable(ttr.model))
    assert trained == set(jtrainer.extract_trainable(jtr.params))
    assert {k for k in trained if "router" in k} == {
        "params/layer_0/moe/router", "params/layer_1/moe/router"}
    frozen0 = {n: p.detach().clone() for n, p in ttr.model.named_parameters()
               if ref_path(n) not in trained}
    router0 = ttr.model.layer_0.moe.router.detach().clone()
    for s in range(3):
        x, y = _batch((BATCH, SEQ), seed=30 + s)
        m = np.ones((BATCH,), np.float32)
        np.testing.assert_allclose(ttr.step(x, y, m), jtr.step(x, y, m), rtol=0, atol=1e-4)
    want = _jax_flat(jtr.params)
    for k, p in ttrainer.extract_trainable(ttr.model).items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=2e-5)
    assert all(torch.equal(p, frozen0[n]) for n, p in ttr.model.named_parameters()
               if n in frozen0)
    assert not torch.equal(ttr.model.layer_0.moe.router, router0)


def test_aux_weight_reaches_the_train_loss_not_the_eval_loss():
    """The train loss is CE + moe_aux_weight x the layers' mean aux (the
    reference's within 1e-5, and different from the aux-free objective);
    the eval loss is pure CE in both packages."""
    jtr, ttr = _trainer_pair(moe_aux_weight=0.5)
    _, ttr0 = _trainer_pair(moe_aux_weight=0.0)
    x, y = _batch((BATCH, SEQ), seed=5)
    m = np.ones((BATCH,), np.float32)
    tx, ty = (torch.from_numpy(a).long() for a in (x, y))
    tm_ = torch.from_numpy(m)
    with torch.no_grad():
        l_aux = float(ttr._loss_fn(ttr.model, tx, ty, tm_)[0])
        l_ce = float(ttr0._loss_fn(ttr0.model, tx, ty, tm_)[0])
        _, auxes = ttr.model(tx, return_aux=True)
    j_aux = float(jtr._loss_fn(jtr.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))[0])
    assert l_aux == pytest.approx(j_aux, abs=1e-5)
    assert len(auxes) == 2
    assert l_aux - l_ce == pytest.approx(0.5 * float(sum(auxes)) / 2, abs=1e-5)
    assert l_aux != l_ce
    t_eval, j_eval = ttr.evaluate(x, y), jtr.evaluate(x, y)
    assert t_eval["eval_loss"] == pytest.approx(j_eval["eval_loss"], abs=1e-4)
    assert t_eval["eval_loss"] == pytest.approx(l_ce, abs=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_counts_the_aux_once(policy):
    """Checkpointed blocks return their aux as an output: the loss and every
    trained gradient equal the un-checkpointed model's within 1e-6."""
    _, plain = _trainer_pair(remat=False, moe_aux_weight=0.5)
    _, remat = _trainer_pair(remat=True, remat_policy=policy, moe_aux_weight=0.5)
    x, y = _batch((BATCH, SEQ), seed=1)
    args = (torch.from_numpy(x).long(), torch.from_numpy(y).long(), torch.ones(BATCH))
    out = []
    for tr in (plain, remat):
        trainable = ttrainer.extract_trainable(tr.model)
        loss, _ = tr._loss_fn(tr.model, *args)
        out.append((float(loss.detach()), torch.autograd.grad(loss, list(trainable.values()))))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def test_moe_fused_round_matches_jax_fused_round():
    """Two fused LoRA rounds of 3 clients x 2 steps on the MoE model beside
    ``compile_federated_round``: losses and global adapters within 2e-4
    relative + 2e-5; the routers (trained, not exchanged) within 5e-5."""
    n_clients, steps = 3, 2
    jtr, ttr = _trainer_pair()
    w = np.asarray([1.0, 2.0, 3.0], np.float32)
    j_fed = jtr.compile_federated_round(n_clients, steps)
    t_fed = ttr.compile_federated_round(n_clients, steps)
    p, o = jax.tree.map(jnp.copy, jtr.params), jax.tree.map(jnp.copy, jtr.opt_state)
    g_t = to_exchange(ttr.model)
    for r in range(2):
        xs, ys = _batch((n_clients, steps, BATCH, SEQ), seed=40 + r)
        ms = np.ones((n_clients, steps, BATCH), np.float32)
        g_j = {k: jnp.asarray(v) for k, v in exchange_to_numpy(g_t).items()}
        p, o, j_global, j_loss = j_fed(p, o, g_j, xs, ys, ms, w)
        _, _, g_t, t_loss = t_fed(ttr.params, ttr.opt_state, g_t, xs, ys, ms, w)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=2e-4, atol=2e-5)
        assert set(g_t) == set(j_global)
        for k in j_global:
            np.testing.assert_allclose(g_t[k].numpy(), np.asarray(j_global[k]),
                                       rtol=2e-4, atol=2e-5)
    want = _jax_flat(p)
    for i in range(2):
        k = f"params/layer_{i}/moe/router"
        np.testing.assert_allclose(getattr(ttr.model, f"layer_{i}").moe.router.detach().numpy(),
                                   want[k], rtol=0, atol=5e-5)


def test_moe_host_loop_round_matches_jax():
    """Two host-loop FedLLMAPI rounds (the hook chain around each client's
    payload) on the MoE model in LoRA mode, beside the JAX package's: each
    round's test loss within 1e-4 and the global adapters within 1e-4."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.data import load_federated
    from fedml_tpu.train.llm.run_fedllm import FedLLMAPI as JaxFedLLMAPI
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    from test_torch_train_llm import _fedllm_args, _port_args

    args = _fedllm_args()
    args.on_device_round = False
    fedml_tpu.init(args)
    jcfg, tcfg = _cfgs(lora_rank=4, vocab_size=32, moe_group_size=24)
    j_api = JaxFedLLMAPI(args, None, load_federated(args), cfg=jcfg)
    targs = fedml_tpu_torch.init(_port_args(args))
    t_api = FedLLMAPI(targs, "cpu", load_synthetic_lm(targs), cfg=tcfg)
    engine = t_api.client.engine
    load_weights(engine.model, from_jax_params(_np_tree(j_api.client.engine.params)))
    t_api.global_exchange = to_exchange(engine.model)
    assert not t_api.on_device
    for r in range(2):
        j_rep, t_rep = j_api.train_one_round(r), t_api.train_one_round(r)
        assert t_rep["test_loss"] == pytest.approx(j_rep["test_loss"], abs=1e-4)
        for k, v in exchange_to_numpy(t_api.global_exchange).items():
            np.testing.assert_allclose(v, np.asarray(j_api.global_exchange[k]),
                                       rtol=0, atol=1e-4)
