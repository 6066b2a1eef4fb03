"""Full-parameter training in the port (``lora_rank <= 0``) against the
reference's JAX trainer and FedLLM loop, on the CPU, with the reference's
weights carried across by ``from_jax_params``; the optimizer's grouped
update and the leaf-at-a-time aggregation against the whole-dict forms
they replace, bit for bit."""
import copy
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
    from_jax_params,
    load_weights,
    ref_path,
    to_exchange,
)
from fedml_tpu_torch.models.llm.llama import LlamaConfig
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


def _jax_flat(tree):
    return {jtrainer._path_str(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(model):
    return {ref_path(n): p.detach().float().numpy().copy() for n, p in model.named_parameters()}


def _pair(jargs=_JArgs, targs=_TArgs, dtype="f32", **cfg_kw):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jkw = dict(cfg_kw)
    tkw = dict(cfg_kw)
    if jkw.pop("param_bf16", False):
        tkw.pop("param_bf16")
        jkw["param_dtype"], tkw["param_dtype"] = jnp.bfloat16, torch.bfloat16
    jtr = jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=0, dtype=jd, **jkw), jargs())
    jtr.init(seed=0)
    ttr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=0, dtype=td, **tkw), targs(),
                              device="cpu")
    ttr.init(seed=0)
    load_weights(ttr.model, from_jax_params(jax.tree.map(np.asarray, jtr.params)))
    return jtr, ttr


def _repeated_batch(shape, seed=0, vocab=12):
    """Tokens from a 12-word vocabulary: every batch repeats tokens."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, vocab, size=shape).astype(np.int32)
    return xs, ((xs * 7 + 3) % VOCAB).astype(np.int32)


def test_full_ft_steps_match_jax_with_warmup_clipping_and_repeated_tokens():
    """Three full-parameter steps (warmup 2, clipping firing, weight decay,
    two micro-batches of repeated tokens): every parameter, the norm scales,
    the embedding and the LM head included, moves, and stays within 3e-5 of
    the reference's; the losses within 1e-4; the trained set and the
    exchange payload are the reference's full tree, key for key."""
    class JArgs(_JArgs):
        warmup_steps, max_steps, max_grad_norm, weight_decay = 2, 10, 0.05, 0.01
        gradient_accumulation_steps = 2

    class TArgs(JArgs):
        mesh_dp, mesh_fsdp, mesh_tp, mesh_sp = 1, 1, 1, 1

    jtr, ttr = _pair(JArgs, TArgs)
    assert not ttr.lora_only
    before = _port_flat(ttr.model)
    assert set(ttrainer.extract_trainable(ttr.model)) == set()  # no adapter, no router
    assert set(ttr._trainable) == set(_jax_flat(jtr.params)) == set(to_exchange(ttr.model))
    assert all(p.requires_grad for p in ttr.model.parameters())
    for s in range(3):
        xs, ys = _repeated_batch((2, BATCH, SEQ), seed=10 + s)
        m = np.ones((2, BATCH), np.float32)
        np.testing.assert_allclose(ttr.step(xs, ys, m), jtr.step(xs, ys, m),
                                   rtol=0, atol=1e-4)
    want, got = _jax_flat(jtr.params), _port_flat(ttr.model)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=3e-5, err_msg=k)
        assert not np.array_equal(got[k], before[k]), k
    j_mu = _jax_flat(jtr.opt_state[1][0].mu)
    for k, v in ttr.opt_state.mu.items():
        np.testing.assert_allclose(v.numpy(), j_mu[k], rtol=0, atol=1e-6, err_msg=k)
    assert ttr.opt_state.count == 3
    j_eval = jtr.evaluate(*_repeated_batch((BATCH, SEQ), seed=99))
    t_eval = ttr.evaluate(*_repeated_batch((BATCH, SEQ), seed=99))
    assert t_eval["eval_loss"] == pytest.approx(j_eval["eval_loss"], abs=1e-4)


def test_embedding_gradient_takes_the_references_bf16_order():
    """With bf16 compute the reference casts the table, then gathers, so
    repeated tokens add their gradients in bf16. The port's embedding
    gradient, for the upstream gradient its own model sends into the
    embedding, equals the reference's cast-then-gather gradient of that
    upstream exactly, and differs from the gather-then-cast order's."""
    _, ttr = _pair(dtype="bf16")
    model = ttr.model
    upstream = []

    def grab(_mod, inputs):
        inputs[0].register_hook(lambda g: upstream.append(g.detach().clone()))

    handle = model.layer_0.register_forward_pre_hook(grab)
    xs, ys = _repeated_batch((BATCH, SEQ), seed=3, vocab=5)
    loss, _ = ttr._loss_fn(model, torch.from_numpy(xs).long(), torch.from_numpy(ys).long(),
                           torch.ones(BATCH))
    got = torch.autograd.grad(loss, [model.embed_tokens])[0]
    handle.remove()
    assert got.dtype == torch.float32 and len(upstream) == 1
    dx = upstream[0]
    assert dx.dtype == torch.bfloat16
    table = model.embed_tokens.detach().numpy()
    dxj = jnp.asarray(dx.float().numpy(), jnp.bfloat16)

    def ref(t):
        x = t.astype(jnp.bfloat16)[jnp.asarray(xs)]
        return jnp.sum((x * dxj).astype(jnp.float32))

    want = np.asarray(jax.grad(ref)(jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy(), want)
    rows = torch.zeros_like(model.embed_tokens)
    rows.index_add_(0, torch.from_numpy(xs).long().reshape(-1),
                    dx.float().reshape(-1, dx.shape[-1]))  # f32 sums (the other order)
    assert not np.array_equal(rows.numpy(), want)


def test_bf16_params_keep_a_bf16_state_like_optax():
    """``base_params_bf16`` without LoRA: μ and ν are bf16, as optax keeps
    them for bf16 parameters. The hand-written chain on bf16 parameters and
    bf16 gradients against optax over 4 updates (clipping firing, weight
    decay): parameters, μ and ν within 4 bf16 ulps at each tensor's largest
    magnitude (2^-6 of it): the clip scale and each op round in bf16 in a
    different order in the two libraries."""
    rng = np.random.default_rng(5)
    shapes = [(16, 8), (8, 32), (7,)]
    params = {f"p{i}": rng.normal(size=s).astype(np.float32) for i, s in enumerate(shapes)}
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(0.02, weight_decay=0.1))
    j_params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    j_state = tx.init(j_params)
    ours = ttrainer.OptaxAdamW(lambda c: 0.02, 0.5, 0.1)
    t_params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    t_state = ours.init(t_params)
    assert all(v.dtype == torch.bfloat16 for v in t_state.mu.values())
    assert all(v.dtype == jnp.bfloat16 for v in jax.tree.leaves(j_state[1][0].mu))

    def close(a, b, what):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 2 ** -6 * max(np.abs(b).max(), 1e-30), what

    for step in range(4):
        grads = {k: (rng.normal(size=v.shape) * 2).astype(np.float32) for k, v in params.items()}
        upd, j_state = tx.update({k: jnp.asarray(g, jnp.bfloat16) for k, g in grads.items()},
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        ours.update_(t_params, {k: torch.from_numpy(g).to(torch.bfloat16)
                                for k, g in grads.items()}, t_state)
        for k in params:
            close(t_params[k].float().numpy(), j_params[k], f"params {k} step {step}")
            close(t_state.mu[k].float().numpy(), j_state[1][0].mu[k], f"mu {k}")
            close(t_state.nu[k].float().numpy(), j_state[1][0].nu[k], f"nu {k}")
    # the trainer builds that state for a bf16 full model, and a step runs
    _, ttr = _pair(dtype="bf16", param_bf16=True)
    assert all(p.dtype == torch.bfloat16 for p in ttr.model.parameters()
               if p.ndim == 2)
    assert all(v.dtype == ttr._trainable[k].dtype for k, v in ttr.opt_state.mu.items())
    before = ttr.model.embed_tokens.detach().clone()
    loss = ttr.step(*_repeated_batch((BATCH, SEQ)), np.ones(BATCH, np.float32))
    assert np.isfinite(loss) and not torch.equal(before, ttr.model.embed_tokens)


def test_full_ft_bf16_step_matches_jax():
    """One full-parameter step at bf16 compute over f32 parameters, repeated
    tokens: the loss within 2e-3 and every parameter within 2e-3 of the
    reference's (bf16 products differ by rounding between the two
    libraries; Adam's first step moves each element by about the learning
    rate, 1e-2)."""
    jtr, ttr = _pair(dtype="bf16")
    xs, ys = _repeated_batch((BATCH, SEQ), seed=4)
    m = np.ones((BATCH,), np.float32)
    np.testing.assert_allclose(ttr.step(xs, ys, m), jtr.step(xs, ys, m), rtol=0, atol=2e-3)
    want, got = _jax_flat(jtr.params), _port_flat(ttr.model)
    frac = np.mean([np.mean(np.abs(got[k] - want[k]) <= 2e-3) for k in want])
    assert frac >= 0.99, frac


def test_optimizer_groups_give_the_bits_of_one_pass():
    """The grouped update against the one-pass update it replaced, on a
    LoRA trainer's adapters (f32, clipping, weight decay, warmup) and with
    groups smaller than one tensor: parameters and state bit for bit."""
    def old_update_(opt, params, grads, state):
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k].to(torch.float32) for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        clip = torch.where(norm < opt.max_grad_norm, torch.ones_like(norm),
                           opt.max_grad_norm / norm)
        g = torch._foreach_mul(g, clip)
        torch._foreach_mul_(mu, opt.B1)
        torch._foreach_add_(mu, g, alpha=1.0 - opt.B1)
        torch._foreach_mul_(nu, opt.B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - opt.B2)
        lr = opt.schedule(state.count)
        state.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(opt.B1) ** f32(state.count))
        bc2 = float(f32(1) - f32(opt.B2) ** f32(state.count))
        mu_hat = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, opt.EPS)
        upd = torch._foreach_div(mu_hat, denom)
        if opt.weight_decay:
            torch._foreach_add_(upd, p, alpha=opt.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)

    tr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=4, dtype=torch.float32),
                             types.SimpleNamespace(**{**vars(_TArgs), "warmup_steps": 2,
                                                      "max_steps": 8, "max_grad_norm": 0.1,
                                                      "weight_decay": 0.05}), device="cpu")
    tr.init(seed=0)
    base = {k: p.detach().clone() for k, p in tr._trainable.items()}
    rng = np.random.default_rng(0)
    grads = [{k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
              for k, p in base.items()} for _ in range(4)]
    runs = {}
    for name, group in (("old", None), ("one", 1 << 26), ("split", 100)):
        params = {k: v.clone() for k, v in base.items()}
        opt = copy.copy(tr.tx)
        state = opt.init(params)
        for g in grads:
            if group is None:
                old_update_(opt, params, g, state)
            else:
                opt.GROUP_ELEMS = group
                opt.update_(params, g, state)
        runs[name] = (params, state)
    assert len(tr.tx._groups(list(base), {k: v.numel() for k, v in base.items()})) == 1
    for name in ("one", "split"):
        params, state = runs[name]
        for k in base:
            assert torch.equal(params[k], runs["old"][0][k]), (name, k)
            assert torch.equal(state.mu[k], runs["old"][1].mu[k]), (name, k)
            assert torch.equal(state.nu[k], runs["old"][1].nu[k]), (name, k)


def test_leaf_at_a_time_aggregation_gives_the_stacked_bits():
    """``weighted_sum_of_trees`` against ``weighted_tree_sum(tree_stack())``
    bit for bit, f32 and bf16 leaves, through both of FedMLAggOperator's
    entry points."""
    from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
    from fedml_tpu_torch.utils.tree import (
        tree_stack,
        weighted_sum_of_trees,
        weighted_tree_sum,
    )

    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        trees = [{f"params/l{i}/kernel": torch.from_numpy(
            rng.normal(size=(13, 7 + i)).astype(np.float32)).to(dtype) for i in range(3)}
            for _ in range(5)]
        w = torch.from_numpy(rng.random(5).astype(np.float32))
        w = w / w.sum()
        want = weighted_tree_sum(tree_stack(trees), w)
        got = weighted_sum_of_trees(trees, w)
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        counts = [3, 1, 4, 1, 5]
        args = types.SimpleNamespace(federated_optimizer="FedAvg")
        agg = FedMLAggOperator.agg(args, list(zip(counts, trees)))
        cw = torch.tensor(counts, dtype=torch.float32)
        assert all(torch.equal(agg[k], v) for k, v in
                   weighted_tree_sum(tree_stack(trees), cw / cw.sum()).items())
        aw = FedMLAggOperator.agg_with_weights(trees, counts)
        assert all(torch.equal(aw[k], agg[k]) for k in agg)


def test_init_zeros_and_the_fused_round_refusal():
    """``init(zeros=True)`` makes every parameter zero (the reference's
    dry-run path); a full model's ``compile_federated_round`` raises the
    reference's ValueError."""
    jtr = jtrainer.LLMTrainer(JaxLlamaConfig.tiny(lora_rank=0, dtype=jnp.float32), _JArgs())
    jtr.init(seed=0, zeros=True)
    ttr = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=0, dtype=torch.float32), _TArgs(),
                              device="cpu")
    ttr.init(seed=0, zeros=True)
    assert all(float(p.abs().max()) == 0 for p in ttr.model.parameters())
    assert set(_port_flat(ttr.model)) == set(_jax_flat(jtr.params))
    assert all(float(np.abs(v).max()) == 0 for v in _jax_flat(jtr.params).values())
    for tr in (jtr, ttr):
        with pytest.raises(ValueError, match="requires a LoRA model"):
            tr.compile_federated_round(2, 1)


def _fedllm_pair(**train):
    """(JAX FedLLMAPI, port FedLLMAPI), full-parameter, on the same tiny fp32
    weights and data."""
    import fedml_tpu
    import fedml_tpu_torch
    from fedml_tpu.arguments import load_arguments_from_dict
    from fedml_tpu.data import load_federated
    from fedml_tpu.train.llm.run_fedllm import FedLLMAPI as JaxFedLLMAPI
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI

    args = fedml_tpu.init(load_arguments_from_dict({
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "synthetic_lm", "max_seq_length": SEQ,
                      "vocab_size": 32, "train_size": 64, "test_size": 16},
        "model_args": {"model": "llama", "model_size": "tiny", "lora_rank": 0},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                       "client_num_per_round": 2, "comm_round": 2, "epochs": 1,
                       "batch_size": BATCH, "per_device_batch_size": BATCH,
                       "learning_rate": 2e-3, "mesh_dp": 1, "mesh_fsdp": 4,
                       "mesh_tp": 2, "mesh_sp": 1, "frequency_of_the_test": 1,
                       **train},
    }))
    j_api = JaxFedLLMAPI(args, None, load_federated(args),
                         cfg=JaxLlamaConfig.tiny(lora_rank=0, vocab_size=32,
                                                 dtype=jnp.float32))
    targs = copy.copy(args)
    targs.mesh_dp = targs.mesh_fsdp = targs.mesh_tp = targs.mesh_sp = 1
    targs = fedml_tpu_torch.init(targs)
    t_api = FedLLMAPI(targs, "cpu", load_synthetic_lm(targs),
                      cfg=LlamaConfig.tiny(lora_rank=0, vocab_size=32, dtype=torch.float32))
    engine = t_api.client.engine
    load_weights(engine.model, from_jax_params(jax.tree.map(np.asarray,
                                                            j_api.client.engine.params)))
    t_api.global_exchange = to_exchange(engine.model)
    return j_api, t_api


def test_fedllm_host_loop_federates_the_full_tree_like_jax():
    """Two host-loop rounds of 2 clients exchanging every parameter: the
    global state is the reference's full tree key for key, within 1e-4;
    each round's test loss within 1e-4."""
    j_api, t_api = _fedllm_pair(on_device_round=False)
    assert not t_api.on_device
    for r in range(2):
        j_rep, t_rep = j_api.train_one_round(r), t_api.train_one_round(r)
        assert t_rep["test_loss"] == pytest.approx(j_rep["test_loss"], abs=1e-4)
        want = _jax_flat(j_api.global_exchange)
        got = exchange_to_numpy(t_api.global_exchange)
        assert set(got) == set(want)
        assert "params/embed_tokens" in got and "params/final_norm/scale" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


def test_on_device_round_with_a_full_model_raises_like_jax():
    """``on_device_round: true`` without LoRA raises the reference's
    ValueError at the first round, in both packages."""
    j_api, t_api = _fedllm_pair(on_device_round=True)
    for api in (j_api, t_api):
        with pytest.raises(ValueError, match="requires a LoRA model"):
            api.train_one_round(0)


def test_full_checkpoint_round_trip_and_serve_with_lora_rank_0(tmp_path):
    """A full model's round checkpoint holds every parameter; a fresh
    trainer restores it bit for bit and evaluates the same loss; ``serve
    --model tiny --lora-rank 0 --checkpoint DIR`` loads it into the served
    bf16 model (each weight the checkpoint's, rounded to bf16)."""
    from fedml_tpu_torch.cli import build_endpoint, build_parser
    from fedml_tpu_torch.core.checkpoint import read_round_dir

    _, ttr = _pair()
    ttr.step(*_repeated_batch((BATCH, SEQ)), np.ones(BATCH, np.float32))
    path = ttr.save_checkpoint(str(tmp_path), 3)
    saved = read_round_dir(path)
    assert set(saved) == set(_port_flat(ttr.model))
    assert ttr.last_save_bytes >= sum(p.numel() * 4 for p in ttr.model.parameters())
    fresh = ttrainer.LLMTrainer(LlamaConfig.tiny(lora_rank=0, dtype=torch.float32), _TArgs(),
                                device="cpu")
    fresh.init(seed=1)
    fresh.load_checkpoint(path)
    assert all(torch.equal(p, saved[ref_path(n)]) for n, p in fresh.model.named_parameters())
    batch = _repeated_batch((BATCH, SEQ), seed=8)
    assert fresh.evaluate(*batch) == ttr.evaluate(*batch)
    args = build_parser().parse_args(["serve", "--model", "tiny", "--lora-rank", "0",
                                      "--device", "cpu", "--port", "0",
                                      "--checkpoint", path])
    engine, runner = build_endpoint(args)
    try:
        served = dict(engine.params.named_parameters())
        assert set(map(ref_path, served)) == set(saved)
        assert all(torch.equal(p, saved[ref_path(n)].to(p.dtype)) for n, p in served.items())
        assert served["embed_tokens"].dtype == torch.bfloat16
    finally:
        runner.stop()
        engine.stop()
