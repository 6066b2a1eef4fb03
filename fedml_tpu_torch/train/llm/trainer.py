"""LLM trainer on one device — counterpart of ``fedml_tpu/train/llm/trainer.py``.

The reference compiles one sharded XLA step; the port runs the same step
eagerly on one card:

- LoRA fine-tuning differentiates ONLY the trainable tensors (the adapters
  and the MoE router): the frozen base has ``requires_grad=False`` and
  never gets a gradient; full-parameter training (``lora_rank <= 0``)
  differentiates every parameter and exchanges the whole flat dict;
- an MoE model's train loss adds ``moe_aux_weight`` times the mean of its
  layers' load-balance terms; the eval loss is pure cross-entropy;
- micro-batch gradients over ``[accum, B, T]`` are averaged, then one
  optimizer update: the reference's optax chain
  ``clip_by_global_norm(max_grad_norm)`` → ``adamw(schedule, wd)``, written
  out by hand (:class:`OptaxAdamW`) so that it matches optax step for step,
  with its state in the parameters' dtype as optax keeps it, and updated
  in bounded groups of elements so that a full model's update needs no
  second copy of the model;
- :meth:`LLMTrainer.compile_federated_round` runs a whole federated LoRA
  round (client-switch, local steps, weighted adapter FedAvg) with the
  semantics of the reference's fused round, and refuses a full model as
  the reference does;
- QLoRA: ``base_quantize`` (``int8``, ``int4`` or ``nf4``) stores the frozen
  base quantized (``ops/quant.py``); its products dequantize per call and
  save no dequantized weight for backward.

The exchange payload is the flat ``{reference path: tensor}`` dict of the
adapters (``params/layer_0/attn/q_proj/lora_a``), or of every parameter
without LoRA, the same keys the JAX trainer's paths flatten to, so
payloads cross between the two.

Round checkpoints (:meth:`LLMTrainer.save_checkpoint`,
:func:`restore_checkpoint_into`) are the port's format (``core/checkpoint``:
one ``torch.save`` of the flat payload keyed by the reference's paths,
with a manifest); the reference writes orbax, which the card's machine
does not have. Not ported yet: sharding over a mesh (ROADMAP A11; with it
the reference's sharding rebuild after quantizing the base).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.checkpoint import read_round_dir, write_round_dir
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.models.llm.convert import (  # noqa: F401 - extract_lora re-exported
    extract_lora,
    from_exchange,
    is_lora_path,
    ref_path,
    to_exchange,
)
from fedml_tpu_torch.models.llm.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    causal_lm_loss,
)
from fedml_tpu_torch.ops.quant import quantize_params_int4, quantize_params_int8
from fedml_tpu_torch.telemetry.profiling import repeated_cost, wrap_program

logger = logging.getLogger(__name__)

MESH_ARGS = ("mesh_dp", "mesh_fsdp", "mesh_tp", "mesh_sp")
BASE_FORMATS = ("int8", "int4", "nf4")


# -- trainable / exchange selection (keyed by the reference's path strings) --

def is_trainable_path(path: str) -> bool:
    """LoRA adapters + the MoE router (no LoRA twin; the load-balance loss
    must be able to act on it)."""
    return is_lora_path(path) or "router" in path.replace(".", "/").split("/")


def extract_trainable(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``{reference path: live parameter}`` of every trained tensor. The
    reference returns a new flat dict of arrays; the port returns the live
    parameters, which the optimizer updates in place."""
    return {ref_path(n): p for n, p in model.named_parameters()
            if is_trainable_path(ref_path(n))}


# The reference's merge_* return a new params tree; here they copy the dict
# into the live model in place (and return it).
merge_trainable = merge_lora = from_exchange


# -- the optimizer ----------------------------------------------------------

def warmup_cosine_decay(peak_value: float, warmup_steps: int,
                        decay_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` from 0 (end value 0,
    exponent 1), evaluated in f32 as optax does: linear from 0 to
    ``peak_value`` over ``warmup_steps``, then cosine decay to 0 over the
    remaining ``decay_steps - warmup_steps``."""
    f32 = np.float32
    cos_steps = decay_steps - warmup_steps
    if warmup_steps <= 0 or cos_steps <= 0:
        raise ValueError("warmup_cosine_decay needs 0 < warmup_steps < decay_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(-f32(peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        decayed = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return float(f32(peak_value) * decayed)

    return schedule


@dataclasses.dataclass
class AdamWState:
    """optax's ``(EmptyState, ScaleByAdamState(count, mu, nu), ...)`` for a
    flat dict of tensors; ``count`` counts the updates made."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class OptaxAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay))`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0), over a flat dict of tensors, updated in place with
    foreach kernels. Two points where a stock PyTorch optimizer differs:
    the learning rate is the schedule at the count *before* the update (the
    first warmup step has lr 0), and clipping scales by ``max_norm / norm``
    only when ``norm >= max_norm``, with no epsilon in the norm.

    μ and ν take each parameter's dtype, as optax's do (bf16 parameters
    keep a bf16 state). After the global norm, the update walks flat views
    of the tensors in groups of at most ``GROUP_ELEMS`` elements: each op is
    elementwise, so the bits are those of one pass over the whole dict,
    and the temporaries (the clipped gradient, μ̂, the denominator, the
    step) never exceed ``GROUP_ELEMS`` elements each (256 MB in f32).
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8
    GROUP_ELEMS = 1 << 26

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 weight_decay: float = 0.0):
        self.schedule = schedule
        self.max_grad_norm = float(max_grad_norm)
        self.weight_decay = float(weight_decay)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamWState(0, zeros, {k: torch.zeros_like(z) for k, z in zeros.items()})

    def _groups(self, keys, sizes):
        """``[[(key, start, stop), ...], ...]``: consecutive flat slices of the
        tensors, at most ``GROUP_ELEMS`` elements a group."""
        groups, cur, room = [], [], self.GROUP_ELEMS
        for k in keys:
            start, n = 0, sizes[k]
            while start < n:
                take = min(n - start, room)
                cur.append((k, start, start + take))
                start += take
                room -= take
                if room == 0:
                    groups.append(cur)
                    cur, room = [], self.GROUP_ELEMS
        if cur:
            groups.append(cur)
        return groups

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: AdamWState) -> None:
        """One update of ``params`` (in place) from ``grads``; advances
        ``state`` in place. Never synchronises with the device."""
        keys = list(params)
        g_full = {k: grads[k].to(state.mu[k].dtype) for k in keys}
        # clip_by_global_norm
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [g_full[k] for k in keys])))
        clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm)
        lr = self.schedule(state.count)
        state.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.B1) ** f32(state.count))
        bc2 = float(f32(1) - f32(self.B2) ** f32(state.count))
        for group in self._groups(keys, {k: params[k].numel() for k in keys}):
            def views(src, flat=lambda t: t.view(-1)):
                return [flat(src[k])[a:b] for k, a, b in group]

            p = views(params)
            mu, nu = views(state.mu), views(state.nu)
            g = torch._foreach_mul(views(g_full, lambda t: t.reshape(-1)), clip)
            # scale_by_adam
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.B2)
            del g
            mu_hat = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            upd = torch._foreach_div(mu_hat, denom)
            del mu_hat, denom
            # add_decayed_weights, then scale_by_learning_rate
            if self.weight_decay:
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)


def _check_single_device(args: Any) -> None:
    for name in MESH_ARGS:
        size = int(getattr(args, name, 1) or 1)
        if size not in (1, -1):
            raise NotImplementedError(
                f"{name}={size}: the port trains on one device; sharding over a "
                f"mesh is not ported yet (ROADMAP A11)")


class LLMTrainer:
    """Fine-tuning of a causal LM on one device (``device=``, default
    ``"cuda"``): LoRA adapters (and an MoE router) with ``lora_rank > 0``,
    every parameter otherwise."""

    def __init__(self, cfg: LlamaConfig, args: Any, device: DeviceLike = "cuda"):
        # QLoRA: the frozen base stored quantized, per-channel int8 or
        # blockwise 4-bit; it needs LoRA (only the adapters train)
        self.base_quantize = str(getattr(args, "base_quantize", "") or "").lower()
        if self.base_quantize and self.base_quantize not in BASE_FORMATS:
            raise ValueError(f"base_quantize={self.base_quantize!r}: must be one "
                             f"of 'int8', 'int4', 'nf4'")
        if self.base_quantize and cfg.lora_rank <= 0:
            raise ValueError("base_quantize requires lora_rank > 0 (QLoRA trains "
                             "adapters over a frozen quantized base)")
        _check_single_device(args)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.args = args
        self.seq_len = int(getattr(args, "max_seq_length", 512))
        self.batch_size = int(getattr(args, "per_device_batch_size",
                                      getattr(args, "batch_size", 8)))
        lr = float(getattr(args, "learning_rate", 1e-4))
        warmup = int(getattr(args, "warmup_steps", 0))
        max_steps = int(getattr(args, "max_steps", 1000))
        if warmup > 0:
            schedule = warmup_cosine_decay(lr, warmup, max(max_steps, warmup + 1))
        else:
            def schedule(count: int) -> float:
                return lr
        self.tx = OptaxAdamW(schedule, float(getattr(args, "max_grad_norm", 1.0)),
                             float(getattr(args, "weight_decay", 0.0)))

        is_moe = cfg.num_experts > 0
        moe_aux_w = float(getattr(cfg, "moe_aux_weight", 0.01))

        def apply_fn(model, x):
            if not is_moe:
                return model(x)
            # the layers' load-balance terms: without the aux pressure in the
            # objective the router collapses
            logits, auxes = model(x, return_aux=True)
            return logits, moe_aux_w * sum(auxes) / max(len(auxes), 1)

        def eval_apply_fn(model, x):
            # evaluation reports pure cross-entropy, no aux regularizer
            return model(x)

        self._loss_fn = causal_lm_loss(apply_fn)
        self._eval_loss_fn = causal_lm_loss(eval_apply_fn)
        # cataloged under the reference's names (telemetry.profiling); a
        # step inside the fused round counts for the round alone
        self._train_step = wrap_program("llm/train_step", self._train_step)
        self._eval_step = wrap_program("llm/eval_step", self._eval_loss_fn,
                                       multi_shape=True)
        self.model: Optional[LlamaForCausalLM] = None
        self.opt_state: Optional[AdamWState] = None
        self._trainable: Dict[str, torch.nn.Parameter] = {}
        self.last_save_bytes = 0

    @property
    def params(self) -> Optional[LlamaForCausalLM]:
        """The live model: the port's counterpart of the reference's params."""
        return self.model

    # -- init -------------------------------------------------------------
    def init(self, seed: int = 0, zeros: bool = False) -> LlamaForCausalLM:
        """Build the model on the trainer's device with weights drawn from
        ``seed``, or every parameter zero with ``zeros=True`` (the
        reference's dry-run fast path), the base quantized in place under
        ``base_quantize``; only the trainable tensors require grad (all of
        them without LoRA)."""
        self.model = LlamaForCausalLM(self.cfg, device=self.device, seed=seed)
        if zeros:
            with torch.no_grad():
                for p in self.model.parameters():
                    p.zero_()
        if self.base_quantize:
            self._quantize_base()
        self._trainable = (extract_trainable(self.model) if self.lora_only else
                           {ref_path(n): p for n, p in self.model.named_parameters()})
        for p in self.model.parameters():
            p.requires_grad_(False)
        for p in self._trainable.values():
            p.requires_grad_(True)
        self.opt_state = self.tx.init(self._trainable)
        return self.model

    def _quantize_base(self) -> None:
        """Quantize the base kernels in place, each full-precision kernel
        dropped as its twin lands: int8 in ``dequant`` mode, as the
        reference, or 4-bit."""
        min_size = int(getattr(self.args, "base_quantize_min_size", 65536))
        if self.base_quantize in ("int4", "nf4"):
            quantize_params_int4(
                self.model, fmt=self.base_quantize, donate=True, min_size=min_size,
                block=int(getattr(self.args, "base_quantize_block", 64)))
        else:
            quantize_params_int8(self.model, mode="dequant", donate=True,
                                 min_size=min_size)

    # -- stepping ---------------------------------------------------------
    def _tokens(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _train_step(self, xs: torch.Tensor, ys: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """One optimizer step over ``[n_micro, B, T]``: the micro-batch
        gradients are averaged, then one update. Returns the mean loss as a
        device scalar (no host synchronisation)."""
        keys = list(self._trainable)
        params = [self._trainable[k] for k in keys]
        n_micro = xs.shape[0]
        grads, loss_sum = None, None
        for i in range(n_micro):
            loss, _ = self._loss_fn(self.model, xs[i], ys[i], mask[i])
            g = torch.autograd.grad(loss, params)
            if grads is None:
                grads, loss_sum = list(g), loss.detach()
            else:
                torch._foreach_add_(grads, g)
                loss_sum = loss_sum + loss.detach()
        if n_micro > 1:
            torch._foreach_div_(grads, float(n_micro))
        self.tx.update_(self._trainable, dict(zip(keys, grads)), self.opt_state)
        return loss_sum / n_micro

    def step(self, xs, ys, mask) -> float:
        """One optimizer step over [accum, B, T] token microbatches."""
        xs, ys = self._tokens(xs), self._tokens(ys)
        mask = torch.as_tensor(np.asarray(mask, np.float32), device=self.device)
        if xs.ndim == 2:  # single microbatch convenience
            xs, ys, mask = xs[None], ys[None], mask[None]
        return float(self._train_step(xs, ys, mask))

    @torch.no_grad()
    def evaluate(self, x, y) -> dict:
        x, y = self._tokens(x), self._tokens(y)
        m = torch.ones((x.shape[0],), dtype=torch.float32, device=self.device)
        loss, (correct, denom) = self._eval_step(self.model, x, y, m)
        return {
            "eval_loss": float(loss),
            "eval_acc": float(correct) / max(float(denom), 1.0),
        }

    # -- federation exchange ------------------------------------------------
    def exchange_state(self) -> Dict[str, torch.Tensor]:
        """The exchange payload — the LoRA dict, or every parameter without
        LoRA — as detached copies, safe to ship."""
        return to_exchange(self.model)

    def load_exchange_state(self, exchanged: Mapping[str, Any]) -> None:
        """Copy an exchange payload into the live model in place."""
        from_exchange(self.model, exchanged)

    # -- the federated round ------------------------------------------------
    def compile_federated_round(self, n_clients: int, local_steps: int):
        """A whole federated LoRA round, with the semantics of the
        reference's fused round (``compile_federated_round``).

        Returns ``fed_round(params, opt_state, global_lora, xs, ys, ms,
        weights) -> (params, opt_state, new_global_lora, mean_loss)`` with
        ``xs``/``ys``: ``[n_clients, local_steps, B, T]`` token batches,
        ``ms``: ``[n_clients, local_steps, B]`` masks, ``weights``:
        ``[n_clients]`` aggregation weights. For each client the adapters are
        reset to ``global_lora`` and ``local_steps`` optimizer steps run; the
        AdamW state carries over from client to client (it is not reset);
        ``new_global = Σ w·lora / Σ w`` in f32; the returned params hold the
        LAST client's adapters; ``mean_loss`` is the mean over clients of
        each client's mean step loss, as a device scalar.

        ``params`` and ``opt_state`` must be this trainer's live model and
        optimizer state (``trainer.params``, ``trainer.opt_state``): the
        round updates them in place and returns them, which stands in for
        the reference's buffer donation. The round runs eagerly, every
        kernel on the current CUDA stream and no host synchronisation
        inside, so that it can later be captured in a CUDA graph.
        """
        if not self.lora_only:
            raise ValueError(
                "compile_federated_round requires a LoRA model (the frozen "
                "base rides inside the program; full-param exchange would "
                "double HBM)")
        n_clients, local_steps = int(n_clients), int(local_steps)

        def fed_round(params, opt_state, global_lora, xs, ys, ms, weights):
            if params is not self.model or opt_state is not self.opt_state:
                raise ValueError(
                    "fed_round updates the trainer's live model and optimizer "
                    "state in place: pass trainer.params and trainer.opt_state")
            xs, ys = self._tokens(xs), self._tokens(ys)
            ms = torch.as_tensor(np.asarray(ms, np.float32), device=self.device)
            w = torch.as_tensor(np.asarray(weights, np.float32), device=self.device)
            if xs.shape[:2] != (n_clients, local_steps):
                raise ValueError(f"xs is {tuple(xs.shape)}, the round was built for "
                                 f"{n_clients} clients x {local_steps} steps")
            acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=self.device)
                   for k, v in global_lora.items()}
            losses = []
            steps_in_round = n_clients * local_steps
            for c in range(n_clients):
                merge_lora(self.model, global_lora)  # client-switch
                steps = []
                for s in range(local_steps):
                    # every step does the same work: the catalog counts one
                    with repeated_cost("step", steps_in_round):
                        steps.append(self._train_step(xs[c, s][None], ys[c, s][None],
                                                      ms[c, s][None]))
                losses.append(torch.stack(steps).mean())
                for k, p in extract_lora(self.model).items():
                    acc[k].add_(w[c] * p.detach().to(torch.float32))
            wsum = w.sum()
            new_global = {k: a / wsum for k, a in acc.items()}
            return self.model, self.opt_state, new_global, torch.stack(losses).mean()

        return wrap_program("llm/fused_round", fed_round)

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, ckpt_dir: str, round_idx: int) -> str:
        """Save the live model's adapters (the whole model without LoRA) as
        ``<ckpt_dir>/round_<round_idx>``, keyed by the reference's paths."""
        path = os.path.abspath(os.path.join(ckpt_dir, f"round_{round_idx}"))
        payload = (dict(extract_lora(self.model)) if self.lora_only
                   else {ref_path(n): p for n, p in self.model.named_parameters()})
        self.last_save_bytes = write_round_dir(path, payload, round_idx)
        logger.info("saved %s checkpoint -> %s", "LoRA" if self.lora_only else "full",
                    path)
        return path

    def load_checkpoint(self, path: str) -> LlamaForCausalLM:
        return restore_checkpoint_into(self.model, path, lora_only=self.lora_only)

    @property
    def lora_only(self) -> bool:
        return self.cfg.lora_rank > 0


def restore_checkpoint_into(model: LlamaForCausalLM, path: str,
                            lora_only: bool) -> LlamaForCausalLM:
    """Restore a round checkpoint (:meth:`LLMTrainer.save_checkpoint`'s
    format) into ``model`` in place: a LoRA payload merges into the given
    base, a full one replaces every parameter; every key of the model's
    part must be there. Also the serving path (``serve --checkpoint``)."""
    flat = read_round_dir(os.path.abspath(path), device="cpu")
    want = (set(extract_lora(model)) if lora_only
            else {ref_path(n) for n, _ in model.named_parameters()})
    if set(flat) != want:
        raise KeyError(f"{path}: checkpoint keys do not match the model: missing "
                       f"{sorted(want - set(flat))[:5]}, unexpected "
                       f"{sorted(set(flat) - want)[:5]}")
    return from_exchange(model, flat)

