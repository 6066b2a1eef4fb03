"""Functional layers for the port's simulation models.

A model of the port is a plain callable ``model(scope, x)`` written like a
flax ``@nn.compact`` module: each layer call takes a :class:`Scope`, which
names it as flax does (``Conv_0``, ``Conv_1``, ``BasicBlock_0/GroupNorm_1``,
``OptimizedLSTMCell_0/hi``) and either reads its parameters from a flat
``{path: tensor}`` dict (:func:`apply`) or creates them (:func:`init`). So
a port tree holds exactly the reference's leaves under the reference's
paths; only the layout of some leaves differs (torch's, so cuDNN and cuBLAS
take them as they are):

* Dense and LSTM kernels ``[out, in]`` (flax ``[in, out]``);
* Conv kernels OIHW (flax HWIO);
* Embed tables, biases and GroupNorm scales as in flax.

Activations run in NCHW: a conv model permutes its NHWC input once, at its
entry, and back to NHWC before it flattens into a Dense layer, so the
flattened features come in the reference's order. Where flax's semantics
differ from torch's defaults the layers follow flax: "SAME" padding is
asymmetric when the total is odd (stride 2 on an even size pads (0, 1));
GroupNorm's epsilon is 1e-6 and its variance is E[x²] − E[x]², clipped at
zero; the LSTM cell has no input bias and starts from a zero carry.

Initial values follow flax's default distributions (lecun-normal kernels
truncated at two deviations, zero biases, unit norm scales, orthogonal
recurrent kernels), drawn from a seeded torch generator: the same shapes
and distributions as the reference, not the same bits. Parity runs carry
the reference's values across with ``models/convert.from_flax_params``.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]


class Scope:
    """Names and holds the parameters of one model call (see module doc)."""

    def __init__(self, params: Optional[Tree], path: str = "params",
                 generator: Optional[torch.Generator] = None,
                 created: Optional[Tree] = None):
        self.params = params
        self.path = path
        self.generator = generator
        self.created = created if created is not None else {}
        self._counts: Dict[str, int] = defaultdict(int)

    def sub(self, kind: str) -> "Scope":
        """The next auto-named child scope of this kind (``Conv_3``)."""
        n = self._counts[kind]
        self._counts[kind] += 1
        return self.named(f"{kind}_{n}")

    def named(self, name: str) -> "Scope":
        return Scope(self.params, f"{self.path}/{name}", self.generator,
                     self.created)

    def param(self, name: str, shape: Sequence[int],
              init: Callable[..., torch.Tensor]) -> torch.Tensor:
        path = f"{self.path}/{name}"
        if self.params is not None:
            p = self.params[path]
            if tuple(p.shape) != tuple(shape):
                raise ValueError(f"{path}: shape {tuple(p.shape)} != {tuple(shape)}")
            return p
        t = init(tuple(shape), self.generator)
        self.created[path] = t
        return t


# -- initializers (flax's defaults) -------------------------------------------

def lecun_normal(fan_in: int) -> Callable:
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978

    def init(shape, gen):
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t * std

    return init


def normal(std: float) -> Callable:
    return lambda shape, gen: torch.randn(shape, generator=gen) * std


def orthogonal(shape, gen):
    t = torch.empty(shape)
    torch.nn.init.orthogonal_(t, generator=gen)
    return t


def zeros(shape, gen):
    return torch.zeros(shape)


def ones(shape, gen):
    return torch.ones(shape)


# -- layers -------------------------------------------------------------------

def dense(s: Scope, x: torch.Tensor, features: int,
          use_bias: bool = True) -> torch.Tensor:
    d = s.sub("Dense")
    w = d.param("kernel", (features, x.shape[-1]), lecun_normal(x.shape[-1]))
    b = d.param("bias", (features,), zeros) if use_bias else None
    return F.linear(x, w, b)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: Tuple[int, int], stride: Tuple[int, int],
              value: float = 0.0):
    """(padded x, symmetric padding for the op) for flax's "SAME"."""
    (hl, hh), (wl, wh) = (_same_pads(x.shape[2], k[0], stride[0]),
                          _same_pads(x.shape[3], k[1], stride[1]))
    if hl == hh and wl == wh and value == 0.0:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv(s: Scope, x: torch.Tensor, features: int, kernel: Tuple[int, int],
         strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
         use_bias: bool = True) -> torch.Tensor:
    """flax ``nn.Conv`` on an NCHW input with an OIHW kernel."""
    c = s.sub("Conv")
    cin = x.shape[1]
    w = c.param("kernel", (features, cin, kernel[0], kernel[1]),
                lecun_normal(cin * kernel[0] * kernel[1]))
    b = c.param("bias", (features,), zeros) if use_bias else None
    pad = (0, 0)
    if padding == "SAME":
        x, pad = _pad_same(x, kernel, strides)
    elif padding != "VALID":
        raise ValueError(f"unsupported conv padding {padding!r}")
    return F.conv2d(x, w, b, stride=strides, padding=pad)


def group_norm(s: Scope, x: torch.Tensor, num_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.GroupNorm`` over the channels of an NCHW input: fast
    variance E[x²] − E[x]² clipped at 0, then (x − mean)·(rsqrt(var + eps)
    · scale) + bias."""
    g = s.sub("GroupNorm")
    n, ch = x.shape[:2]
    scale = g.param("scale", (ch,), ones)
    bias = g.param("bias", (ch,), zeros)
    xg = x.reshape(n, num_groups, ch // num_groups, *x.shape[2:])
    dims = tuple(range(2, xg.ndim))
    mean = xg.mean(dims, keepdim=True)
    mean2 = (xg * xg).mean(dims, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    per_channel = (1, num_groups, ch // num_groups) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(var + eps) * scale.reshape(per_channel)
    y = (xg - mean) * mul + bias.reshape(per_channel)
    return y.reshape(x.shape)


def max_pool(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
             padding: str = "VALID") -> torch.Tensor:
    if padding == "SAME":
        x, _ = _pad_same(x, window, strides, value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def embed(s: Scope, x: torch.Tensor, num: int, features: int) -> torch.Tensor:
    e = s.sub("Embed")
    table = e.param("embedding", (num, features), normal(math.sqrt(1.0 / features)))
    return F.embedding(x.long(), table)


def lstm(s: Scope, x: torch.Tensor, hidden: int) -> torch.Tensor:
    """``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over ``x`` [B, T, D]: gates
    i, f, g, o; per-gate input kernels without bias (``ii``…``io``) and
    hidden kernels with bias (``hi``…``ho``); a zero initial carry."""
    cell = s.sub("OptimizedLSTMCell")
    d = x.shape[-1]
    wi = torch.cat([cell.named(f"i{g}").param("kernel", (hidden, d), lecun_normal(d))
                    for g in "ifgo"], 0)
    hs = [cell.named(f"h{g}") for g in "ifgo"]
    wh = torch.cat([h.param("kernel", (hidden, hidden), orthogonal) for h in hs], 0)
    bh = torch.cat([h.param("bias", (hidden,), zeros) for h in hs], 0)
    xi = F.linear(x, wi)  # [B, T, 4H], every step's input projection at once
    h = x.new_zeros(x.shape[0], hidden)
    c = x.new_zeros(x.shape[0], hidden)
    outs = []
    for t in range(x.shape[1]):
        z = F.linear(h, wh, bh) + xi[:, t]
        i, f, g, o = z.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def flatten_nchw(x: torch.Tensor) -> torch.Tensor:
    """Flatten in NHWC order, as the reference's ``x.reshape((N, -1))``."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# -- whole models ---------------------------------------------------------------

def init(model: Callable, sample_input: torch.Tensor, seed: int = 0,
         device: Optional[torch.device] = None) -> Tree:
    """Create ``model``'s parameters for ``sample_input``'s shape, from a
    torch generator seeded with ``seed``; dict in the reference's leaf order."""
    from fedml_tpu_torch.utils.tree import leaf_order

    gen = torch.Generator().manual_seed(int(seed))
    s = Scope(None, generator=gen)
    with torch.no_grad():  # shapes only: one sample row, on the CPU
        model(s, sample_input[:1].to("cpu"))
    return {k: s.created[k].to(device) for k in leaf_order(s.created)}


def apply(model: Callable, params: Tree, x: torch.Tensor) -> torch.Tensor:
    """``model`` at ``params`` on ``x``; a floating input takes the
    parameters' dtype (float32 data through a float64 model, for one)."""
    if x.is_floating_point():
        x = x.to(next(iter(params.values())).dtype)
    return model(Scope(params), x)
