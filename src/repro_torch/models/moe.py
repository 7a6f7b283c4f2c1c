"""Mixture-of-Experts FFN in PyTorch: the port of ``repro/models/moe.py``
(a top-k router, sort-based capacity dispatch into an ``[E, C, d]``
buffer, the experts' swiglu as batched bf16 products, the weighted
combine).

The numbers are those of JAX's jitted program on the CPU: the router
logits are f32 products of the bf16 inputs, unrounded (XLA folds the
program's ``.astype(f32)`` into the product; eager JAX rounds them to
bf16, where more of them tie and some tokens take other experts); the
softmax is ``exp(x - max) / sum`` in f32; top-k breaks ties
by the lower expert index, as ``lax.top_k``; the means of the load-balance
loss multiply by the f32 reciprocal of N; the combine multiplies each
slot's output by its bf16 weight and adds the k slots of a token in bf16,
one add at a time in slot order from zero, as JAX's scatter-add does.

Two runs give the same bits on the card: no op here adds with float
atomics.  The token rows reach the slots by expanding ``x`` over k (its
backward is a sum over k), each kept slot writes and reads the one buffer
cell it owns (the dropped slots go to a spare row that is cut off), and
the chosen probabilities are a select-and-sum over the E experts.

The dispatch runs over one token block, JAX's ``_dispatch_groups`` at
G = 1: the port's ``Model`` takes no mesh (ROADMAP.md Queue A 18c).

``record_routes`` and ``replay_routes`` serve the checks of one run
against another: the first collects each call's routing, the second makes
a run take a recorded run's experts.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels.common import stable_top_k

from .layers import _silu, f32_reciprocal, init_normal

# (top_e [N, k], probs [N, E]) of each moe_ffn call inside record_routes()
_routes: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
# the pairs that moe_ffn calls inside replay_routes() take their experts from
_replay: Optional[Iterator[Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def record_routes():
    """Collects each ``moe_ffn`` call's routing, in call order (one call a
    MoE layer in a forward or decode step), as detached ``(top_e, probs)``
    pairs: the list it yields.  A block under ``checkpoint`` with grad
    enabled runs again in the backward, and records again."""
    global _routes
    outer, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = outer


@contextlib.contextmanager
def replay_routes(routes):
    """Each ``moe_ffn`` call inside takes its experts from the next pair of
    ``routes`` (``record_routes``' list, in call order) instead of its own
    top-k; the gates stay this run's probabilities.  Two runs that round
    apart (the card and the CPU) then share one routing, so their
    gradients compare where a near tie would route a token apart."""
    global _replay
    outer, _replay = _replay, iter(routes)
    try:
        yield
    finally:
        _replay = outer


def init_moe(generator, cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = 1.0 / math.sqrt(d)
    return {"w_router": init_normal(generator, (d, E), s),
            "w_gate": init_normal(generator, (E, d, f), s),
            "w_up": init_normal(generator, (E, d, f), s),
            "w_down": init_normal(generator, (E, f, d), 1.0 / math.sqrt(f))}


def capacity(n_tokens: int, cfg) -> int:
    """Slots an expert holds for a block of ``n_tokens`` (JAX's rule, the
    same float expression)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    return max(int(math.ceil(n_tokens * k / E * cfg.capacity_factor)), 4)


def _positions_in_expert(slot_expert, num_experts: int):
    """Rank of each slot within its expert group, in slot order: a stable
    sort (``jnp.argsort`` is stable), the groups' starts, the rank."""
    n = slot_expert.shape[0]
    order = torch.sort(slot_expert, stable=True).indices
    sorted_e = slot_expert[order]
    starts = torch.searchsorted(sorted_e, torch.arange(
        num_experts, device=slot_expert.device, dtype=sorted_e.dtype))
    ranks = torch.arange(n, device=slot_expert.device) - starts[sorted_e]
    return torch.empty_like(ranks).scatter_(0, order, ranks)


def route(params, x, cfg):
    """Router of ``x [N, d]``: ``(probs [N, E] f32, top_p [N, k] f32
    renormalised, top_e [N, k] int64)``."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = x.float() @ params["w_router"].to(x.dtype).float()
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    if _replay is not None:
        top_e = next(_replay)[0].to(x.device)
    else:
        _, top_e = stable_top_k(probs.detach(), k)
    experts = torch.arange(E, device=x.device)
    top_p = torch.where(top_e[..., None] == experts, probs[:, None, :],
                        0.0).sum(dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def moe_ffn(params, x, cfg):
    """x ``[N, d]`` flat tokens -> (y ``[N, d]`` in x's dtype, the Switch
    load-balance loss, an f32 scalar)."""
    N, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dt = x.dtype
    probs, top_p, top_e = route(params, x, cfg)
    if _routes is not None:
        _routes.append((top_e.detach(), probs.detach()))

    inv_n = f32_reciprocal(N)
    experts = torch.arange(E, device=x.device)
    density = (top_e[:, :1] == experts).float().sum(dim=0) * inv_n
    mean_prob = probs.sum(dim=0) * inv_n
    aux = E * (density * mean_prob).sum()

    C = capacity(N, cfg)
    slot_expert = top_e.reshape(N * k)
    slot_weight = top_p.reshape(N * k).to(dt)
    pos = _positions_in_expert(slot_expert, E)
    # each kept slot's own cell of the [E * C] buffer; dropped slots share
    # a spare row, cut off below
    cell = torch.where(pos < C, slot_expert * C + pos, E * C)
    xk = x[:, None, :].expand(N, k, d).reshape(N * k, d)
    buf = x.new_zeros(E * C + 1, d).index_put((cell,), xk)
    buf = buf[:E * C].view(E, C, d)

    g = torch.bmm(buf, params["w_gate"].to(dt))
    u = torch.bmm(buf, params["w_up"].to(dt))
    out = torch.bmm(_silu(g) * u, params["w_down"].to(dt))

    out = torch.cat([out.reshape(E * C, d), out.new_zeros(1, d)])
    slot_out = (out[cell] * slot_weight[:, None]).view(N, k, d)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + slot_out[:, j]
    return y, aux
