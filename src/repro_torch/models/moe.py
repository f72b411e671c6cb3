"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

The port of ``repro.models.moe``. Dispatch is scatter/gather
(Megablocks-style), not compute-every-expert: each expert runs on a
``[C, d]`` buffer of the tokens routed to it, ``C`` the capacity. The
layout keeps the JAX package's expert-parallel split (the shard owns
``E_local`` contiguous experts from ``e0``); the port has ``TP.none()``
only, so one shard owns them all.

What decides which route is kept must be the JAX package's exactly:
  - top-k keeps the lower expert index on ties (``jax.lax.top_k``): the
    first ``k`` of a stable descending sort;
  - a route's rank within its expert counts the earlier routes to that
    expert in the flat, token-major order of ``top_e``; routes ranked at
    or past ``C`` are dropped.
Kept routes own one buffer row each; dropped ones all go to a trash row
that is cut off, so the scatter is a copy. The expert products are plain
batched matrix products, as in the JAX package (no Pallas kernel there).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import modules
from repro_torch.models.tp import TP


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = gen.device
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)

    def randn(*shape):
        return modules.randn(gen, shape, dtype)

    return {
        "router": modules.dense_init(gen, d, E, dtype=dtype),
        "w1": randn(E, d, ff) * s_in,     # gate proj
        "w3": randn(E, d, ff) * s_in,     # up proj
        "w2": randn(E, ff, d) * s_out,    # down proj
    }


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    c = int(num_tokens * cfg.moe_top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p_router, xt, k: int):
    """Router in f32. xt: [T, d] -> (probs [T, E], top_w [T, k]
    renormalised, top_e [T, k]), ties to the lower expert index."""
    logits = modules.dense(p_router, xt, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_e


def dispatch(top_e, num_experts: int, C: int, e0: int = 0,
             E_local: int | None = None):
    """Which routes survive capacity, and where they go. top_e: [T, k].
    A route's rank is the count of earlier routes to its expert in the
    flat token-major order; it is kept iff its rank is below ``C``.
    Returns (keep, local, slot), each [T*k]: kept; kept and owned by this
    shard (experts ``e0 .. e0+E_local``); its row of the ``[E_local*C + 1,
    d]`` buffer (the last row, a trash row, for the others)."""
    E_local = num_experts if E_local is None else E_local
    flat_e = top_e.reshape(-1)                                    # [T*k]
    # the JAX package's cumsum of the [T*k, E] one-hot over routes, run
    # on its transpose: integers, so the same ranks, and the card scans a
    # contiguous axis in parallel where it scans 64 strided columns of
    # T*k steps one step at a time
    onehot = F.one_hot(flat_e, num_experts).T.contiguous()        # [E, T*k]
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(
        0, flat_e[None, :])[0]
    keep = rank < C
    local = (flat_e >= e0) & (flat_e < e0 + E_local) & keep
    slot = torch.where(local, (flat_e - e0) * C + rank,
                       torch.full_like(rank, E_local * C))
    return keep, local, slot


def moe_ffn(p, x, *, cfg: ModelConfig, tp: TP = TP.none(),
            dtype=torch.bfloat16):
    """x: [B, S, d]. Returns (partial_out [B, S, d], aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    E_local = E // tp.size
    e0 = tp.index() * E_local
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, d)

    # --- routing ----------------------------------------------------------
    probs, top_w, top_e = route(p["router"], xt, k)

    # load-balance aux loss (Switch-style): E * <frac_tokens_e> . <prob_e>
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e, E).to(torch.float32).sum(dim=1).mean(dim=0) / k
    aux = E * torch.sum(me * ce)

    keep, local, slot = dispatch(top_e, E, C, e0, E_local)
    trash = E_local * C

    # --- scatter: each kept route owns its row; dropped ones the trash row
    xk = xt.repeat_interleave(k, dim=0).to(dtype)                 # [T*k, d]
    buf = torch.zeros((trash + 1, d), dtype=dtype, device=x.device)
    buf.index_copy_(0, slot, xk)
    eb = buf[:-1].reshape(E_local, C, d)

    # --- expert FFN (gated) -------------------------------------------------
    act = modules.activation(cfg.act)
    w1, w3, w2 = (p[n].to(dtype) for n in ("w1", "w3", "w2"))
    h = act(torch.bmm(eb, w1)) * torch.bmm(eb, w3)
    y = torch.bmm(h, w2)                                          # [E_l, C, d]

    # --- gather back + combine ----------------------------------------------
    yf = torch.cat([y.reshape(trash, d),
                    torch.zeros((1, d), dtype=dtype, device=x.device)])
    tok_y = yf[slot]                                              # [T*k, d]
    w = (top_w.reshape(-1) * keep * local).to(dtype)
    out = (tok_y * w[:, None]).reshape(T, k, d).sum(dim=1)
    return out.reshape(B, S, d), aux
