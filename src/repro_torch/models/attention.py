"""GQA multi-head attention: train/prefill (full sequence), chunked prefill
into a KV cache, and decode (one token against the cache).

The port of ``repro.models.attention``, with its layouts (activations
``[B, S, heads, head_dim]``, caches ``[B, cache_len, kv_heads, head_dim]``)
and its routing: with ``cfg.use_flash_attention`` set and the kv heads
aligned with the tensor shards (``kv_prop``), ``attention`` and
``chunk_attention`` go through the flash attention kernel (K4); otherwise,
and always for decode, through the plain ``_sdpa``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_kernel)
from repro_torch.models import modules
from repro_torch.models.tp import TP

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": modules.dense_init(gen, d, H * hd, bias=cfg.qkv_bias,
                                 dtype=dtype),
        "wk": modules.dense_init(gen, d, K * hd, bias=cfg.qkv_bias,
                                 dtype=dtype),
        "wv": modules.dense_init(gen, d, K * hd, bias=cfg.qkv_bias,
                                 dtype=dtype),
        "wo": modules.dense_init(gen, H * hd, d, dtype=dtype),
    }


def _split_heads(x, head_dim):
    b, s, hd_total = x.shape
    return x.reshape(b, s, hd_total // head_dim, head_dim)


def _kv_select(cfg: ModelConfig, q_heads_local: int, kv_heads_local: int,
               tp: TP, device="cpu"):
    """Local kv index for each local q head (GQA grouping across shards)."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    idx = tp.index()
    q_off = idx * q_heads_local
    kv_sharded = kv_heads_local < K
    kv_off = idx * kv_heads_local if kv_sharded else 0
    g = (q_off + torch.arange(q_heads_local, device=device)) * K // H
    return g - kv_off


def _sdpa(q, k, v, mask, dtype):
    """q:[B,Sq,Hl,hd] k,v:[B,Sk,Hl,hd] (already grouped) mask:[B?,Sq,Sk]
    or [Sq,Sk]: softmax in f32, the weighted sum in ``dtype``."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / torch.sqrt(
        torch.tensor(hd, dtype=torch.float32))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(dtype), v.to(dtype))


def full_mask(seq_q: int, seq_k: int, *, causal: bool, window: int = 0,
              q_start=0, device="cpu"):
    """[Sq, Sk] boolean mask; q positions are ``q_start + arange(Sq)``."""
    qpos = q_start + torch.arange(seq_q, device=device)[:, None]
    kpos = torch.arange(seq_k, device=device)[None, :]
    m = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def attention(p, x, *, cfg: ModelConfig, positions, causal: bool = True,
              window: int = 0, tp: TP = TP.none(), dtype=torch.bfloat16,
              kv_source=None):
    """Full-sequence attention (training / prefill).

    kv_source: if given ([B, Sk, d]), cross-attention over that sequence
    (no causal mask, no rope). Returns the [B, Sq, d] output.
    """
    hd = cfg.head_dim
    q = _split_heads(modules.dense(p["wq"], x, dtype), hd)
    kv_in = x if kv_source is None else kv_source.to(x.dtype)
    k = _split_heads(modules.dense(p["wk"], kv_in, dtype), hd)
    v = _split_heads(modules.dense(p["wv"], kv_in, dtype), hd)

    if kv_source is None:
        q = modules.apply_rope(q, positions, cfg.rope_theta,
                               cfg.rope_fraction)
        k = modules.apply_rope(k, positions, cfg.rope_theta,
                               cfg.rope_fraction)

    kv_prop = cfg.num_kv_heads >= cfg.tensor_parallel   # shards align
    if cfg.use_flash_attention and kv_source is None and kv_prop:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal, window)
        out = out.transpose(1, 2).to(dtype)
    else:
        sel = _kv_select(cfg, q.shape[2], k.shape[2], tp, x.device)
        k = k.index_select(2, sel)
        v = v.index_select(2, sel)
        mask = (full_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, device=x.device)
                if kv_source is None else None)
        out = _sdpa(q, k, v, mask, dtype)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    return modules.dense(p["wo"], out, dtype)


def _write_rows(cache, new, start: int):
    """A copy of ``cache`` [B, S, K, hd] with rows ``start:start+L`` set to
    ``new`` [B, L, K, hd] (``dynamic_update_slice``)."""
    out = cache.clone()
    out[:, start:start + new.shape[1]] = new.to(cache.dtype)
    return out


def chunk_attention(p, x, cache, *, cfg: ModelConfig, start: int,
                    tp: TP = TP.none(), dtype=torch.bfloat16,
                    window: int = 0):
    """Chunked-prefill attention: process ``L`` new tokens at global
    positions ``start + [0, L)``, appending their kv to the cache and
    attending causally over everything so far. Returns (out, new_cache)."""
    hd = cfg.head_dim
    L = x.shape[1]
    S_total = cache["k"].shape[1]
    start = int(start)
    q = _split_heads(modules.dense(p["wq"], x, dtype), hd)
    k = _split_heads(modules.dense(p["wk"], x, dtype), hd)
    v = _split_heads(modules.dense(p["wv"], x, dtype), hd)
    positions = start + torch.arange(L, dtype=torch.int32,
                                     device=x.device)[None, :]
    q = modules.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = modules.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)

    new_k = _write_rows(cache["k"], k, start)
    new_v = _write_rows(cache["v"], v, start)

    kv_prop = cfg.num_kv_heads >= cfg.tensor_parallel
    if cfg.use_flash_attention and kv_prop:
        out = flash_attention_kernel(
            q.transpose(1, 2), new_k.transpose(1, 2), new_v.transpose(1, 2),
            start, causal=True, window=window)
        out = out.transpose(1, 2).to(dtype)
    else:
        sel = _kv_select(cfg, q.shape[2], new_k.shape[2], tp, x.device)
        ks = new_k.index_select(2, sel)
        vs = new_v.index_select(2, sel)
        mask = full_mask(L, S_total, causal=True, window=window,
                         q_start=start, device=x.device)
        out = _sdpa(q, ks, vs, mask, dtype)
    out = out.reshape(out.shape[0], L, -1)
    return modules.dense(p["wo"], out, dtype), {"k": new_k, "v": new_v}


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      kv_heads_local: int, dtype=torch.bfloat16,
                      device="cpu"):
    hd = cfg.head_dim
    shape = (batch, cache_len, kv_heads_local, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cache, *, cfg: ModelConfig, pos,
                     tp: TP = TP.none(), dtype=torch.bfloat16):
    """One-token decode. x: [B, 1, d]; pos: an int OR per-sequence [B]
    int tensor (continuous batching: every slot at its own position).

    The cache is a ring buffer of length W (= sliding window, or max seq for
    full attention); rope is applied pre-cache, so slots need no positions.
    Returns (out [B,1,d], new_cache).
    """
    hd = cfg.head_dim
    B = x.shape[0]
    W = cache["k"].shape[1]
    q = _split_heads(modules.dense(p["wq"], x, dtype), hd)
    k = _split_heads(modules.dense(p["wk"], x, dtype), hd)
    v = _split_heads(modules.dense(p["wv"], x, dtype), hd)

    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=x.device).expand(B)     # [B]
    q = modules.apply_rope(q, pos_b[:, None], cfg.rope_theta,
                           cfg.rope_fraction)
    k = modules.apply_rope(k, pos_b[:, None], cfg.rope_theta,
                           cfg.rope_fraction)

    slot = torch.remainder(pos_b, W).long()                # [B]
    rows = torch.arange(B, device=x.device)
    new_k = cache["k"].clone()
    new_v = cache["v"].clone()
    new_k[rows, slot] = k[:, 0].to(new_k.dtype)
    new_v[rows, slot] = v[:, 0].to(new_v.dtype)

    sel = _kv_select(cfg, q.shape[2], new_k.shape[2], tp, x.device)
    ks = new_k.index_select(2, sel)
    vs = new_v.index_select(2, sel)

    valid = ((torch.arange(W, device=x.device)[None, :] <= pos_b[:, None])
             | (pos_b[:, None] >= W))                     # [B, W] ring
    mask = valid[:, None, None, :]                        # [B,1(H),1(Sq),W]
    out = _sdpa(q, ks, vs, mask, dtype)
    out = out.reshape(out.shape[0], 1, -1)
    return modules.dense(p["wo"], out, dtype), {"k": new_k, "v": new_v}
