"""Plain PyTorch version of the flash attention kernel (K4): dense GQA
softmax attention in f32.

The counterpart of ``repro.kernels.flash_attention.ref`` with the
kernel's ``q_offset`` added. It masks the true ``Skv`` (every key it is
given is real), never a padded one.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0):
    """q: [B, H, Sq, dh]; k, v: [B, Hkv, Skv, dh] (GQA: query head h reads
    kv head ``h*Hkv//H``). Query row i sits at global position
    ``q_offset + i``, key j at position j. Returns [B, H, Sq, dh] in q's
    dtype."""
    B, H, Sq, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    scale = scale if scale is not None else dh ** -0.5
    kv_head = torch.arange(H, device=q.device) * Hkv // H
    k = k.index_select(1, kv_head).to(torch.float32)
    v = v.index_select(1, kv_head).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out.to(q.dtype)
