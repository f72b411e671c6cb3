"""Embedding, LM head and cross-entropy of the pipeline engine.

The port of ``repro.pipeline.losses``. The JAX package shards the
embedding table and the head over the combined model axis (stage x
tensor) on the vocab dimension, gathers locally with a mask and sums the
partial results with ``psum``. One device holds the whole vocab, so the
vocab axis is folded: the sums over shards become sums over the whole
vocab (equal up to the order of the additions), and the loss's mean runs
over every data shard's tokens at once, as the JAX package's ``psum``
over the data axes does. ``mesh`` and ``data_sharded`` are accepted so
that call sites read as the JAX package's; neither changes the result on
one device.
"""
from __future__ import annotations

import torch

NEG = -1e30     # the JAX package's pad-column logit


def embed_tokens(mesh, table, tokens, dtype=torch.bfloat16,
                 data_sharded=True):
    """table: [V, d]; tokens: [B, S] int. Returns x [B, S, d] in ``dtype``:
    the f32 table row, then the cast."""
    tokens = torch.as_tensor(tokens, device=table.device).long()
    return table.to(torch.float32)[tokens].to(dtype)


def _masked_logits(head_w, y, vocab_size: int):
    """f32 logits ``y @ w`` with the pad columns (``>= vocab_size``) at
    ``NEG``."""
    logits = y.to(torch.float32) @ head_w.to(torch.float32)
    V_real = vocab_size or head_w.shape[-1]
    if V_real >= logits.shape[-1]:        # no pad column
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < V_real, logits, NEG)


def lm_head_loss(mesh, head_w, y, labels, mask, vocab_size: int = 0,
                 z_weight: float = 0.0):
    """Head matmul + cross-entropy. head_w: [d, V_padded]; y: [B, S, d];
    labels, mask: [B, S]. Pad columns are masked. Returns the scalar mean
    loss over the tokens ``mask`` keeps."""
    logits = _masked_logits(head_w, y, vocab_size)
    # the stabiliser carries no gradient (it cancels in d logsumexp)
    lmax = logits.max(dim=-1).values.detach()
    z = torch.exp(logits - lmax[..., None]).sum(dim=-1)
    logz = torch.log(z) + lmax
    labels = torch.as_tensor(labels, device=logits.device).long()
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - ll) + z_weight * logz * logz
    mask = torch.as_tensor(mask, device=logits.device)
    num = (nll * mask).sum()
    den = mask.sum()
    return num / torch.clamp(den, min=1.0)


def lm_head_logits(mesh, head_w, y, data_sharded=True, vocab_size: int = 0):
    """Decode-time head: f32 logits over the padded vocab, the pad columns
    at ``NEG`` so sampling never picks them."""
    return _masked_logits(head_w, y, vocab_size)
