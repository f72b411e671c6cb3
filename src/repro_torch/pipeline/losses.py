"""Embedding, LM head and cross-entropy of the pipeline engine.

The port of ``repro.pipeline.losses``. The JAX package shards the
embedding table and the head over the combined model axis (stage x
tensor) on the vocab dimension, gathers locally with a mask and sums the
partial results with ``psum``; the only traffic is activation-sized.

On a ``launch/mesh.RankMesh`` the port does the same over the process
group of (stage, tensor): every argument is the rank's own shard (its
vocab rows of the table, its vocab columns of the head, its batch rows of
tokens, activations, labels and mask), the vocab shard's offset is the
rank's index over (stage, tensor), pad columns beyond ``vocab_size`` are
masked, and the loss's mean runs over the data group.

On a ``LocalMesh`` one device holds the whole vocab, so the vocab axis is
folded: the sums over shards become sums over the whole vocab (equal up
to the order of the additions), and the loss's mean runs over every data
shard's tokens at once, as the JAX package's ``psum`` over the data axes
does. ``data_sharded`` is accepted so that call sites read as the JAX
package's; it changes no result.
"""
from __future__ import annotations

import torch

from repro_torch import collectives
from repro_torch.launch.mesh import DATA_AXES, VOCAB_AXES, ranked

NEG = -1e30     # the JAX package's pad-column logit


def _vocab_offset(mesh, v_local: int) -> int:
    return mesh.index(VOCAB_AXES) * v_local if ranked(mesh) else 0


def embed_tokens(mesh, table, tokens, dtype=torch.bfloat16,
                 data_sharded=True):
    """table: [V, d] (a rank's [V / (stage x tensor), d]); tokens: [B, S]
    int. Returns x [B, S, d] in ``dtype``: the f32 table row, then the
    cast. On ranks: the masked lookup of the rank's rows, summed over
    (stage, tensor) in f32."""
    tokens = torch.as_tensor(tokens, device=table.device).long()
    if not ranked(mesh):
        return table.to(torch.float32)[tokens].to(dtype)
    V_l = table.shape[0]
    off = _vocab_offset(mesh, V_l)
    local = (tokens >= off) & (tokens < off + V_l)
    x = table[torch.clamp(tokens - off, 0, V_l - 1)] \
        * local[..., None].to(table.dtype)
    return collectives.psum(x.to(torch.float32),
                            mesh.group(VOCAB_AXES)).to(dtype)


def _masked_logits(mesh, head_w, y, vocab_size: int):
    """f32 logits ``y @ w`` (a rank's vocab columns) with the pad columns
    (``>= vocab_size``) at ``NEG``."""
    logits = y.to(torch.float32) @ head_w.to(torch.float32)
    V_l = logits.shape[-1]
    off = _vocab_offset(mesh, V_l)
    V_real = vocab_size or head_w.shape[-1]
    if V_real >= off + V_l:               # no pad column here
        return logits
    col = off + torch.arange(V_l, device=logits.device)
    return torch.where(col < V_real, logits, NEG)


def lm_head_loss(mesh, head_w, y, labels, mask, vocab_size: int = 0,
                 z_weight: float = 0.0):
    """Head matmul + cross-entropy. head_w: [d, V_padded]; y: [B, S, d];
    labels, mask: [B, S]. Pad columns are masked. Returns the scalar mean
    loss over the tokens ``mask`` keeps."""
    if ranked(mesh):
        return _rank_head_loss(mesh, head_w, y, labels, mask, vocab_size,
                               z_weight)
    logits = _masked_logits(mesh, head_w, y, vocab_size)
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


def _rank_head_loss(mesh, head_w, y, labels, mask, vocab_size, z_weight):
    """``lm_head_loss`` on a rank: the rank's vocab columns, the max, the
    partition sum and the label's logit over (stage, tensor), the mean
    over the data group (``src/repro/pipeline/losses.py:41-77``)."""
    vocab = mesh.group(VOCAB_AXES)
    data = mesh.group(DATA_AXES)
    logits = _masked_logits(mesh, head_w, y, vocab_size)
    V_l = logits.shape[-1]
    off = _vocab_offset(mesh, V_l)
    lmax = collectives.pmax(logits.max(dim=-1).values.detach(), vocab)
    z = collectives.psum(torch.exp(logits - lmax[..., None]).sum(dim=-1),
                         vocab)
    logz = torch.log(z) + lmax
    labels = torch.as_tensor(labels, device=logits.device).long()
    in_rng = (labels >= off) & (labels < off + V_l)
    idx = torch.clamp(labels - off, 0, V_l - 1)
    ll_loc = torch.gather(logits, -1, idx[..., None])[..., 0]
    ll = collectives.psum(torch.where(in_rng, ll_loc, 0.0), vocab)
    nll = (logz - ll) + z_weight * logz * logz
    mask = torch.as_tensor(mask, device=logits.device)
    num = collectives.psum((nll * mask).sum(), data)
    den = collectives.all_reduce(mask.sum(), data)
    return num / torch.clamp(den, min=1.0)


def lm_head_logits(mesh, head_w, y, data_sharded=True, vocab_size: int = 0):
    """Decode-time head: f32 logits over the padded vocab, the pad columns
    at ``NEG`` so sampling never picks them. On ranks, the rank's columns
    gathered over (stage, tensor): every rank holds the whole vocab of its
    batch rows."""
    logits = _masked_logits(mesh, head_w, y, vocab_size)
    if not ranked(mesh):
        return logits
    return collectives.gather(logits, mesh.group(VOCAB_AXES), -1)
