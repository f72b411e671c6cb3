"""The pipeline-parallel execution engine, on one device.

The port of ``repro.pipeline.pipeline_step``. The JAX engine runs one
SPMD body per device of a (data, stage, tensor) mesh under ``shard_map``:
microbatches enter stage 0, activations move stage -> stage + 1 by
``ppermute``, and a ``lax.scan`` runs M + S - 1 ticks; the backward is the
gradient of that scan (GPipe with remat; the paper's asynchronous
semantics live in the cross-step weight stash of ``make_train_step``).

Here every axis of the mesh (``launch/mesh.LocalMesh``) is folded onto
one device:
- stage: kept in the schedule. At tick ``t`` stage ``s`` works on
  microbatch ``t - s``; its input is row ``t`` of the microbatches at
  stage 0, else what stage ``s - 1`` handed on at tick ``t - 1`` (the
  ``ppermute``), cast to the compute dtype as the JAX engine casts it.
  The JAX engine also computes the (t, s) pairs outside
  ``0 <= t - s < M`` and discards them with ``where(valid, ...)``; they
  contribute zero gradient and write no cache, so they are skipped here
  and no result changes.
- data (pod, data, extra): each data shard's rows run in turn, so the
  microbatch split is the one the JAX engine makes on the same mesh
  (MoE's capacity and load-balance loss depend on it).
- tensor: blocks run on whole weights under ``TP.none()``, which computes
  the sum the JAX engine's ``psum`` forms over shards, up to the order of
  the additions.
A multi-device backend (ROADMAP Queue 1 item 12) replaces only the loop
over stages and the hand-off.

Decode: the same schedule with one token per microbatch and per-stage
KV/SSM caches. No tensor passed in (params, caches, state) is written:
every result is a new tensor, as with JAX's immutable arrays.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.models import modules
from repro_torch.models.blocks import BLOCKS, BlockCtx
from repro_torch.models.tp import TP
from repro_torch.pipeline import losses as loss_lib
from repro_torch.pipeline.sharding import (AXIS_STAGE, AXIS_TENSOR,
                                           data_axes)


def _check_mesh(mesh, cfg: ModelConfig):
    """The leading axis of every stacked leaf is split over "stage", and
    the shard shapes follow ``cfg.tensor_parallel``: the mesh must agree
    with both, as the JAX engine needs."""
    shape = mesh.shape
    if shape.get(AXIS_STAGE) != cfg.pipeline_stages:
        raise ValueError(f"mesh stage axis {shape.get(AXIS_STAGE)} != "
                         f"pipeline_stages {cfg.pipeline_stages}")
    if shape.get(AXIS_TENSOR, 1) != cfg.tensor_parallel:
        raise ValueError(f"mesh tensor axis {shape.get(AXIS_TENSOR, 1)} != "
                         f"tensor_parallel {cfg.tensor_parallel}")


def _shard_rows(mesh, B: int, data_sharded: bool) -> list[slice]:
    """The batch rows of each data shard (one shard holding every row
    when the batch is replicated)."""
    if not data_sharded:
        return [slice(0, B)]
    n = math.prod(mesh.shape[a] for a in data_axes(mesh))
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} data shards")
    B_l = B // n
    return [slice(i * B_l, (i + 1) * B_l) for i in range(n)]


def _stage_slots(blocks, S):
    """slots[s][j]: slot j's params at stage s (views of the stacked
    leaves)."""
    return [[tree.map(lambda a: a[s], slot) for slot in blocks]
            for s in range(S)]


# ============================ forward (train/prefill) =====================

def pipeline_forward(mesh, cfg: ModelConfig, blocks, x, pad_mask, *,
                     layout=None, num_microbatches: int = 0, causal=True,
                     window: int = 0, kv_source=None, remat=True,
                     data_sharded=True, dtype=None, unroll=False):
    """x: [B, seq, d]. Returns (y [B, seq, d] from the last stage, aux
    scalar: the sum over stages of the mean over data shards of the
    stage's aux summed over its microbatches over M). ``unroll`` is
    accepted for the JAX signature and has no effect (there is no scan to
    unroll)."""
    _check_mesh(mesh, cfg)
    layout = tuple(layout or cfg.slot_layout)
    S = cfg.pipeline_stages
    dtype = dtype or modules.dtype_of(cfg.dtype)
    B, seq, d = x.shape
    shards = _shard_rows(mesh, B, data_sharded)
    B_l = shards[0].stop - shards[0].start
    M = min(num_microbatches or B_l, B_l)
    while B_l % M:
        M -= 1
    mb = B_l // M
    dev = x.device
    slots = _stage_slots(blocks, S)
    positions = torch.arange(seq, dtype=torch.int32, device=dev).expand(
        mb, seq)

    def stage_fn(s, xin, kv_in):
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        xx = xin
        for j, t in enumerate(layout):
            ctx = BlockCtx(cfg=cfg, positions=positions, tp=TP.none(),
                           dtype=dtype, causal=causal, window=window,
                           kv_source=kv_in, active=pad_mask[s, j])
            xx, a = BLOCKS[t].apply(slots[s][j], xx, ctx)
            aux = aux + a
        return xx, aux

    def run_stage(s, xin, kv_in):
        if remat and torch.is_grad_enabled():
            # non-reentrant: the reentrant variant drops the gradients of
            # the params the closure captures
            return checkpoint(functools.partial(stage_fn, s), xin, kv_in,
                              use_reentrant=False)
        return stage_fn(s, xin, kv_in)

    ys, aux_by_shard = [], []
    for rows in shards:
        x_mb = x[rows].reshape(M, mb, seq, d).to(dtype)
        kv_mb = (None if kv_source is None else
                 kv_source[rows].reshape(M, mb, *kv_source.shape[1:])
                 .to(dtype))
        aux = [torch.zeros((), dtype=torch.float32, device=dev)] * S
        y_buf = [None] * M
        handed = [None] * S          # what each stage sent at the last tick
        for t in range(M + S - 1):
            sent = [None] * S
            for s in range(S):
                idx = t - s
                if not 0 <= idx < M:     # the JAX engine's invalid ticks
                    continue
                xin = x_mb[idx] if s == 0 else handed[s - 1]
                y, a = run_stage(s, xin,
                                 None if kv_mb is None else kv_mb[idx])
                aux[s] = aux[s] + a
                sent[s] = y.to(dtype)
                if s == S - 1:
                    y_buf[idx] = sent[s]
            handed = sent
        ys.append(torch.cat(y_buf).reshape(B_l, seq, d))
        aux_by_shard.append(torch.stack(aux) / M)
    aux_all = torch.stack(aux_by_shard, dim=1)           # [S, shards]
    return torch.cat(ys), aux_all.mean(dim=1).sum()


# ================================ decode ==================================

def _as_position(pos, device):
    """One position for the whole batch: an int or a 0-d tensor."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim != 0:
        raise ValueError(f"pipeline decode takes one position for the "
                         f"batch, got shape {tuple(pos.shape)}")
    return pos


def _stacked(per_stage, like):
    """New stage-stacked caches: ``per_stage[s][j]`` is slot j's cache at
    stage s over the batch rows in order; leaves keep ``like``'s dtype."""
    out = []
    for j, c in enumerate(like):
        leaves, paths = tree.flatten(c)
        cols = [tree.leaves(st[j]) for st in per_stage]
        out.append(tree.unflatten(paths, [
            torch.stack([col[i] for col in cols]).to(leaf.dtype)
            for i, leaf in enumerate(leaves)]))
    return out


def _cat_rows(parts):
    """Slot caches of consecutive row blocks -> one cache over all rows."""
    return [tree.map(lambda *xs: torch.cat(xs), *slot) for slot in
            zip(*parts)]


def pipeline_decode(mesh, cfg: ModelConfig, blocks, x, caches, pos,
                    pad_mask, *, layout=None, num_microbatches: int = 0,
                    window: int = 0, kv_source=None, data_sharded=True,
                    dtype=None):
    """One-token decode through the pipeline.

    x: [B, 1, d]; caches: list (per slot) of stage-stacked trees [S, B, ...];
    pos: an int or a 0-d int tensor (the position of the whole batch).
    Returns (y [B, 1, d], new caches); the caches passed in are not
    written.
    """
    _check_mesh(mesh, cfg)
    layout = tuple(layout or cfg.slot_layout)
    S = cfg.pipeline_stages
    dtype = dtype or modules.dtype_of(cfg.dtype)
    B, _, d = x.shape
    shards = _shard_rows(mesh, B, data_sharded)
    B_l = shards[0].stop - shards[0].start
    M = min(num_microbatches or min(B_l, S), B_l)
    while B_l % M:
        M -= 1
    mb = B_l // M
    pos_t = _as_position(pos, x.device)
    slots = _stage_slots(blocks, S)

    def stage_fn(s, xin, cin, kv_in):
        xx = xin
        cout = []
        for j, t in enumerate(layout):
            ctx = BlockCtx(cfg=cfg, pos=pos_t, tp=TP.none(), dtype=dtype,
                           window=window, kv_source=kv_in,
                           active=pad_mask[s, j])
            xx, c = BLOCKS[t].step(slots[s][j], xx, cin[j], ctx)
            cout.append(c)
        return xx, cout

    ys = []
    rows_out = [[] for _ in range(S)]    # per stage: slot caches by rows
    for rows in shards:
        x_mb = x[rows].reshape(M, mb, 1, d).to(dtype)
        kv_rows = None if kv_source is None else kv_source[rows]
        y_buf = [None] * M
        handed = [None] * S
        for t in range(M + S - 1):
            sent = [None] * S
            for s in range(S):
                idx = t - s
                if not 0 <= idx < M:     # the JAX engine's invalid ticks
                    continue
                r0 = rows.start + idx * mb
                cin = [tree.map(lambda a: a[s, r0:r0 + mb], c)
                       for c in caches]
                kv_in = (None if kv_rows is None else
                         kv_rows[idx * mb:(idx + 1) * mb].to(dtype))
                xin = x_mb[idx] if s == 0 else handed[s - 1]
                y, cout = stage_fn(s, xin, cin, kv_in)
                rows_out[s].append(cout)
                sent[s] = y.to(dtype)
                if s == S - 1:
                    y_buf[idx] = sent[s]
            handed = sent
        ys.append(torch.cat(y_buf))
    # every stage met every microbatch once, in row order
    new_caches = _stacked([_cat_rows(r) for r in rows_out], caches)
    return torch.cat(ys), new_caches


# ======================= chunked-sequence prefill =========================

def pipeline_prefill_chunked(mesh, cfg: ModelConfig, blocks, x, caches,
                             pad_mask, *, seq_chunks: int, layout=None,
                             window: int = 0, data_sharded=True, dtype=None):
    """Sequence-dimension pipelining for prefill: microbatch i = tokens
    [i*L, (i+1)*L) of EVERY sequence; per-stage KV/SSM caches carry the
    context between chunks, so the pipeline bubble shrinks from
    (B_l+S-1)/B_l to (C+S-1)/C with C = seq_chunks.

    x: [B, S_total, d]; caches: stage-stacked, cache_len == S_total.
    Returns (y_last_chunk [B, L, d], new caches); the caches passed in are
    not written.
    """
    _check_mesh(mesh, cfg)
    layout = tuple(layout or cfg.slot_layout)
    S = cfg.pipeline_stages
    dtype = dtype or modules.dtype_of(cfg.dtype)
    B, S_total, d = x.shape
    shards = _shard_rows(mesh, B, data_sharded)
    M = seq_chunks
    if S_total % M:
        raise ValueError(f"sequence {S_total} does not split into {M} "
                         f"chunks")
    L = S_total // M
    slots = _stage_slots(blocks, S)

    def stage_fn(s, xin, cin, start):
        xx = xin
        cout = []
        for j, t in enumerate(layout):
            ctx = BlockCtx(cfg=cfg, pos=start, tp=TP.none(), dtype=dtype,
                           window=window, active=pad_mask[s, j])
            xx, c = BLOCKS[t].prefill_chunk(slots[s][j], xx, cin[j], ctx)
            cout.append(c)
        return xx, cout

    ys = []
    by_stage = [[] for _ in range(S)]    # per stage: slot caches by shard
    for rows in shards:
        x_rows = x[rows].to(dtype)
        cur = [[tree.map(lambda a: a[s, rows], c) for c in caches]
               for s in range(S)]
        y_last = None
        handed = [None] * S
        for t in range(M + S - 1):
            sent = [None] * S
            for s in range(S):
                idx = t - s
                if not 0 <= idx < M:     # the JAX engine's invalid ticks
                    continue
                xin = (x_rows[:, idx * L:(idx + 1) * L] if s == 0
                       else handed[s - 1])
                y, cur[s] = stage_fn(s, xin, cur[s], idx * L)
                sent[s] = y.to(dtype)
                if s == S - 1 and idx == M - 1:
                    y_last = sent[s]
            handed = sent
        ys.append(y_last)
        for s in range(S):
            by_stage[s].append(cur[s])
    new_caches = _stacked([_cat_rows(r) for r in by_stage], caches)
    return torch.cat(ys), new_caches


CHUNKABLE = {"dense", "moe", "mamba", "hybrid", "mlstm", "slstm"}


# ============================ train / serve steps =========================

def _stage_window_blend(cfg, new_blocks, stash_blocks):
    """Paper weight aggregation mapped onto the depth-2 stash: stages with
    n - i >= 2 live versions average (new, stash); the last stage keeps new.
    Leaves carry a leading stage axis."""
    S = cfg.pipeline_stages

    def blend(n, s):
        alpha = torch.where(torch.arange(S, device=n.device) < S - 1, 0.5,
                            1.0)
        a = alpha.reshape((S,) + (1,) * (n.ndim - 1)).to(torch.float32)
        return (a * n.to(torch.float32)
                + (1 - a) * s.to(torch.float32)).to(n.dtype)

    return tree.map(blend, new_blocks, stash_blocks)


def _decoder_input(params, cfg, tokens, dtype, mesh):
    """Whisper's decoder input: token embeddings + sinusoidal positions."""
    x = loss_lib.embed_tokens(mesh, params["embed"]["table"], tokens, dtype)
    Sq = x.shape[1]
    pos_table = modules.sinusoidal_positions(max(Sq, 2), cfg.d_model,
                                             x.device)
    return x + pos_table[None, :Sq].to(dtype)


def _encode(mesh, cfg, params, frames, dtype, num_microbatches, remat,
            unroll=False):
    """Whisper's encoder through the engine (non-causal)."""
    frames = torch.as_tensor(frames, device=params["embed"]["table"].device)
    xe, _ = model_lib.embed_frames(cfg, frames, dtype)
    pm_e = model_lib.pad_mask(cfg, device=xe.device)
    xe, _ = pipeline_forward(mesh, cfg, params["blocks"], xe, pm_e,
                             layout=cfg.slot_layout, causal=False,
                             num_microbatches=num_microbatches, remat=remat,
                             unroll=unroll)
    return xe


def _decoder_pad_mask(cfg, device):
    return model_lib.pad_mask(cfg, model_lib.decoder_assignment(cfg),
                              cfg.decoder_slot_layout, device=device)


def _final_norm(params, cfg, y):
    return (modules.layernorm if cfg.family == "audio" else modules.rmsnorm)(
        params["final_norm"], y, cfg.norm_eps)


def make_loss_fn(mesh, cfg: ModelConfig, *, num_microbatches=0, remat=True,
                 window: int = 0, unroll=False):
    def loss_fn(params, batch):
        dtype = modules.dtype_of(cfg.dtype)
        table = params["embed"]["table"]
        tokens = torch.as_tensor(batch["tokens"], device=table.device)
        if cfg.family == "audio":
            xe = _encode(mesh, cfg, params, batch["frames"], dtype,
                         num_microbatches, remat, unroll)
            x = _decoder_input(params, cfg, tokens, dtype, mesh)
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=x.device)
            y, aux = pipeline_forward(mesh, cfg, params["dec_blocks"], x,
                                      _decoder_pad_mask(cfg, x.device),
                                      layout=cfg.decoder_slot_layout,
                                      kv_source=xe, remat=remat,
                                      num_microbatches=num_microbatches,
                                      unroll=unroll)
        else:
            x = loss_lib.embed_tokens(mesh, table, tokens, dtype)
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=x.device)
            if "prefix" in batch:
                prefix = torch.as_tensor(batch["prefix"], device=x.device)
                x = torch.cat([prefix.to(dtype), x], dim=1)
                mask = torch.cat([torch.zeros(prefix.shape[:2],
                                              dtype=torch.float32,
                                              device=x.device), mask], dim=1)
            pm = model_lib.pad_mask(cfg, device=x.device)
            y, aux = pipeline_forward(mesh, cfg, params["blocks"], x, pm,
                                      num_microbatches=num_microbatches,
                                      window=window or cfg.sliding_window,
                                      remat=remat, unroll=unroll)
        yn = _final_norm(params, cfg, y)
        labels = torch.as_tensor(batch["labels"], device=yn.device)
        if labels.shape[1] < yn.shape[1]:       # vlm prefix: no loss there
            pad = yn.shape[1] - labels.shape[1]
            labels = torch.cat([torch.zeros((labels.shape[0], pad),
                                            dtype=labels.dtype,
                                            device=labels.device), labels],
                               dim=1)
        loss = loss_lib.lm_head_loss(mesh, params["head"]["w"], yn, labels,
                                     mask, vocab_size=cfg.vocab_size)
        total = loss + cfg.router_aux_weight * aux
        return total, {"loss": loss, "aux": aux}

    return loss_fn


def make_train_step(mesh, cfg: ModelConfig, tc: TrainConfig, *,
                    window: int = 0):
    """Returns (train_step, loss_fn). State: {params, stash, opt_state, step}.

    Forward/backward run on the STASHED weights (one step stale, PipeDream-2BW
    adaptation of weight stashing); the update lands on the newest weights;
    aggregation blends per-stage version windows (paper §III-C). A step
    builds a new state and leaves every tensor of the one passed in as it
    was (``init_state`` puts the same tensors in params and stash)."""
    from repro_torch.optim import get_optimizer
    opt_init, opt_update = get_optimizer(tc.optimizer)
    loss_fn = make_loss_fn(mesh, cfg, num_microbatches=tc.microbatches,
                           remat=tc.remat, window=window)
    agg_every = cfg.aggregate_every

    def train_step(state, batch):
        leaves, paths = tree.flatten(state["stash"])
        # gradients on detached leaves: the stash's own tensors (shared
        # with params after init_state) are never marked
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        with torch.enable_grad():
            total, metrics = loss_fn(tree.unflatten(paths, live), batch)
            grads = torch.autograd.grad(total, live, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, live)]
        del live, total
        if tc.bf16_grads:
            # the JAX package casts before its data-parallel all-reduce
            grads = [g.to(torch.bfloat16) for g in grads]
        kw = dict(lr=tc.learning_rate, weight_decay=tc.weight_decay)
        if tc.optimizer == "sgd":
            kw["momentum"] = tc.momentum
        new_params, new_opt = opt_update(state["params"],
                                         tree.unflatten(paths, grads),
                                         state["opt_state"], **kw)
        del grads
        step = state["step"] + 1
        # a meta step has no value (launch/dryrun.py): its blend, work a
        # FLOP count does not see, is left out there
        if agg_every and not step.is_meta and int(step) % agg_every == 0:
            new_params = dict(new_params)
            for key in ("blocks", "dec_blocks"):
                if key in new_params:
                    new_params[key] = _stage_window_blend(
                        cfg, new_params[key], state["stash"][key])
        new_stash = state["params"] if cfg.stash_depth > 1 else new_params
        metrics = {k: torch.as_tensor(v).detach() for k, v in
                   metrics.items()}
        return {"params": new_params, "stash": new_stash,
                "opt_state": new_opt, "step": step}, metrics

    def init_state(params):
        leaves = tree.leaves(params)
        return {"params": params, "stash": params,
                "opt_state": opt_init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    train_step.init_state = init_state
    return train_step, loss_fn


def make_prefill_step(mesh, cfg: ModelConfig, *, num_microbatches=0,
                      window: int = 0, seq_chunks: int = 0):
    """Inference prefill: full-sequence forward, logits for the LAST position.

    seq_chunks > 1 switches to chunked-sequence pipelining (fills the KV/SSM
    caches as a side effect: the production prefill path)."""
    if seq_chunks > 1:
        if cfg.family == "audio" or not set(cfg.slot_layout) <= CHUNKABLE:
            raise ValueError(f"{cfg.name}: chunked prefill needs a "
                             f"non-audio layout of {sorted(CHUNKABLE)}, got "
                             f"{cfg.slot_layout}")

        def prefill_chunked(params, batch, caches):
            dtype = modules.dtype_of(cfg.dtype)
            x = loss_lib.embed_tokens(mesh, params["embed"]["table"],
                                      batch["tokens"], dtype)
            if "prefix" in batch:
                prefix = torch.as_tensor(batch["prefix"], device=x.device)
                x = torch.cat([prefix.to(dtype), x], dim=1)
            pm = model_lib.pad_mask(cfg, device=x.device)
            y, new_caches = pipeline_prefill_chunked(
                mesh, cfg, params["blocks"], x, caches, pm,
                seq_chunks=seq_chunks, window=window or cfg.sliding_window)
            yn = modules.rmsnorm(params["final_norm"], y[:, -1:, :],
                                 cfg.norm_eps)
            logits = loss_lib.lm_head_logits(mesh, params["head"]["w"], yn,
                                             vocab_size=cfg.vocab_size)
            return logits, new_caches

        return prefill_chunked

    def prefill_step(params, batch):
        dtype = modules.dtype_of(cfg.dtype)
        if cfg.family == "audio":
            xe = _encode(mesh, cfg, params, batch["frames"], dtype,
                         num_microbatches, remat=False)
            x = _decoder_input(params, cfg, batch["tokens"], dtype, mesh)
            y, _ = pipeline_forward(mesh, cfg, params["dec_blocks"], x,
                                    _decoder_pad_mask(cfg, x.device),
                                    layout=cfg.decoder_slot_layout,
                                    kv_source=xe, remat=False,
                                    num_microbatches=num_microbatches)
        else:
            x = loss_lib.embed_tokens(mesh, params["embed"]["table"],
                                      batch["tokens"], dtype)
            if "prefix" in batch:
                prefix = torch.as_tensor(batch["prefix"], device=x.device)
                x = torch.cat([prefix.to(dtype), x], dim=1)
            pm = model_lib.pad_mask(cfg, device=x.device)
            y, _ = pipeline_forward(mesh, cfg, params["blocks"], x, pm,
                                    num_microbatches=num_microbatches,
                                    window=window or cfg.sliding_window,
                                    remat=False)
        yn = _final_norm(params, cfg, y[:, -1:, :])
        return loss_lib.lm_head_logits(mesh, params["head"]["w"], yn,
                                       vocab_size=cfg.vocab_size)

    return prefill_step


def make_serve_step(mesh, cfg: ModelConfig, *, window: int = 0,
                    data_sharded=True, num_microbatches: int = 0):
    dtype = modules.dtype_of(cfg.dtype)
    audio = cfg.family == "audio"
    layout = cfg.decoder_slot_layout if audio else cfg.slot_layout

    def serve_step(params, token, caches, pos, kv_source=None):
        table = params["embed"]["table"]
        x = loss_lib.embed_tokens(mesh, table, token, dtype,
                                  data_sharded=data_sharded)
        pos_t = _as_position(pos, x.device)
        if audio:
            pos_table = modules.sinusoidal_positions(
                max(cfg.max_target_positions, 2), cfg.d_model, x.device)
            # index_select, not [pos]: a 0-d index tensor is read on the
            # host (a sync on CUDA, and no value at all on meta)
            row = pos_table.index_select(
                0, torch.clamp(pos_t, max=pos_table.shape[0] - 1)
                .long().reshape(1))
            x = x + row[None].to(dtype)
        pm = model_lib.pad_mask(
            cfg, model_lib.decoder_assignment(cfg) if audio else None,
            layout, device=x.device)
        y, new_caches = pipeline_decode(
            mesh, cfg, params["dec_blocks"] if audio else params["blocks"],
            x, caches, pos_t, pm, layout=layout,
            window=window or cfg.sliding_window, kv_source=kv_source,
            data_sharded=data_sharded, num_microbatches=num_microbatches)
        yn = _final_norm(params, cfg, y)
        logits = loss_lib.lm_head_logits(mesh, params["head"]["w"], yn,
                                         data_sharded=data_sharded,
                                         vocab_size=cfg.vocab_size)
        return logits, new_caches

    return serve_step
