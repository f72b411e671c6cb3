"""The pipeline-parallel execution engine, on one device or on ranks.

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

On ranks (a ``launch/mesh.RankMesh``: one process a mesh position, see
"on ranks" below) the loop over stages and the hand-off are what change:
each rank runs its own stage's microbatches in the same order, the
hand-off is a send/recv to the next stage's rank, the tensor axis is a
process group (``TP.of(mesh)``), the embedding and head are
vocab-parallel (``losses.py``), and each rank holds its shards of the
params and caches (``sharding.shard_params``, ``shard_caches``).

Decode: the same schedule with one token per microbatch and per-stage
KV/SSM caches. No tensor passed in (params, caches, state) is written:
every result is a new tensor, as with JAX's immutable arrays.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives, obs, tree
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch.mesh import DATA_AXES, ranked
from repro_torch.models import model as model_lib
from repro_torch.models import modules
from repro_torch.models.blocks import BLOCKS, BlockCtx
from repro_torch.models.tp import TP
from repro_torch.pipeline import losses as loss_lib
from repro_torch.pipeline.sharding import (AXIS_STAGE, AXIS_TENSOR,
                                           data_axes, param_shardings)


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


def _microbatches(B_l: int, num_microbatches: int, default: int) -> int:
    """The JAX engine's microbatch count: ``num_microbatches`` (else
    ``default``), at most the shard's rows, lowered until it divides
    them."""
    M = min(num_microbatches or default, B_l)
    while B_l % M:
        M -= 1
    return M


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
    unroll). On a ``RankMesh`` x and kv_source are the rank's rows, y
    comes back on every stage, and no gradient crosses ranks (training
    runs through ``make_train_step``)."""
    if ranked(mesh):
        return _rank_forward(mesh, cfg, blocks, x, pad_mask, layout=layout,
                             num_microbatches=num_microbatches,
                             causal=causal, window=window,
                             kv_source=kv_source, dtype=dtype)
    _check_mesh(mesh, cfg)
    layout = tuple(layout or cfg.slot_layout)
    S = cfg.pipeline_stages
    dtype = dtype or modules.dtype_of(cfg.dtype)
    B, seq, d = x.shape
    shards = _shard_rows(mesh, B, data_sharded)
    B_l = shards[0].stop - shards[0].start
    M = _microbatches(B_l, num_microbatches, B_l)
    mb = B_l // M
    dev = x.device
    slots = _stage_slots(blocks, S)
    positions = torch.arange(seq, dtype=torch.int32, device=dev).expand(
        mb, seq)

    def stage_fn(s, xin, kv_in):
        with obs.span("engine.stage", device=dev):
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
    written. On a ``RankMesh`` x and kv_source are the rank's rows, the
    caches its shards, and y comes back on every stage.
    """
    if ranked(mesh):
        return _rank_decode(mesh, cfg, blocks, x, caches, pos, pad_mask,
                            layout=layout, num_microbatches=num_microbatches,
                            window=window, kv_source=kv_source, dtype=dtype)
    _check_mesh(mesh, cfg)
    layout = tuple(layout or cfg.slot_layout)
    S = cfg.pipeline_stages
    dtype = dtype or modules.dtype_of(cfg.dtype)
    B, _, d = x.shape
    shards = _shard_rows(mesh, B, data_sharded)
    B_l = shards[0].stop - shards[0].start
    M = _microbatches(B_l, num_microbatches, min(B_l, S))
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
    not written. On a ``RankMesh`` x is the rank's rows, the caches its
    shards, and y comes back on every stage.
    """
    if ranked(mesh):
        return _rank_prefill_chunked(mesh, cfg, blocks, x, caches, pad_mask,
                                     seq_chunks=seq_chunks, layout=layout,
                                     window=window, dtype=dtype)
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

def _blend_leaf(n, s, first: int, S: int):
    """One leaf of ``_stage_window_blend``, written into ``n`` (the step's
    own new params, which nothing else holds) a stage at a time: each
    stage's ``a * new + (1 - a) * stash`` in f32, rounded once to n's
    dtype, as whole-leaf tensors would give it bit for bit. In place and
    by stage because the blend runs at the step's memory peak (old and new
    params, stash and moments all live), where olmoe-1b-7b-4l's 2 GiB
    expert leaves found no hole for whole-leaf temporaries."""
    for i in range(n.shape[0]):
        a = 0.5 if first + i < S - 1 else 1.0
        torch.add(a * n[i].to(torch.float32),
                  (1 - a) * s[i].to(torch.float32), out=n[i])
    return n


def _stage_window_blend(mesh, cfg, new_blocks, stash_blocks, old_blocks):
    """Paper weight aggregation mapped onto the depth-2 stash: stages with
    n - i >= 2 live versions average (new, stash); the last stage keeps new.
    Leaves carry a leading stage axis: every stage's on one device, the
    rank's own stage (length 1) on a ``RankMesh``. Writes the blend into
    ``new_blocks``' leaves and returns them, so it raises where a leaf of
    ``new_blocks`` shares memory with one of the stash or of the step's
    input params (``old_blocks``): an optimizer that hands back its input
    would otherwise have the blend overwrite the state the step was
    given."""
    held = {t.untyped_storage().data_ptr()
            for t in tree.leaves(stash_blocks) + tree.leaves(old_blocks)}
    if any(n.numel() and n.untyped_storage().data_ptr() in held
           for n in tree.leaves(new_blocks)):
        raise RuntimeError("the blend writes into the new params, and a "
                           "leaf of them shares memory with the stash or "
                           "the step's input params")
    S = cfg.pipeline_stages
    first = mesh.coords[AXIS_STAGE] if ranked(mesh) else 0
    return tree.map(lambda n, s: _blend_leaf(n, s, first, S), new_blocks,
                    stash_blocks)


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


def _head_loss(mesh, cfg, params, y, labels, mask):
    """The final norm, the head and the cross-entropy, recorded as the
    span ``head`` with its backward (``obs.py``)."""
    y = obs.grad_mark(y, "head", "in")
    with obs.span("head", device=y.device):
        yn = _final_norm(params, cfg, y)
        labels = torch.as_tensor(labels, device=yn.device)
        if labels.shape[1] < yn.shape[1]:       # vlm prefix: no loss there
            pad = yn.shape[1] - labels.shape[1]
            labels = torch.cat([torch.zeros((labels.shape[0], pad),
                                            dtype=labels.dtype,
                                            device=labels.device), labels],
                               dim=1)
        loss = loss_lib.lm_head_loss(mesh, params["head"]["w"], yn, labels,
                                     mask, vocab_size=cfg.vocab_size)
    return obs.grad_mark(loss, "head", "out")


def make_loss_fn(mesh, cfg: ModelConfig, *, num_microbatches=0, remat=True,
                 window: int = 0, unroll=False):
    """(params, batch) -> (total, {"loss", "aux"}), and
    ``loss_fn.value_and_grad(params, batch)`` -> (total, metrics, the
    gradient tree). On a ``RankMesh`` params are the rank's shards and the
    batch the global one; ``loss_fn`` runs without gradient, and the
    gradients are the rank's shards."""
    def loss_fn(params, batch):
        dtype = modules.dtype_of(cfg.dtype)
        if ranked(mesh):
            batch = _rank_batch(mesh, batch)
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
        loss = _head_loss(mesh, cfg, params, y, batch["labels"], mask)
        total = loss + cfg.router_aux_weight * aux
        return total, {"loss": loss, "aux": aux}

    loss_fn.value_and_grad = (_rank_value_and_grad(
        mesh, cfg, num_microbatches=num_microbatches, remat=remat,
        window=window) if ranked(mesh) else _value_and_grad(loss_fn))
    return loss_fn


def _value_and_grad(loss_fn):
    """(params, batch) -> (total, metrics, gradient tree) on one device:
    gradients on detached leaves, so the params' own tensors (shared with
    the stash after ``init_state``) are never marked."""
    def value_and_grad(params, batch):
        leaves, paths = tree.flatten(params)
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        with torch.enable_grad():
            total, metrics = loss_fn(tree.unflatten(paths, live), batch)
            grads = torch.autograd.grad(total, live, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, live)]
        return total, metrics, tree.unflatten(paths, grads)

    return value_and_grad


def make_train_step(mesh, cfg: ModelConfig, tc: TrainConfig, *,
                    window: int = 0):
    """Returns (train_step, loss_fn). State: {params, stash, opt_state, step}.

    Forward/backward run on the STASHED weights (one step stale, PipeDream-2BW
    adaptation of weight stashing); the update lands on the newest weights;
    aggregation blends per-stage version windows (paper §III-C). A step
    builds a new state and leaves every tensor of the one passed in as it
    was (``init_state`` puts the same tensors in params and stash). On a
    ``RankMesh`` the state holds the rank's shards (``shard_params``), the
    batch is the global one, and each rank updates its own shards; the
    step count and the blend are the same on every rank."""
    from repro_torch.optim import get_optimizer
    opt_init, opt_update = get_optimizer(tc.optimizer)
    loss_fn = make_loss_fn(mesh, cfg, num_microbatches=tc.microbatches,
                           remat=tc.remat, window=window)
    agg_every = cfg.aggregate_every

    def train_step(state, batch):
        with obs.unit("engine.train_step"):
            return _train_step(state, batch)

    def _train_step(state, batch):
        total, metrics, grads = loss_fn.value_and_grad(state["stash"], batch)
        del total
        if tc.bf16_grads:
            # the JAX package casts before its data-parallel all-reduce
            # (on ranks the sum over data is taken in f32 first)
            grads = tree.map(lambda g: g.to(torch.bfloat16), grads)
        kw = dict(lr=tc.learning_rate, weight_decay=tc.weight_decay)
        if tc.optimizer == "sgd":
            kw["momentum"] = tc.momentum
        dev = state["step"].device
        with obs.span("engine.optimizer", device=dev):
            new_params, new_opt = opt_update(state["params"], grads,
                                             state["opt_state"], **kw)
        del grads
        step = state["step"] + 1
        # a meta step has no value (launch/dryrun.py): its blend, work a
        # FLOP count does not see, is left out there
        if agg_every and not step.is_meta and int(step) % agg_every == 0:
            new_params = dict(new_params)
            with obs.span("engine.blend", device=dev):
                for key in ("blocks", "dec_blocks"):
                    if key in new_params:
                        new_params[key] = _stage_window_blend(
                            mesh, cfg, new_params[key], state["stash"][key],
                            state["params"][key])
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
    caches as a side effect: the production prefill path). On a
    ``RankMesh`` params and caches are the rank's shards, the batch and
    the logits the global ones (every rank holds them whole)."""
    if seq_chunks > 1:
        if cfg.family == "audio" or not set(cfg.slot_layout) <= CHUNKABLE:
            raise ValueError(f"{cfg.name}: chunked prefill needs a "
                             f"non-audio layout of {sorted(CHUNKABLE)}, got "
                             f"{cfg.slot_layout}")

        def prefill_chunked(params, batch, caches):
            dtype = modules.dtype_of(cfg.dtype)
            if ranked(mesh):
                batch = _rank_batch(mesh, batch)
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
            return _all_rows(mesh, logits), new_caches

        return prefill_chunked

    def prefill_step(params, batch):
        with obs.unit("engine.prefill"):
            return _prefill_step(params, batch)

    def _prefill_step(params, batch):
        dtype = modules.dtype_of(cfg.dtype)
        if ranked(mesh):
            batch = _rank_batch(mesh, batch)
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
        return _all_rows(mesh, loss_lib.lm_head_logits(
            mesh, params["head"]["w"], yn, vocab_size=cfg.vocab_size))

    return prefill_step


def make_serve_step(mesh, cfg: ModelConfig, *, window: int = 0,
                    data_sharded=True, num_microbatches: int = 0):
    """(params, token [B, 1], caches, pos, kv_source=None) -> (logits, new
    caches). On a ``RankMesh`` params and caches are the rank's shards,
    token, kv_source and the logits the global batch's (every rank holds
    the logits whole)."""
    dtype = modules.dtype_of(cfg.dtype)
    audio = cfg.family == "audio"
    layout = cfg.decoder_slot_layout if audio else cfg.slot_layout

    def serve_step(params, token, caches, pos, kv_source=None):
        table = params["embed"]["table"]
        if ranked(mesh):      # the rank's rows of the global batch
            rows = _rank_rows(mesh, token.shape[0], data_sharded)
            token = token[rows]
            kv_source = None if kv_source is None else kv_source[rows]
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
        return (_all_rows(mesh, logits) if data_sharded else logits,
                new_caches)

    return serve_step


# ================================ on ranks ================================
#
# One process a mesh position (``launch/mesh.RankMesh``). Rank (s, t, d)
# holds stage s's slots (stacked leaves with a local stage axis of 1),
# tensor shard t of them, vocab shard s*T + t of the embedding and head,
# and data shard d's batch rows. The step functions take the global batch
# (as a JAX global array) and cut the rank's rows; caches are the rank's
# own shards; logits come back whole (every row, the whole vocab).
#
# The stage's microbatches run in order, as the JAX engine's valid ticks
# of that stage do; the hand-off is a send to the next stage's rank and a
# blocking receive there, so the ticks keep themselves in step. Every
# rank of a tensor group runs the same operations in the same order, so
# the collectives inside the blocks meet.
#
# Training runs as phases that every rank enters in the same order: the
# embedding (a vocab-parallel psum), the stage's forward, the loss (the
# last stage's output broadcast to every stage for the vocab-parallel
# head), then backward: the loss, the stage's microbatches in reverse
# (the cotangent received from the next stage, the input's sent to the
# previous one), and the embedding. The backward differentiates the sum
# over ranks of what each computes (``collectives.py``), so each rank's
# loss is seeded with 1 / (number of ranks) and a leaf's gradient is
# summed over the mesh axes its shard is replicated over: the data axes
# for every leaf (the JAX engine's psum over data), the tensor axis for
# norms and replicated kv weights, every axis for the final norm.


def _rank_rows(mesh, B: int, data_sharded: bool = True) -> slice:
    """The batch rows this rank's data shard holds."""
    shards = _shard_rows(mesh, B, data_sharded)
    return shards[mesh.index(DATA_AXES) if data_sharded else 0]


def _all_rows(mesh, logits):
    """Logits of every data shard's rows, on every rank (the identity on
    one device)."""
    if not ranked(mesh):
        return logits
    return collectives.gather(logits, mesh.group(DATA_AXES), 0)


def _rank_batch(mesh, batch):
    """The rank's rows of every entry of a global batch."""
    B = len(next(iter(batch.values())))
    rows = _rank_rows(mesh, B)
    return {k: v[rows] for k, v in batch.items()}


class _RankStage:
    """This rank's stage of one pipeline pass: its slots, its neighbours
    on the stage axis and the tensor context of its blocks."""

    def __init__(self, mesh, cfg: ModelConfig, blocks, pad_mask,
                 layout=None, dtype=None):
        _check_mesh(mesh, cfg)
        self.cfg = cfg
        self.dtype = dtype or modules.dtype_of(cfg.dtype)
        self.layout = tuple(layout or cfg.slot_layout)
        self.s = mesh.coords[AXIS_STAGE]
        self.S = mesh.shape[AXIS_STAGE]
        self.first, self.last = self.s == 0, self.s == self.S - 1
        self.prev = None if self.first else mesh.rank_at(stage=self.s - 1)
        self.next = None if self.last else mesh.rank_at(stage=self.s + 1)
        self.src_last = mesh.rank_at(stage=self.S - 1)
        self.stage_group = mesh.group((AXIS_STAGE,))
        self.slots = [tree.map(lambda a: a[0], slot) for slot in blocks]
        self.pads = pad_mask[self.s]
        self.tp = TP.of(mesh)

    def to_every_stage(self, y, like):
        """The last stage's ``y`` on every stage (``y_all[S - 1]``); no
        gradient. ``like`` gives the shape elsewhere."""
        return collectives.broadcast(y if self.last else like, self.src_last,
                                     self.stage_group)


class _RankPass:
    """A full-sequence pass (``pipeline_forward``) of this rank's stage,
    kept for ``backward`` when ``grad``: per microbatch, the input (a leaf
    on stages > 0), the output and the aux."""

    def __init__(self, stage: _RankStage, *, num_microbatches, causal,
                 window, remat):
        self.st = stage
        self.num_microbatches = num_microbatches
        self.causal, self.window, self.remat = causal, window, remat

    def forward(self, x, kv_source=None, grad=False):
        """x: the rank's rows [B_l, seq, d] (read on stage 0 only; its
        shape sets the microbatches). Returns (y [B_l, seq, d] on the last
        stage, else None; aux: the stage's aux summed over its
        microbatches over M)."""
        st, cfg, dtype = self.st, self.st.cfg, self.st.dtype
        B_l, seq, d = x.shape
        M = _microbatches(B_l, self.num_microbatches, B_l)
        mb = B_l // M
        self.M, self.mb = M, mb
        dev = x.device
        positions = torch.arange(seq, dtype=torch.int32, device=dev).expand(
            mb, seq)

        def stage_fn(xin, kv_in):
            with obs.span("engine.stage", device=dev):
                aux = torch.zeros((), dtype=torch.float32, device=dev)
                xx = xin
                for j, t in enumerate(st.layout):
                    ctx = BlockCtx(cfg=cfg, positions=positions, tp=st.tp,
                                   dtype=dtype, causal=self.causal,
                                   window=self.window, kv_source=kv_in,
                                   active=st.pads[j])
                    xx, a = BLOCKS[t].apply(st.slots[j], xx, ctx)
                    aux = aux + a
                return xx, aux

        def run_stage(xin, kv_in):
            if self.remat and grad:
                return checkpoint(stage_fn, xin, kv_in, use_reentrant=False)
            return stage_fn(xin, kv_in)

        x_mb = x.reshape(M, mb, seq, d).to(dtype)
        kv_mb = (None if kv_source is None else
                 kv_source.reshape(M, mb, *kv_source.shape[1:]).to(dtype))
        like = torch.empty((mb, seq, d), dtype=dtype, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        self.records, ys, pending = [], [], []
        with torch.set_grad_enabled(grad):
            for idx in range(M):
                if st.first:
                    xin = x_mb[idx]
                else:
                    xin = collectives.recv(like, st.prev).requires_grad_(grad)
                y, a = run_stage(xin, None if kv_mb is None else kv_mb[idx])
                aux = aux + a
                out = y.to(dtype)
                if st.last:
                    ys.append(out)
                else:
                    pending.append(collectives.send(out, st.next))
                if grad:
                    self.records.append((xin, out, a))
            collectives.wait_all(pending)
        y = torch.cat(ys).reshape(B_l, seq, d) if st.last else None
        return y, aux / M

    def backward(self, dy, daux):
        """The stage's microbatches in reverse: the cotangent of each
        output (``dy``'s rows on the last stage, else received from the
        next stage), the aux's ``daux / M``; the input's cotangent sent to
        the previous stage. Gradients accumulate in the leaves' ``.grad``
        (the params, and on stage 0 the ``x`` the pass read)."""
        st, M, mb = self.st, self.M, self.mb
        pending = []
        for idx in reversed(range(M)):
            xin, out, a = self.records[idx]
            g = (dy[idx * mb:(idx + 1) * mb] if st.last
                 else collectives.recv(out, st.next))
            outs, grads = [out], [g]
            if daux is not None and a.requires_grad:
                outs.append(a)
                grads.append(daux / M)
            torch.autograd.backward(outs, grads)
            if not st.first:
                pending.append(collectives.send(
                    torch.zeros_like(xin) if xin.grad is None else xin.grad,
                    st.prev))
        collectives.wait_all(pending)
        self.records = []


def _rank_combine_aux(mesh, aux):
    """The sum over stages of the mean over data shards of the stages'
    aux (the JAX engine's ``sum(mean(aux_all, axis=1))``)."""
    data = collectives.psum(aux, mesh.group(DATA_AXES)) / mesh.size(
        DATA_AXES)
    return collectives.psum(data, mesh.group((AXIS_STAGE,)))


def _rank_forward(mesh, cfg, blocks, x, pad_mask, *, layout=None,
                  num_microbatches=0, causal=True, window=0,
                  kv_source=None, dtype=None):
    """``pipeline_forward`` on a rank, without gradient: x and kv_source
    are the rank's rows; returns (y on every stage, the combined aux)."""
    st = _RankStage(mesh, cfg, blocks, pad_mask, layout, dtype)
    run = _RankPass(st, num_microbatches=num_microbatches, causal=causal,
                    window=window, remat=False)
    with torch.no_grad():
        y, aux = run.forward(x, kv_source)
        y = st.to_every_stage(y, x.to(st.dtype))
        return y, _rank_combine_aux(mesh, aux)


def _rank_decode(mesh, cfg, blocks, x, caches, pos, pad_mask, *,
                 layout=None, num_microbatches=0, window=0, kv_source=None,
                 dtype=None):
    """``pipeline_decode`` on a rank: x [B_l, 1, d] and kv_source are the
    rank's rows, caches the rank's shards (a local stage axis of 1).
    Returns (y on every stage, new caches)."""
    st = _RankStage(mesh, cfg, blocks, pad_mask, layout, dtype)
    B_l, _, d = x.shape
    M = _microbatches(B_l, num_microbatches, min(B_l, st.S))
    mb = B_l // M
    pos_t = _as_position(pos, x.device)
    x_mb = x.reshape(M, mb, 1, d).to(st.dtype)
    like = torch.empty((mb, 1, d), dtype=st.dtype, device=x.device)
    ys, parts, pending = [], [], []
    with torch.no_grad():
        for idx in range(M):
            r = slice(idx * mb, (idx + 1) * mb)
            cin = [tree.map(lambda a: a[0, r], c) for c in caches]
            kv_in = None if kv_source is None else kv_source[r].to(st.dtype)
            xx = x_mb[idx] if st.first else collectives.recv(like, st.prev)
            cout = []
            for j, t in enumerate(st.layout):
                ctx = BlockCtx(cfg=cfg, pos=pos_t, tp=st.tp, dtype=st.dtype,
                               window=window, kv_source=kv_in,
                               active=st.pads[j])
                xx, c = BLOCKS[t].step(st.slots[j], xx, cin[j], ctx)
                cout.append(c)
            parts.append(cout)
            out = xx.to(st.dtype)
            if st.last:
                ys.append(out)
            else:
                pending.append(collectives.send(out, st.next))
        collectives.wait_all(pending)
        new_caches = _stacked([_cat_rows(parts)], caches)
        y = st.to_every_stage(torch.cat(ys) if st.last else None,
                              x.to(st.dtype))
    return y, new_caches


def _rank_prefill_chunked(mesh, cfg, blocks, x, caches, pad_mask, *,
                          seq_chunks, layout=None, window=0, dtype=None):
    """``pipeline_prefill_chunked`` on a rank: x [B_l, S_total, d] the
    rank's rows, caches its shards. Returns (the last chunk's y on every
    stage, new caches)."""
    st = _RankStage(mesh, cfg, blocks, pad_mask, layout, dtype)
    B_l, S_total, d = x.shape
    M = seq_chunks
    if S_total % M:
        raise ValueError(f"sequence {S_total} does not split into {M} "
                         f"chunks")
    L = S_total // M
    x_rows = x.to(st.dtype)
    like = torch.empty((B_l, L, d), dtype=st.dtype, device=x.device)
    cur = [tree.map(lambda a: a[0], c) for c in caches]
    y_last, pending = None, []
    with torch.no_grad():
        for idx in range(M):
            xx = (x_rows[:, idx * L:(idx + 1) * L] if st.first
                  else collectives.recv(like, st.prev))
            cout = []
            for j, t in enumerate(st.layout):
                ctx = BlockCtx(cfg=cfg, pos=idx * L, tp=st.tp,
                               dtype=st.dtype, window=window,
                               active=st.pads[j])
                xx, c = BLOCKS[t].prefill_chunk(st.slots[j], xx, cur[j], ctx)
                cout.append(c)
            cur = cout
            out = xx.to(st.dtype)
            if not st.last:
                pending.append(collectives.send(out, st.next))
            elif idx == M - 1:
                y_last = out
        collectives.wait_all(pending)
        y = st.to_every_stage(y_last, like)
    return y, _stacked([cur], caches)


def _reduce_replicated(mesh, cfg, grads):
    """Each leaf's gradient summed over the mesh axes its shard is
    replicated over: the data axes together, then the model axes (stage,
    tensor) it is not split over."""
    shardings = tree.leaves(param_shardings(mesh, cfg))
    out = []
    for g, sh in zip(grads, shardings):
        rep = sh.replicated_over()
        for axes in ([a for a in rep if a in DATA_AXES],
                     [a for a in rep if a not in DATA_AXES]):
            if mesh.size(axes) > 1:
                g = collectives.all_reduce(g, mesh.group(axes))
        out.append(g)
    return out


def _rank_value_and_grad(mesh, cfg: ModelConfig, *, num_microbatches=0,
                         remat=True, window: int = 0):
    """(params, batch) -> (total, metrics, gradient leaves) on a rank:
    ``params`` the rank's shards, ``batch`` the global batch. The
    gradients are the rank's shards of the JAX engine's."""
    world = math.prod(mesh.shape.values())
    audio = cfg.family == "audio"

    def pipe(stage, remat_, causal=True, window_=0):
        return _RankPass(stage, num_microbatches=num_microbatches,
                         causal=causal, window=window_, remat=remat_)

    def value_and_grad(params, batch):
        dtype = modules.dtype_of(cfg.dtype)
        leaves, paths = tree.flatten(params)
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        p = tree.unflatten(paths, live)
        table = p["embed"]["table"]
        dev = table.device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        rows = _rank_rows(mesh, tokens.shape[0])
        tokens = tokens[rows]
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
        with torch.enable_grad():
            enc = None
            if audio:
                frames = torch.as_tensor(batch["frames"], device=dev)[rows]
                xe0, _ = model_lib.embed_frames(cfg, frames, dtype)
                enc_st = _RankStage(mesh, cfg, p["blocks"],
                                    model_lib.pad_mask(cfg, device=dev),
                                    cfg.slot_layout, dtype)
                enc = pipe(enc_st, remat, causal=False)
                ye, _ = enc.forward(xe0, grad=True)
                ye_leaf = (ye.detach() if enc_st.last else
                           torch.empty_like(xe0.to(dtype))).requires_grad_()
                xe = collectives.broadcast_grad(ye_leaf, enc_st.src_last,
                                                enc_st.stage_group)
                kv = xe.detach().requires_grad_()
                x_emb = _decoder_input(p, cfg, tokens, dtype, mesh)
                st = _RankStage(mesh, cfg, p["dec_blocks"],
                                _decoder_pad_mask(cfg, dev),
                                cfg.decoder_slot_layout, dtype)
                run = pipe(st, remat)
            else:
                kv = None
                x_emb = loss_lib.embed_tokens(mesh, table, tokens, dtype)
                if "prefix" in batch:
                    prefix = torch.as_tensor(batch["prefix"],
                                             device=dev)[rows]
                    x_emb = torch.cat([prefix.to(dtype), x_emb], dim=1)
                    mask = torch.cat([torch.zeros(
                        prefix.shape[:2], dtype=torch.float32, device=dev),
                        mask], dim=1)
                st = _RankStage(mesh, cfg, p["blocks"],
                                model_lib.pad_mask(cfg, device=dev),
                                cfg.slot_layout, dtype)
                run = pipe(st, remat, window_=window or cfg.sliding_window)
            x_in = x_emb.detach().requires_grad_()
            y, aux_r = run.forward(x_in, kv, grad=True)

            # the loss: the last stage's y on every stage, the head
            like = x_in.to(dtype)
            y_leaf = (y.detach() if st.last
                      else torch.empty_like(like)).requires_grad_()
            y_all = collectives.broadcast_grad(y_leaf, st.src_last,
                                               st.stage_group)
            aux_leaf = aux_r.detach().requires_grad_(aux_r.requires_grad)
            aux = _rank_combine_aux(mesh, aux_leaf)
            loss = _head_loss(
                mesh, cfg, p, y_all,
                torch.as_tensor(batch["labels"], device=dev)[rows], mask)
            total = loss + cfg.router_aux_weight * aux
            torch.autograd.backward(total, torch.full_like(total,
                                                           1.0 / world))

            # the pipeline, then the embedding (every rank takes part)
            run.backward(y_leaf.grad if st.last else None, aux_leaf.grad)
            dx = torch.zeros_like(x_in) if x_in.grad is None else x_in.grad
            torch.autograd.backward(x_emb, dx)
            if audio:
                dkv = torch.zeros_like(kv) if kv.grad is None else kv.grad
                torch.autograd.backward(xe, dkv)
                enc.backward(ye_leaf.grad if enc_st.last else None, None)
        grads = [torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
                 for leaf in live]
        del live
        grads = _reduce_replicated(mesh, cfg, grads)
        return (total.detach(), {"loss": loss.detach(), "aux": aux.detach()},
                tree.unflatten(paths, grads))

    return value_and_grad
