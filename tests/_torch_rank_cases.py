"""What ``tests/test_torch_ranks.py`` runs on each rank of a
``repro_torch.pipeline.ranks.RankPool``.

The ranks are spawned processes: this module imports torch, numpy and
the port only, never JAX (each function reports whether JAX got loaded).
Arguments and results are numpy arrays and plain Python values: the
whole numpy params in the JAX package's layout go in, and each rank cuts
its own shards (``sharding.shard_params``).
"""
import sys

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import VOCAB_AXES, make_debug_mesh
from repro_torch.models import model as M
from repro_torch.pipeline import losses
from repro_torch.pipeline import pipeline_step as ps
from repro_torch.pipeline.sharding import shard_caches, shard_params

_MESHES = {}


def mesh_of(shape):
    """This rank's ``RankMesh`` of ``shape`` (made once a process: its
    process groups are made by every rank together)."""
    if shape not in _MESHES:
        _MESHES[shape] = make_debug_mesh(*shape, device="cpu")
    return _MESHES[shape]


def _numpy(t):
    return tree.map(lambda a: a.detach().numpy(), t)


def _setup(arch, cfg_kw, shape, np_params):
    cfg = get_config(arch).reduced(**cfg_kw)
    mesh = mesh_of(tuple(shape))
    return cfg, mesh, shard_params(M.params_from_numpy(np_params), mesh, cfg)


def loss_and_grads(arch, cfg_kw, shape, np_params, batch, m, remat=True):
    """The rank engine's loss, aux and the rank's gradient shards, and
    the total of the loss function run forward only."""
    cfg, mesh, local = _setup(arch, cfg_kw, shape, np_params)
    fn = ps.make_loss_fn(mesh, cfg, num_microbatches=m, remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics, grads = fn.value_and_grad(local, batch)
    with torch.no_grad():
        forward_only = float(fn(local, batch)[0])
    return {"total": float(total), "loss": float(metrics["loss"]),
            "aux": float(metrics["aux"]), "grads": _numpy(grads),
            "forward_only": forward_only, "jax": "jax" in sys.modules}


def train_states(arch, cfg_kw, shape, np_params, batches, tc_kw):
    """``len(batches)`` train steps of the rank engine from the numpy
    params: after each step the rank's shards of the state (params,
    stash, optimizer state, step) and the metrics."""
    from repro_torch.configs import TrainConfig
    cfg, mesh, local = _setup(arch, cfg_kw, shape, np_params)
    step_fn, _ = ps.make_train_step(mesh, cfg, TrainConfig(**tc_kw))
    state = step_fn.init_state(local)
    out = []
    for b in batches:
        state, m = step_fn(state, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        out.append({"state": _numpy(state), "loss": float(m["loss"]),
                    "aux": float(m["aux"])})
    return {"steps": out, "jax": "jax" in sys.modules}


def prefill_chunked(arch, cfg_kw, shape, np_params, tokens, chunks):
    """Chunked prefill from zero f32 caches: the rank's logits rows and
    cache shards."""
    cfg, mesh, local = _setup(arch, cfg_kw, shape, np_params)
    B, S = tokens.shape
    caches = shard_caches(M.init_caches(cfg, batch=B, cache_len=S,
                                        dtype=torch.float32, device="cpu"),
                          mesh, cfg)
    logits, new = ps.make_prefill_step(mesh, cfg, seq_chunks=chunks)(
        local, {"tokens": torch.from_numpy(tokens)}, caches)
    return {"logits": logits.numpy(), "caches": _numpy(new),
            "jax": "jax" in sys.modules}


def decode(arch, cfg_kw, shape, np_params, tokens, cache_len, m):
    """``tokens.shape[1]`` decode steps from zero f32 caches: the rank's
    logits rows at every step and its cache shards at the end."""
    cfg, mesh, local = _setup(arch, cfg_kw, shape, np_params)
    B, T = tokens.shape
    caches = shard_caches(M.init_caches(cfg, batch=B, cache_len=cache_len,
                                        dtype=torch.float32, device="cpu"),
                          mesh, cfg)
    serve = ps.make_serve_step(mesh, cfg, num_microbatches=m)
    out = []
    for t in range(T):
        lg, caches = serve(local, torch.from_numpy(tokens[:, t:t + 1]),
                           caches, t)
        out.append(lg.numpy())
    return {"logits": out, "caches": _numpy(caches),
            "jax": "jax" in sys.modules}


def vocab_head(shape, table, w, y, toks, mask, vocab_size, z_weight):
    """``embed_tokens``, ``lm_head_loss`` and ``lm_head_logits`` on the
    rank's vocab shard of ``table`` / ``w`` and batch rows of the rest."""
    mesh = mesh_of(tuple(shape))
    n, i = mesh.size(VOCAB_AXES), mesh.index(VOCAB_AXES)
    V_l = table.shape[0] // n
    vr = slice(i * V_l, (i + 1) * V_l)
    rows = ps._rank_rows(mesh, toks.shape[0])
    t = torch.from_numpy
    e = losses.embed_tokens(mesh, t(table[vr]), t(toks[rows]),
                            torch.float32)
    loss = losses.lm_head_loss(mesh, t(w[:, vr]), t(y[rows]), t(toks[rows]),
                               t(mask[rows]), vocab_size=vocab_size,
                               z_weight=z_weight)
    logits = losses.lm_head_logits(mesh, t(w[:, vr]), t(y[rows]),
                                   vocab_size=vocab_size)
    return {"embed": e.numpy(), "loss": float(loss),
            "logits": logits.numpy(), "jax": "jax" in sys.modules}


def local_shapes(arch, cfg_kw, shape, np_params):
    """The shapes of the rank's shards (no computation)."""
    _, _, local = _setup(arch, cfg_kw, shape, np_params)
    return [tuple(a.shape) for a in tree.leaves(local)]


def rank_sum(x):
    """A sum over the world of ``x`` times (rank + 1)."""
    import torch.distributed as dist
    v = torch.tensor([float(x) * (dist.get_rank() + 1)])
    dist.all_reduce(v)
    return float(v)


def fail_on(rank, message):
    """Raise on ``rank`` while the others wait in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise ValueError(message)
    dist.all_reduce(torch.ones(1))
    return np.zeros(1)


def die(rank):
    """``rank``'s process exits at once, without an answer."""
    import os

    import torch.distributed as dist
    if dist.get_rank() == rank:
        os._exit(3)
    dist.all_reduce(torch.ones(1))
    return 0


def sleep(seconds):
    import time
    time.sleep(seconds)
    return 0


def train_bit_for_bit(arch, cfg_kw, steps, lr):
    """On a one-rank world: ``steps`` Adam steps of the rank engine and of
    the folded engine on the same (1, 1, 1) config and batches, in this
    process. Returns the losses of both and whether every leaf of the
    final states is equal bit for bit."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_config(arch).reduced(**cfg_kw)
    tc = TrainConfig(learning_rate=lr, optimizer="adam", microbatches=4,
                     weight_decay=0.0)
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)), "labels":
        torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                         .astype(np.int32))} for _ in range(steps)]
    out = {}
    for name, mesh in (("rank", mesh_of((1, 1, 1))),
                       ("folded", make_local_mesh(
                           (1, 1, 1), ("data", "stage", "tensor"), "cpu"))):
        p = M.init_params(0, cfg, device="cpu")
        if name == "rank":
            p = shard_params(p, mesh, cfg)
        step, _ = ps.make_train_step(mesh, cfg, tc)
        state = step.init_state(p)
        losses = []
        for b in batches:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        out[name] = (losses, tree.leaves(state))
    same = all(torch.equal(a, b) for a, b in zip(out["rank"][1],
                                                  out["folded"][1]))
    return {"rank": out["rank"][0], "folded": out["folded"][0],
            "same": same, "leaves": len(out["rank"][1]),
            "jax": "jax" in sys.modules}


def mesh_of_wrong_size(shape):
    """``make_debug_mesh`` of a mesh whose size is not the world's."""
    return make_debug_mesh(*shape, device="cpu")
