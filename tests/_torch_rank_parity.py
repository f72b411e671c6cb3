"""Helpers shared by the port's rank-engine parity tests
(``tests/test_torch_ranks.py``, ``tests/test_torch_ranks_data.py``): the
rank pools, the JAX engine's side of a comparison and the checks.

The JAX engine runs as ``tests/test_torch_pipeline.py`` and
``tests/test_torch_pipeline_train.py`` run it: ``shard_map`` over a
``jax.make_mesh`` of the 8 host devices ``tests/conftest.py`` asks for,
under ``jax.jit``. The port runs in a ``pipeline/ranks.RankPool`` of one
process a position of the same mesh (``tests/_torch_rank_cases.py``,
which imports no JAX); the parent puts the ranks' shards together with
``gather_params`` / ``gather_caches``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_cases as rc
from _torch_parity import both, cfgs, draw
from repro.configs import TrainConfig as JTrainConfig
from repro.launch.mesh import axis_types_kwarg, mesh_context
from repro.models import model as JM
from repro.pipeline import pipeline_step as jps
from repro_torch import tree
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.pipeline.ranks import RankPool
from repro_torch.pipeline.sharding import gather_params, shard_params

ATOL = 1e-4
XLSTM_GRAD_REL = 2e-3
NAMES = ("data", "stage", "tensor")
DEADLINE = 240.0        # seconds a pool may take to start or to answer


def pool_getter(tmp_path_factory):
    """A module fixture's body: yields ``get(shape)``, the rank pool of a
    mesh shape; asking for another shape closes the last pool first (one
    pool alive at a time, so a module groups its cases by shape)."""
    live = {}

    def get(shape):
        if shape not in live:
            for p in live.values():
                p.close()
            live.clear()
            live[shape] = RankPool(math.prod(shape),
                                   str(tmp_path_factory.mktemp("ranks")),
                                   timeout=DEADLINE)
        return live[shape]

    yield get
    for p in live.values():
        p.close()


def jax_mesh(shape):
    if jax.device_count() < math.prod(shape):
        pytest.skip("needs 8 host devices")
    return jax.make_mesh(shape, NAMES, **axis_types_kwarg(3))


def local_mesh(shape):
    return make_local_mesh(shape, NAMES, device="cpu")


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def assert_no_jax(results):
    assert not any(r["jax"] for r in results)


def _jax_loss_and_grads(shape, jcfg, jp, batch, m, remat=True):
    mesh = jax_mesh(shape)
    with mesh_context(mesh):
        loss_fn = jps.make_loss_fn(mesh, jcfg, num_microbatches=m,
                                   remat=remat)
        (total, metrics), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(total), float(metrics["loss"]), float(metrics["aux"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def check_loss_and_grads(pools, arch, kw, shape, batch, remat=True,
                         grad_rel=None):
    """The rank engine on ``shape`` against the JAX engine: the loss, aux
    and total (the same on every rank, and the forward-only loss
    function's), every gradient leaf put together from the ranks'
    shards."""
    jcfg, cfg = cfgs(arch, **kw)
    np_p = draw(lambda k: JM.init_params(k, jcfg))
    pool = pools(shape)
    pool.submit(rc.loss_and_grads, arch, kw, shape, np_p, batch, 2, remat)
    want = _jax_loss_and_grads(shape, jcfg, both(np_p)[0], batch, 2, remat)
    res = pool.result()
    assert_no_jax(res)
    assert len({r["total"] for r in res}) == 1    # replicated on every rank
    got = res[0]
    assert got["forward_only"] == pytest.approx(got["total"], abs=1e-6)
    for k, w in zip(("total", "loss", "aux"), want[:3]):
        assert got[k] == pytest.approx(w, abs=ATOL), k
    grads = tree.leaves(gather_params(
        [tree.map(torch.from_numpy, r["grads"]) for r in res],
        local_mesh(shape), cfg))
    assert len(grads) == len(want[3])
    for a, b in zip(grads, want[3]):
        assert tuple(a.shape) == b.shape
        tol = ATOL if grad_rel is None else grad_rel * np.abs(b).max()
        np.testing.assert_allclose(a.numpy(), b, atol=tol)
    return want


def _gather_state(parts, mesh, cfg):
    """The whole train state from the ranks' numpy shards of it. Every
    rank's shards must be the gathered state's bit for bit: the copies of
    a replicated leaf stay equal from step to step."""
    def whole(trees):
        return gather_params([tree.map(torch.from_numpy, t) for t in trees],
                             mesh, cfg)

    first = parts[0]
    state = {"params": whole([p["params"] for p in parts]),
             "stash": whole([p["stash"] for p in parts]),
             "step": torch.from_numpy(first["step"]),
             "opt_state": {
                 k: (whole([p["opt_state"][k] for p in parts])
                     if isinstance(v, dict) else torch.from_numpy(v))
                 for k, v in first["opt_state"].items()}}
    keys = [("params",), ("stash",)] + [
        ("opt_state", k) for k, v in first["opt_state"].items()
        if isinstance(v, dict)]
    for r, part in enumerate(parts):
        for path in keys:
            mine = shard_params(_at(state, path), mesh, cfg, rank=r)
            for a, b in zip(tree.leaves(mine), tree.leaves(_at(part, path))):
                np.testing.assert_array_equal(a.numpy(), b)
    return state


def _at(t, path):
    for k in path:
        t = t[k]
    return t


def check_train_steps(pools, shape, tp, tc_kw, steps=3):
    """``steps`` steps of qwen2-1.5b's train step (stash depth 2, the
    blend every 2 steps) on the rank engine against the JAX engine's, on
    ``shape``: after each step every leaf of the state put together from
    the ranks' shards (params, stash, optimizer state, step) and the
    metrics within ATOL, in f32. Step 2 blends the stages' weights; step
    3 runs on the stash that step 1's update turned over."""
    kw = dict(pipeline_stages=shape[1], tensor_parallel=tp, num_layers=2,
              stash_depth=2, aggregate_every=2)
    jcfg, cfg = cfgs("qwen2-1.5b", **kw)
    np_p = draw(lambda k: JM.init_params(k, jcfg))
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (4, 16))
        .astype(np.int32)} for _ in range(steps)]
    tc_kw = dict(microbatches=2, weight_decay=1e-3, **tc_kw)
    pool = pools(shape)
    pool.submit(rc.train_states, "qwen2-1.5b", kw, shape, np_p, batches,
                tc_kw)
    mesh = jax_mesh(shape)
    with mesh_context(mesh):
        jstep_fn, _ = jps.make_train_step(mesh, jcfg, JTrainConfig(**tc_kw))
        jstate = jstep_fn.init_state(both(np_p)[0])
        jstep = jax.jit(jstep_fn)
        want = []
        for b in batches:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            want.append(([np.asarray(a) for a in jax.tree.leaves(jstate)],
                         float(jm["loss"]), float(jm["aux"])))
    res = pool.result()
    assert_no_jax(res)
    for i, (leaves, loss, aux) in enumerate(want):
        got = [r["steps"][i] for r in res]
        assert len({g["loss"] for g in got}) == 1
        assert got[0]["loss"] == pytest.approx(loss, abs=ATOL)
        assert got[0]["aux"] == pytest.approx(aux, abs=ATOL)
        state = _gather_state([g["state"] for g in got], local_mesh(shape),
                              cfg)
        mine = tree.leaves(state)
        assert len(mine) == len(leaves)
        for a, w in zip(mine, leaves):
            assert tuple(a.shape) == w.shape
            np.testing.assert_allclose(a.numpy(), w, atol=ATOL)
    assert int(state["step"]) == steps
