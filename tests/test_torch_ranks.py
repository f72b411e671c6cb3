"""The port's pipeline engine on ranks (``repro_torch.pipeline`` on a
``launch/mesh.RankMesh``: one spawned process a mesh position, gloo on the
CPU, a real tensor axis, the vocab-parallel embedding and head, per-rank
shards) against the JAX package's engine, on the CPU: the meshes without
a data axis, (1, 2, 1), (1, 1, 2) and (1, 2, 2). Those with one, (2, 2, 2)
and (2, 2, 1), are in ``tests/test_torch_ranks_data.py``, so that pytest's
``--dist loadfile`` can give the two files to two workers.

The JAX engine runs as ``tests/test_torch_pipeline.py``,
``tests/test_torch_pipeline_train.py`` and
``tests/test_torch_pipeline_serve.py`` run it: ``shard_map`` over a
``jax.make_mesh`` of the 8 host devices ``tests/conftest.py`` asks for,
under ``jax.jit``. The port runs in a ``pipeline/ranks.RankPool`` of one
process a position of the same mesh, started once per mesh shape
(``pools``: one pool alive at a time, the cases grouped by shape) with
its ``FileStore`` under the test's temporary directory and a deadline on
every call. The ranks import no JAX (``tests/_torch_rank_cases.py``,
each result says so); each cuts its shards out of the numpy weights that
both engines get (``tests/_torch_parity.py``), and the parent puts the
ranks' gradient, state and cache shards together with ``gather_params``
/ ``gather_caches`` (``tests/_torch_rank_parity.py``).

Tolerances are ``tests/test_torch_pipeline.py``'s,
``tests/test_torch_pipeline_train.py``'s and
``tests/test_torch_pipeline_serve.py``'s: 1e-4 abs on the loss, the aux,
every gradient leaf, every leaf of a train state, logits and caches, in
f32; xLSTM's gradients per leaf within 2e-3 of the leaf's largest
|gradient| (its mLSTM slots amplify rounding, see those files). The
ranks sum over tensor and vocab shards with gloo in group order where
the JAX engine's ``psum`` sums in XLA's: rounding apart, as the folded
engine's whole-weight sums are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import _torch_rank_cases as rc  # noqa: E402
from _torch_parity import cfgs, draw, x as _x  # noqa: E402
from _torch_parity import both  # noqa: E402
from _torch_rank_parity import (ATOL, XLSTM_GRAD_REL,  # noqa: E402
                                assert_no_jax, check_loss_and_grads,
                                check_train_steps, jax_mesh, local_mesh,
                                pool_getter, tokens)
from repro.launch.mesh import mesh_context  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.pipeline import losses as jl  # noqa: E402
from repro.pipeline import pipeline_step as jps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.pipeline.sharding import gather_caches  # noqa: E402


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from pool_getter(tmp_path_factory)


# (arch, router_aux_weight): the cases of tests/test_torch_pipeline.py
# without a router loss, on (1, 2, 1); those with a data axis are in
# tests/test_torch_ranks_data.py
CASES = [("qwen2-1.5b", 1, 0.0, (1, 2, 1)), ("olmoe-1b-7b", 1, 0.0, (1, 2, 1)),
         ("xlstm-125m", 1, 0.0, (1, 2, 1)), ("zamba2-7b", 1, 0.0, (1, 2, 1)),
         ("chatglm3-6b", 1, 0.0, (1, 2, 1))]


@pytest.mark.parametrize("arch,tp,aux_w,shape", CASES)
def test_rank_loss_and_grads_match_jax_engine(pools, arch, tp, aux_w, shape):
    kw = dict(pipeline_stages=2, tensor_parallel=tp, num_layers=4,
              capacity_factor=8.0, router_aux_weight=aux_w)
    cfg = cfgs(arch, **kw)[1]
    batch = {"tokens": tokens(cfg, (4, 16), 1),
             "labels": tokens(cfg, (4, 16), 2)}
    want = check_loss_and_grads(
        pools, arch, kw, shape, batch,
        grad_rel=XLSTM_GRAD_REL if arch == "xlstm-125m" else None)
    if aux_w:
        assert want[2] > 0.0


# (mesh shape, tensor_parallel, optimizer, lr): SGD's step is lr times
# the gradient, so at 0.05 the blend of step 2 moves every earlier stage's
# weights well beyond 1e-4; Adam's moves each by ~lr, so at 1e-4 three
# updates stay within it (tests/test_torch_pipeline_train.py)
@pytest.mark.parametrize("shape,tp,opt,lr", [((1, 2, 1), 1, "sgd", 0.05),
                                             ((1, 1, 2), 2, "adam", 1e-4)])
def test_rank_train_steps_match_jax_engine(pools, shape, tp, opt, lr):
    check_train_steps(pools, shape, tp, dict(optimizer=opt,
                                             learning_rate=lr))


def test_rank_decode_matches_jax(pools):
    """qwen2-1.5b on (1, 2, 2): five decode steps in 2 microbatches,
    logits at every step, each stage's and tensor shard's caches at the
    end."""
    shape, T = (1, 2, 2), 5
    kw = dict(pipeline_stages=2, tensor_parallel=2, num_layers=4)
    jcfg, cfg = cfgs("qwen2-1.5b", **kw)
    np_p = draw(lambda k: JM.init_params(k, jcfg))
    toks = tokens(cfg, (4, T), 6)
    pool = pools(shape)
    pool.submit(rc.decode, "qwen2-1.5b", kw, shape, np_p, toks, 16, 2)
    mesh = jax_mesh(shape)
    jc = JM.init_caches(jcfg, batch=4, cache_len=16, dtype=jnp.float32)
    jp = both(np_p)[0]
    with mesh_context(mesh):
        jserve = jax.jit(jps.make_serve_step(mesh, jcfg, num_microbatches=2))
        want = []
        for t in range(T):
            lg, jc = jserve(jp, toks[:, t:t + 1], jc, jnp.int32(t))
            want.append(np.asarray(lg))
    res = pool.result()
    assert_no_jax(res)
    for r in res:
        for t in range(T):
            np.testing.assert_allclose(r["logits"][t], want[t], atol=ATOL)
    caches = gather_caches([tree.map(torch.from_numpy, r["caches"])
                            for r in res], local_mesh(shape), cfg)
    for a, b in zip(tree.leaves(caches), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_rank_vocab_head_on_whisper_padded_vocab(pools):
    """embed_tokens, lm_head_loss (a z-loss and a mask) and
    lm_head_logits over (stage, tensor) on (1, 2, 2), at whisper-base's
    vocab (51,865 of 51,968 padded: the last shard holds 103 pad
    columns), against the JAX package's vocab-parallel versions."""
    shape = (1, 2, 2)
    cfg = get_config("whisper-base")
    V, Vr, d = cfg.padded_vocab, cfg.vocab_size, 32
    assert (V, Vr) == (51968, 51865)
    table, w, y = _x((V, d), 9), _x((d, V), 10), _x((4, 6, d), 11)
    toks = np.random.default_rng(12).integers(0, Vr, (4, 6)).astype(np.int32)
    toks[0, :3] = [Vr - 1, V // 4 * 3, 0]      # the last shard, a boundary
    mask = (np.random.default_rng(13).random((4, 6)) > 0.3).astype(
        np.float32)
    pool = pools(shape)
    pool.submit(rc.vocab_head, shape, table, w, y, toks, mask, Vr, 1e-3)
    mesh = jax_mesh(shape)
    with mesh_context(mesh):
        je = jax.jit(lambda t, k: jl.embed_tokens(mesh, t, k, jnp.float32))(
            table, toks)
        jloss = jax.jit(lambda w_, y_, l_, m_: jl.lm_head_loss(
            mesh, w_, y_, l_, m_, vocab_size=Vr, z_weight=1e-3))(
                w, y, toks, mask)
        jlog = jax.jit(lambda w_, y_: jl.lm_head_logits(
            mesh, w_, y_, vocab_size=Vr))(w, y)
    res = pool.result()
    assert_no_jax(res)
    for r in res:
        np.testing.assert_array_equal(r["embed"], np.asarray(je))
        assert r["loss"] == pytest.approx(float(jloss), abs=ATOL)
        assert (r["logits"][..., Vr:] == -1e30).all()
        np.testing.assert_allclose(r["logits"], np.asarray(jlog), atol=ATOL)
