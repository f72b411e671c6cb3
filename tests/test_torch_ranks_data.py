"""The port's pipeline engine on ranks against the JAX package's engine,
on the CPU, on the meshes with a data axis: (2, 2, 2) and (2, 2, 1).
``tests/test_torch_ranks.py`` says how both engines run and which
tolerances hold; this file is its half with eight ranks a pool (the
gradients summed over data as the JAX engine's ``psum`` does), kept apart
so that pytest's ``--dist loadfile`` can give the two files to two
workers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import _torch_rank_cases as rc  # noqa: E402
from _torch_parity import both, cfgs, draw, x as _x  # noqa: E402
from _torch_rank_parity import (ATOL, XLSTM_GRAD_REL,  # noqa: E402
                                assert_no_jax, check_loss_and_grads,
                                check_train_steps, jax_mesh, local_mesh,
                                pool_getter, tokens)
from repro.launch.mesh import mesh_context  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.pipeline import pipeline_step as jps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.pipeline.sharding import gather_caches  # noqa: E402


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from pool_getter(tmp_path_factory)


# (arch, tensor_parallel, router_aux_weight): the cases of
# tests/test_torch_pipeline.py, grouped by mesh shape
ARCHS = [("qwen2-1.5b", 2, 0.0), ("olmoe-1b-7b", 2, 0.0),
         ("olmoe-1b-7b", 2, 0.01), ("xlstm-125m", 2, 0.0),
         ("zamba2-7b", 1, 0.0), ("chatglm3-6b", 2, 0.0)]
CASES = sorted([(*a, (2, 2, a[1])) for a in ARCHS],
               key=lambda c: c[3], reverse=True)


def test_rank_chunked_prefill_matches_jax(pools):
    """qwen2-1.5b on (2, 2, 2): 4 chunks of 16 into the caches, the last
    logits (every row on every rank) and every cache shard put
    together."""
    shape, chunks = (2, 2, 2), 4
    kw = dict(pipeline_stages=2, tensor_parallel=2, num_layers=4)
    jcfg, cfg = cfgs("qwen2-1.5b", **kw)
    np_p = draw(lambda k: JM.init_params(k, jcfg))
    toks = tokens(cfg, (4, 64), 3)
    pool = pools(shape)
    pool.submit(rc.prefill_chunked, "qwen2-1.5b", kw, shape, np_p, toks,
                chunks)
    mesh = jax_mesh(shape)
    jc = JM.init_caches(jcfg, batch=4, cache_len=64, dtype=jnp.float32)
    with mesh_context(mesh):
        want, want_c = jax.jit(jps.make_prefill_step(
            mesh, jcfg, seq_chunks=chunks))(both(np_p)[0], {"tokens": toks},
                                            jc)
    res = pool.result()
    assert_no_jax(res)
    for r in res:                   # every rank holds every row
        assert r["logits"].shape == (4, 1, cfg.padded_vocab)
        np.testing.assert_allclose(r["logits"], np.asarray(want), atol=ATOL)
    caches = gather_caches([tree.map(torch.from_numpy, r["caches"])
                            for r in res], local_mesh(shape), cfg)
    for a, b in zip(tree.leaves(caches), jax.tree.leaves(want_c)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_rank_whisper_and_vlm_prefix_match_jax_engine(pools):
    """On (2, 2, 2): whisper-base's two phases (the encoder's output
    broadcast from the last stage to every stage's cross-attention, its
    gradient summed back; no remat) and llava-next-mistral-7b's patch
    prefix (its mask zeroed, the labels padded in front), as
    ``tests/test_torch_pipeline.py`` runs them."""
    shape = (2, 2, 2)
    kw = dict(pipeline_stages=2, tensor_parallel=2)
    cfg = cfgs("whisper-base", **kw)[1]
    toks = tokens(cfg, (4, 8), 4)
    check_loss_and_grads(pools, "whisper-base", kw, shape, {
        "frames": _x((4, cfg.num_audio_frames, cfg.d_model), 5),
        "tokens": toks, "labels": toks}, remat=False)
    kw = dict(pipeline_stages=2, tensor_parallel=2, num_layers=4)
    cfg = cfgs("llava-next-mistral-7b", **kw)[1]
    check_loss_and_grads(pools, "llava-next-mistral-7b", kw, shape, {
        "tokens": tokens(cfg, (4, 16), 1), "labels": tokens(cfg, (4, 16), 2),
        "prefix": _x((4, cfg.num_prefix_tokens, cfg.d_model), 3)})


def test_rank_train_steps_match_jax_engine(pools):
    """Three SGD steps (lr 0.05, momentum) on (2, 2, 2): the blend at step
    2 on both stages' ranks, the gradients summed over data."""
    check_train_steps(pools, (2, 2, 2), 2, dict(optimizer="sgd",
                                                learning_rate=0.05))


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


