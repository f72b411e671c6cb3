"""The port's pipeline engine (``repro_torch.pipeline``: ``make_loss_fn``
over ``pipeline_forward``, the vocab loss) against the JAX package's, on
the CPU.

The JAX engine runs as its own tests run it: ``shard_map`` over a
``jax.make_mesh`` of the 8 host devices ``tests/conftest.py`` asks for,
under ``jax.jit``. The port runs the same schedule on a ``LocalMesh`` of
the same shape on the CPU (every axis folded onto one device; its kernels
on their plain versions). Weights are drawn with numpy in the JAX
package's layout (``tests/_torch_parity.py``) and carried into both.

Tolerance: 1e-4 abs on the loss and on every gradient leaf, in f32. The
two engines sum in other orders (the JAX engine's ``psum`` over tensor
and vocab shards, XLA's matmuls against oneDNN's); the JAX package's own
tests hold its engine to the sequential forward at 2e-4 (loss) and 5e-4
(gradients), ``tests/test_pipeline.py:57-61``. Measured: 1.5e-6 or less
but for xLSTM. xLSTM's gradients are held per leaf within 2e-3 of the
leaf's largest |gradient|: its mLSTM slots amplify rounding
(``tests/test_torch_xlstm.py``), and the two packages' SEQUENTIAL
forwards already give gradients 4.7e-4 of that apart (embed table, whose
gradient reaches 16; the engines 4.6e-4). MoE runs at capacity factor 8
(``tests/test_pipeline.py:41``) so that no route is dropped by a
rounding-level difference.

The engine asserts ``mesh.shape["tensor"] == cfg.tensor_parallel``, so
zamba2-7b (tensor_parallel 1, ``tests/test_pipeline.py:33``) runs on a
(2, 2, 1) mesh where the others run on (2, 2, 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import both, cfgs, draw, x as _x  # noqa: E402
from repro.launch.mesh import axis_types_kwarg, mesh_context  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.pipeline import pipeline_step as jps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_local_mesh)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline import losses  # noqa: E402
from repro_torch.pipeline import pipeline_step as ps  # noqa: E402

ATOL = 1e-4


def jax_mesh(shape, names=("data", "stage", "tensor")):
    if jax.device_count() < int(np.prod(shape)):
        pytest.skip("needs 8 host devices")
    return jax.make_mesh(shape, names, **axis_types_kwarg(len(names)))


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def jax_loss_and_grads(mesh, jcfg, jp, batch, m, remat=True):
    with mesh_context(mesh):
        loss_fn = jps.make_loss_fn(mesh, jcfg, num_microbatches=m,
                                   remat=remat)
        (total, metrics), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(total), float(metrics["loss"]), float(metrics["aux"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def port_loss_and_grads(mesh, cfg, p, batch, m, remat=True):
    loss_fn = ps.make_loss_fn(mesh, cfg, num_microbatches=m, remat=remat)
    leaves, paths = tree.flatten(p)
    live = [l.detach().requires_grad_(True) for l in leaves]
    total, metrics = loss_fn(tree.unflatten(paths, live),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, live)]
    return (float(total.detach()), float(metrics["loss"].detach()),
            float(metrics["aux"].detach()), [g.numpy() for g in grads])


def assert_same(got, want, atol=ATOL, grad_rel=None):
    """Loss, total and aux within ``atol``; each gradient leaf within
    ``atol``, or within ``grad_rel`` of its largest |value| where given."""
    total, loss, aux, grads = got
    assert total == pytest.approx(want[0], abs=atol)
    assert loss == pytest.approx(want[1], abs=atol)
    assert aux == pytest.approx(want[2], abs=atol)
    assert len(grads) == len(want[3])
    for a, b in zip(grads, want[3]):
        assert a.shape == b.shape
        tol = atol if grad_rel is None else grad_rel * np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=tol)


# xLSTM's per-leaf gradient limit, relative to the leaf's largest |value|
XLSTM_GRAD_REL = 2e-3


# (arch, tensor_parallel on the (2,2,2) mesh, router_aux_weight): the
# cases of tests/test_pipeline.py:32-33, olmoe also with its load-balance
# loss in the total
ARCHS = [("qwen2-1.5b", 2, 0.0), ("olmoe-1b-7b", 2, 0.0),
         ("olmoe-1b-7b", 2, 0.01), ("xlstm-125m", 2, 0.0),
         ("zamba2-7b", 1, 0.0), ("chatglm3-6b", 2, 0.0)]
CASES = [(*a, (2, 2, a[1])) for a in ARCHS] + [
    (arch, 1, 0.0, (1, 2, 1)) for arch, _, aux_w in ARCHS if not aux_w]


def _case(arch, tp, aux_w):
    jcfg, cfg = cfgs(arch, pipeline_stages=2, tensor_parallel=tp,
                     num_layers=4, capacity_factor=8.0,
                     router_aux_weight=aux_w)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg)))
    batch = {"tokens": tokens(cfg, (4, 16), 1),
             "labels": tokens(cfg, (4, 16), 2)}
    return jcfg, cfg, jp, p, batch


@pytest.mark.parametrize("arch,tp,aux_w,mesh_shape", CASES)
def test_loss_and_grads_match_jax_engine(arch, tp, aux_w, mesh_shape):
    jcfg, cfg, jp, p, batch = _case(arch, tp, aux_w)
    want = jax_loss_and_grads(jax_mesh(mesh_shape), jcfg, jp, batch, 2)
    got = port_loss_and_grads(make_debug_mesh(*mesh_shape, device="cpu"),
                              cfg, p, batch, 2)
    if aux_w:
        assert want[2] > 0.0            # the aux is in the total
    assert_same(got, want, grad_rel=XLSTM_GRAD_REL
                if arch == "xlstm-125m" else None)


def test_vlm_prefix_loss_and_grads_match_jax_engine():
    """llava-next-mistral-7b: the patch prefix is prepended, its mask
    zeroed and the labels padded in front (pipeline_step.py:361-380)."""
    jcfg, cfg, jp, p, batch = _case("llava-next-mistral-7b", 2, 0.0)
    batch["prefix"] = _x((4, cfg.num_prefix_tokens, cfg.d_model), 3)
    want = jax_loss_and_grads(jax_mesh((2, 2, 2)), jcfg, jp, batch, 2)
    got = port_loss_and_grads(make_debug_mesh(2, 2, 2, device="cpu"), cfg,
                              p, batch, 2)
    assert_same(got, want)


def test_whisper_two_phase_loss_and_grads_match_jax_engine():
    """The encoder non-causal through the engine, the decoder over tokens
    with sinusoidal positions, cross-attending to the encoder's output
    split by microbatch; LayerNorm before the head."""
    jcfg, cfg = cfgs("whisper-base", pipeline_stages=2, tensor_parallel=2)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg)))
    toks = tokens(cfg, (4, 8), 4)
    batch = {"frames": _x((4, cfg.num_audio_frames, cfg.d_model), 5),
             "tokens": toks, "labels": toks}
    want = jax_loss_and_grads(jax_mesh((2, 2, 2)), jcfg, jp, batch, 2,
                              remat=False)
    got = port_loss_and_grads(make_debug_mesh(2, 2, 2, device="cpu"), cfg,
                              p, batch, 2, remat=False)
    assert_same(got, want)


def test_extra_data_axis_matches_jax_engine():
    """The batch is split over (data, extra): 4 shards of 2 rows, each in
    2 microbatches (tests/test_perf_features.py:109)."""
    jcfg, cfg = cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=1,
                     num_layers=4, extra_data=2)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg)))
    batch = {"tokens": tokens(cfg, (8, 16), 6),
             "labels": tokens(cfg, (8, 16), 7)}
    names = ("data", "extra", "stage", "tensor")
    want = jax_loss_and_grads(jax_mesh((2, 2, 2, 1), names), jcfg, jp,
                              batch, 2, remat=False)
    mesh = make_local_mesh((2, 2, 2, 1), names, device="cpu")
    assert ps.data_axes(mesh) == ("data", "extra")
    got = port_loss_and_grads(mesh, cfg, p, batch, 2, remat=False)
    assert_same(got, want)


def _seq_loss(p, cfg, toks, labels, aux_w=0.0):
    logits, aux, _ = M.sequential_lm_forward(p, cfg, torch.from_numpy(toks))
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(lp, -1, torch.from_numpy(labels).long()[..., None])
    return -ll.mean() + aux_w * aux


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_engine_matches_port_sequential_forward(arch):
    """The port's engine against the port's own sequential forward and
    cross-entropy, at the JAX test's limits (2e-4 loss, 5e-4 gradients,
    tests/test_pipeline.py:57-61), with and without remat and at one and
    two microbatches."""
    jcfg, cfg, jp, p, batch = _case(arch, 2, 0.0)
    leaves, paths = tree.flatten(p)
    live = [l.detach().requires_grad_(True) for l in leaves]
    ref = _seq_loss(tree.unflatten(paths, live), cfg, batch["tokens"],
                    batch["labels"])
    g_ref = torch.autograd.grad(ref, live, allow_unused=True)
    mesh = make_debug_mesh(2, 2, 2, device="cpu")
    for m, remat in ((2, True), (1, False)):
        got = port_loss_and_grads(mesh, cfg, p, batch, m, remat=remat)
        assert got[1] == pytest.approx(float(ref.detach()), abs=2e-4)
        for a, b in zip(got[3], g_ref):
            b = np.zeros_like(a) if b is None else b.numpy()
            np.testing.assert_allclose(a, b, atol=5e-4)


def test_microbatch_count_invariance():
    """The loss does not depend on the microbatch split (JAX:
    tests/test_pipeline.py:101-116): M = 1, 2, 4 and 3 (lowered to 2, as
    the JAX engine lowers it until it divides the shard's rows)."""
    _, cfg = cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=2,
                  num_layers=4)
    p = M.params_from_numpy(draw(lambda k: JM.init_params(
        k, cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=2,
                num_layers=4)[0])))
    toks = torch.from_numpy(tokens(cfg, (8, 16), 8))
    batch = {"tokens": toks, "labels": toks}
    mesh = make_debug_mesh(2, 2, 2, device="cpu")
    out = []
    for m in (1, 2, 4, 3):
        with torch.no_grad():
            out.append(float(ps.make_loss_fn(mesh, cfg, num_microbatches=m,
                                             remat=False)(p, batch)[1]
                             ["loss"]))
    assert max(out) - min(out) < 1e-4, out
    assert out[3] == out[1]          # M=3 runs as M=2 on 4 rows a shard


def test_losses_match_jax_vocab_parallel_versions():
    """embed_tokens, lm_head_loss (with a z-loss and a mask) and
    lm_head_logits against the JAX package's vocab-parallel ones on the
    (2, 2, 2) mesh, with pad columns (vocab 500 of 512)."""
    from repro.pipeline import losses as jl
    mesh = jax_mesh((2, 2, 2))
    lmesh = make_debug_mesh(2, 2, 2, device="cpu")
    table, w, y = _x((512, 64), 9), _x((64, 512), 10), _x((4, 6, 64), 11)
    toks = np.random.default_rng(12).integers(0, 500, (4, 6)).astype(
        np.int32)
    mask = (np.random.default_rng(13).random((4, 6)) > 0.3).astype(
        np.float32)
    with mesh_context(mesh):
        je = jax.jit(lambda t, k: jl.embed_tokens(mesh, t, k, jnp.float32))(
            table, toks)
        jloss = jax.jit(lambda w_, y_, l_, m_: jl.lm_head_loss(
            mesh, w_, y_, l_, m_, vocab_size=500, z_weight=1e-3))(
                w, y, toks, mask)
        jlog = jax.jit(lambda w_, y_: jl.lm_head_logits(
            mesh, w_, y_, vocab_size=500))(w, y)
    e = losses.embed_tokens(lmesh, torch.from_numpy(table),
                            torch.from_numpy(toks), torch.float32)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    loss = losses.lm_head_loss(lmesh, torch.from_numpy(w),
                               torch.from_numpy(y), torch.from_numpy(toks),
                               torch.from_numpy(mask), vocab_size=500,
                               z_weight=1e-3)
    assert float(loss) == pytest.approx(float(jloss), abs=ATOL)
    logits = losses.lm_head_logits(lmesh, torch.from_numpy(w),
                                   torch.from_numpy(y), vocab_size=500)
    assert logits.shape == (4, 6, 512)
    assert (logits[..., 500:] == -1e30).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=ATOL)


def test_engine_checks_the_mesh():
    _, cfg = cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=2,
                  num_layers=4)
    p = M.init_params(0, cfg, device="cpu")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32)}
    for shape in ((2, 4, 2), (2, 2, 1)):
        with pytest.raises(ValueError, match="mesh"):
            ps.make_loss_fn(make_debug_mesh(*shape, device="cpu"), cfg)(
                p, batch)
    with pytest.raises(ValueError, match="data shards"):
        ps.make_loss_fn(make_debug_mesh(3, 2, 2, device="cpu"), cfg)(
            p, batch)
