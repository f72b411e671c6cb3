"""The port's inference steps (``repro_torch.pipeline``: ``make_prefill_step``
full and chunked, ``make_serve_step``) against the JAX package's, on the
CPU.

The JAX engine runs under ``jax.jit`` with ``shard_map`` over the host
devices of ``tests/conftest.py``, its flash path in interpret mode; the
port on a ``LocalMesh`` of the same shape on the CPU, its kernels on their
plain versions. Weights are drawn with numpy in the JAX package's layout
(``tests/_torch_parity.py``); caches are f32.

Tolerance: 1e-4 abs on logits and caches, in f32, as
``tests/test_torch_transformer.py`` (the JAX package holds its own engine
to its sequential decode at 5e-4, ``tests/test_pipeline.py:82-89``).
xLSTM's logits are held at 2e-3: its mLSTM slots amplify rounding
(``tests/test_torch_xlstm.py`` holds the whole model there). MoE runs at
capacity factor 8, as ``tests/test_perf_features.py:38`` does.
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
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline import pipeline_step as ps  # noqa: E402

ATOL = 1e-4
XLSTM_ATOL = 2e-3


def jax_mesh(shape):
    if jax.device_count() < int(np.prod(shape)):
        pytest.skip("needs 8 host devices")
    return jax.make_mesh(shape, ("data", "stage", "tensor"),
                         **axis_types_kwarg(3))


def _setup(arch, tp, **kw):
    jcfg, cfg = cfgs(arch, pipeline_stages=2, tensor_parallel=tp,
                     num_layers=4, capacity_factor=8.0, **kw)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg)))
    return jcfg, cfg, jp, p


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _caches(cfg, jcfg, B, W, layout=None):
    return (JM.init_caches(jcfg, batch=B, cache_len=W, layout=layout,
                           dtype=jnp.float32),
            M.init_caches(cfg, batch=B, cache_len=W, layout=layout,
                          dtype=torch.float32, device="cpu"))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def _close_caches(got, want, atol=ATOL):
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, atol)


def _frozen(caches):
    return [t.clone() for t in tree.leaves(caches)]


def _unchanged(caches, before):
    return all(torch.equal(a, b) for a, b in
               zip(tree.leaves(caches), before))


# (arch, tensor_parallel, use_flash_attention, seq_chunks)
PREFILL = [("qwen2-1.5b", 2, 0, 0), ("qwen2-1.5b", 2, 1, 0),
           ("qwen2-1.5b", 2, 0, 4), ("qwen2-1.5b", 2, 1, 4),
           ("zamba2-7b", 1, 0, 4), ("olmoe-1b-7b", 2, 1, 4),
           ("xlstm-125m", 2, 0, 4)]


@pytest.mark.parametrize("arch,tp,flash,chunks", PREFILL)
def test_prefill_matches_jax(arch, tp, flash, chunks):
    """Full prefill (2 microbatches of 2 rows a data shard) or chunked
    prefill (4 chunks of 16, filling the caches) against the JAX engine,
    logits and caches; the caches passed in are left unwritten."""
    jcfg, cfg, jp, p = _setup(arch, tp, use_flash_attention=flash)
    B, S = 4, 64
    toks = _toks(cfg, (B, S), 1)
    mesh = jax_mesh((2, 2, tp))
    lmesh = make_debug_mesh(2, 2, tp, device="cpu")
    atol = XLSTM_ATOL if arch == "xlstm-125m" else ATOL
    if chunks:
        jc, c = _caches(cfg, jcfg, B, S)
        with mesh_context(mesh):
            want, want_c = jax.jit(jps.make_prefill_step(
                mesh, jcfg, seq_chunks=chunks))(jp, {"tokens": toks}, jc)
        before = _frozen(c)
        got, got_c = ps.make_prefill_step(lmesh, cfg, seq_chunks=chunks)(
            p, {"tokens": torch.from_numpy(toks)}, c)
        assert _unchanged(c, before)
        _close_caches(got_c, want_c, atol)
    else:
        with mesh_context(mesh):
            want = jax.jit(jps.make_prefill_step(
                mesh, jcfg, num_microbatches=2))(jp, {"tokens": toks})
        got = ps.make_prefill_step(lmesh, cfg, num_microbatches=2)(
            p, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, 1, cfg.padded_vocab)
    _close(got, want, atol)


def test_whisper_prefill_matches_jax():
    jcfg, cfg, jp, p = _setup("whisper-base", 2)
    frames = _x((4, cfg.num_audio_frames, cfg.d_model), 2)
    toks = _toks(cfg, (4, 8), 3)
    mesh = jax_mesh((2, 2, 2))
    with mesh_context(mesh):
        want = jax.jit(jps.make_prefill_step(mesh, jcfg, num_microbatches=2))(
            jp, {"frames": frames, "tokens": toks})
    got = ps.make_prefill_step(make_debug_mesh(2, 2, 2, device="cpu"), cfg,
                               num_microbatches=2)(
        p, {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_chunk_count_invariance_and_a_ragged_split():
    """2, 4 and 8 chunks give the same last logits (the JAX test's 5e-4,
    tests/test_perf_features.py:72); a length the chunk count does not
    divide raises (the JAX reshape fails there)."""
    _, cfg, _, p = _setup("llama3-8b", 2)
    toks = torch.from_numpy(_toks(cfg, (4, 64), 4))
    mesh = make_debug_mesh(2, 2, 2, device="cpu")
    outs = []
    for chunks in (2, 4, 8):
        c = M.init_caches(cfg, batch=4, cache_len=64, dtype=torch.float32,
                          device="cpu")
        outs.append(ps.make_prefill_step(mesh, cfg, seq_chunks=chunks)(
            p, {"tokens": toks}, c)[0])
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=5e-4)
    c = M.init_caches(cfg, batch=4, cache_len=64, dtype=torch.float32,
                      device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        ps.make_prefill_step(mesh, cfg, seq_chunks=3)(p, {"tokens": toks}, c)
    wcfg = cfgs("whisper-base", pipeline_stages=2, tensor_parallel=2)[1]
    with pytest.raises(ValueError, match="chunked prefill"):
        ps.make_prefill_step(mesh, wcfg, seq_chunks=2)


def test_chunked_caches_usable_for_decode():
    """Chunked prefill fills the caches, decode continues from them
    (tests/test_perf_features.py:75-99), against the JAX engine's same
    flow step by step."""
    jcfg, cfg, jp, p = _setup("qwen2-1.5b", 2)
    B, S, extra = 4, 32, 4
    toks = _toks(cfg, (B, S + extra), 5)
    mesh = jax_mesh((2, 2, 2))
    lmesh = make_debug_mesh(2, 2, 2, device="cpu")
    jc, c = _caches(cfg, jcfg, B, S + extra)
    with mesh_context(mesh):
        jl, jc = jax.jit(jps.make_prefill_step(mesh, jcfg, seq_chunks=4))(
            jp, {"tokens": toks[:, :S]}, jc)
        jserve = jax.jit(jps.make_serve_step(mesh, jcfg))
        want = [jl]
        for t in range(S, S + extra):
            lg, jc = jserve(jp, toks[:, t:t + 1], jc, jnp.int32(t))
            want.append(lg)
    lg, c = ps.make_prefill_step(lmesh, cfg, seq_chunks=4)(
        p, {"tokens": torch.from_numpy(toks[:, :S])}, c)
    got = [lg]
    serve = ps.make_serve_step(lmesh, cfg)
    for t in range(S, S + extra):
        lg, c = serve(p, torch.from_numpy(toks[:, t:t + 1]), c, t)
        got.append(lg)
    for g, w in zip(got, want):
        _close(g, w)
    _close_caches(c, jc)


@pytest.mark.parametrize("arch,tp", [("qwen2-1.5b", 2), ("zamba2-7b", 1),
                                     ("xlstm-125m", 2)])
def test_decode_matches_jax(arch, tp):
    """Five decode steps, 2 microbatches of 1 row a data shard, against
    the JAX engine (tests/test_pipeline.py:66-89): logits at every step
    and the caches at the end; no cache passed in is written."""
    jcfg, cfg, jp, p = _setup(arch, tp)
    B, W, T = 4, 16, 5
    toks = _toks(cfg, (B, T), 6)
    mesh = jax_mesh((2, 2, tp))
    jc, c = _caches(cfg, jcfg, B, W)
    atol = XLSTM_ATOL if arch == "xlstm-125m" else ATOL
    with mesh_context(mesh):
        jserve = jax.jit(jps.make_serve_step(mesh, jcfg, num_microbatches=2))
        want = []
        for t in range(T):
            lg, jc = jserve(jp, toks[:, t:t + 1], jc, jnp.int32(t))
            want.append(lg)
    serve = ps.make_serve_step(make_debug_mesh(2, 2, tp, device="cpu"), cfg,
                               num_microbatches=2)
    for t in range(T):
        before = _frozen(c)
        lg, new = serve(p, torch.from_numpy(toks[:, t:t + 1]), c, t)
        assert _unchanged(c, before)
        _close(lg, want[t], atol)
        c = new
    _close_caches(c, jc, atol)


def test_decode_past_the_sliding_window():
    """A ring cache of 8 rows, 12 steps (tests/test_pipeline.py:156-180):
    against the JAX engine, and the port's sequential decode."""
    jcfg, cfg, jp, p = _setup("qwen2-1.5b", 2, sliding_window=8)
    B, W, T = 4, 8, 12
    toks = _toks(cfg, (B, T), 7)
    mesh = jax_mesh((2, 2, 2))
    jc, c = _caches(cfg, jcfg, B, W)
    sc = M.init_caches(cfg, batch=B, cache_len=W, dtype=torch.float32,
                       device="cpu")
    with mesh_context(mesh):
        jserve = jax.jit(jps.make_serve_step(mesh, jcfg, window=W))
        want = []
        for t in range(T):
            lg, jc = jserve(jp, toks[:, t:t + 1], jc, jnp.int32(t))
            want.append(lg)
    serve = ps.make_serve_step(make_debug_mesh(2, 2, 2, device="cpu"), cfg,
                               window=W)
    for t in range(T):
        tok = torch.from_numpy(toks[:, t:t + 1])
        lg, c = serve(p, tok, c, t)
        ref, sc = M.sequential_decode_step(p, cfg, tok, sc, t)
        _close(lg, want[t])
        np.testing.assert_allclose(lg[..., :cfg.vocab_size].numpy(),
                                   ref.numpy(), atol=5e-4)


def test_scalar_and_0d_tensor_positions_agree():
    """``pos`` is one position for the batch: an int and a 0-d tensor give
    the same logits and caches (tests/test_serving.py:87-112); a
    per-sequence vector is refused."""
    _, cfg, _, p = _setup("qwen2-1.5b", 2)
    toks = torch.from_numpy(_toks(cfg, (4, 5), 8))
    serve = ps.make_serve_step(make_debug_mesh(2, 2, 2, device="cpu"), cfg,
                               num_microbatches=2)
    ca = M.init_caches(cfg, batch=4, cache_len=16, dtype=torch.float32,
                       device="cpu")
    cb = tree.map(torch.clone, ca)
    for t in range(5):
        la, ca = serve(p, toks[:, t:t + 1], ca, t)
        lb, cb = serve(p, toks[:, t:t + 1], cb,
                       torch.full((), t, dtype=torch.int32))
        assert torch.equal(la, lb)
    assert _unchanged(ca, tree.leaves(cb))
    with pytest.raises(ValueError, match="one position"):
        serve(p, toks[:, :1], ca, torch.full((4,), 5, dtype=torch.int32))


def test_whisper_decode_with_kv_source_matches_jax():
    """Whisper's decoder through the serve step: the position row
    ``min(pos, max_target_positions - 1)``, cross-attention to
    ``kv_source`` split by microbatch, LayerNorm; against the JAX engine,
    and the cache passed in left unwritten."""
    jcfg, cfg, jp, p = _setup("whisper-base", 2)
    B, W, T = 4, 8, 4
    toks = _toks(cfg, (B, T), 9)
    kv = _x((B, cfg.num_audio_frames, cfg.d_model), 10)
    layout = cfg.decoder_slot_layout
    jc, c = _caches(cfg, jcfg, B, W, layout)
    mesh = jax_mesh((2, 2, 2))
    with mesh_context(mesh):
        jserve = jax.jit(jps.make_serve_step(mesh, jcfg, num_microbatches=2))
        want = []
        for t in range(T):
            lg, jc = jserve(jp, toks[:, t:t + 1], jc, jnp.int32(t),
                            jnp.asarray(kv))
            want.append(lg)
    serve = ps.make_serve_step(make_debug_mesh(2, 2, 2, device="cpu"), cfg,
                               num_microbatches=2)
    for t in range(T):
        before = _frozen(c)
        lg, new = serve(p, torch.from_numpy(toks[:, t:t + 1]), c, t,
                        torch.from_numpy(kv))
        assert _unchanged(c, before)
        _close(lg, want[t])
        c = new
    _close_caches(c, jc)
