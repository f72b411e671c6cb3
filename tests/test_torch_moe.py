"""The port's Mixture-of-Experts family (``repro_torch.models.moe``, the
``Moe`` slot, olmoe-1b-7b and qwen3-moe-30b-a3b reduced) against the JAX
package's, on the CPU.

Weights are drawn with numpy in the JAX package's layout and carried
across with ``params_from_numpy``; both sides run in f32; the JAX side
under ``jax.jit``, its flash path in interpret mode, the port's on its
plain version. Tolerance 1e-4 abs, as ``tests/test_torch_transformer.py``.

The routing must be the JAX package's exactly, since one route kept or
dropped otherwise changes a token's output by ~1/k: ties go to the lower
expert index, and a route's rank within its expert counts the earlier
routes in the flat token-major order. A zero router makes every
probability 1/E, so every token ties, and at ``capacity_factor`` 1.25
most routes to the two winners are dropped. Chunked prefill and decode
equal the full forward only when nothing drops, so those checks run at
``capacity_factor`` 8.0, as the JAX package's own tests do
(``tests/test_arch_smoke.py:86``, ``tests/test_perf_features.py:38-42``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import both, cfgs, close, draw, x  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ATOL = 1e-4


def _moe_inputs(arch, cf, zero_router, seed=0):
    jcfg, cfg = cfgs(arch, capacity_factor=cf)
    np_p = draw(lambda k: jmoe.init_moe(k, jcfg), seed)
    if zero_router:
        np_p["router"]["w"] = np.zeros_like(np_p["router"]["w"])
    jp, p = both(np_p)
    return jcfg, cfg, jp, p, x((2, 16, cfg.d_model), seed + 1)


def test_capacity_matches_jax():
    for arch in ("olmoe-1b-7b", "qwen3-moe-30b-a3b"):
        for cf in (1.0, 1.25, 8.0):
            jcfg, cfg = cfgs(arch, capacity_factor=cf)
            for T in (1, 4, 8, 32, 33, 1000, 8192):
                assert moe.capacity(T, cfg) == jmoe.capacity(T, jcfg)


@pytest.mark.parametrize("zero_router", [False, True])
def test_route_top_k_ties_and_order(zero_router):
    """top_e and the renormalised top_w against ``jax.lax.top_k`` over the
    JAX package's router probabilities; with a zero router every token
    picks experts 0..k-1, in that order."""
    jcfg, cfg, jp, p, xs = _moe_inputs("olmoe-1b-7b", 1.25, zero_router)
    xt = xs.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xt @ np.asarray(jp["router"]["w"]), axis=-1)
    want_w, want_e = jax.lax.top_k(probs, cfg.moe_top_k)
    gp, gw, ge = moe.route(p["router"], torch.from_numpy(xt), cfg.moe_top_k)
    assert np.array_equal(ge.numpy(), np.asarray(want_e))
    close(gp, probs, 1e-6)
    close(gw, want_w / want_w.sum(-1, keepdims=True), 1e-6)
    if zero_router:
        assert (ge.numpy() == np.arange(cfg.moe_top_k)).all()


@pytest.mark.parametrize("arch,cf,zero_router", [
    ("olmoe-1b-7b", 1.25, False), ("olmoe-1b-7b", 8.0, False),
    ("olmoe-1b-7b", 1.25, True), ("olmoe-1b-7b", 8.0, True),
    ("qwen3-moe-30b-a3b", 1.25, False), ("qwen3-moe-30b-a3b", 1.25, True)])
def test_moe_ffn_matches_jax(arch, cf, zero_router):
    jcfg, cfg, jp, p, xs = _moe_inputs(arch, cf, zero_router)
    want, waux = jax.jit(lambda p_, x_: jmoe.moe_ffn(
        p_, x_, cfg=jcfg, dtype=jnp.float32))(jp, jnp.asarray(xs))
    got, aux = moe.moe_ffn(p, torch.from_numpy(xs), cfg=cfg,
                           dtype=torch.float32)
    close(got, want, ATOL)
    close(aux, waux, 1e-6)


@pytest.mark.parametrize("zero_router", [False, True])
def test_dispatch_keeps_the_first_routes_in_flat_order(zero_router):
    """Which routes survive capacity: a route is kept iff fewer than C
    routes to its expert come before it in the flat (token, slot) order.
    ``moe.dispatch`` held against a count in numpy over the port's own
    top_e, and through the output: each token's output is the kept
    routes' weighted sum."""
    jcfg, cfg, jp, p, xs = _moe_inputs("olmoe-1b-7b", 1.25, zero_router)
    T, k = xs.shape[0] * xs.shape[1], cfg.moe_top_k
    C = moe.capacity(T, cfg)
    _, top_w, top_e = moe.route(p["router"],
                                torch.from_numpy(xs.reshape(T, -1)), k)
    flat = top_e.reshape(-1).numpy()
    seen = np.zeros(cfg.num_experts, int)
    keep = np.zeros(flat.size, bool)
    for r, e in enumerate(flat):
        keep[r] = seen[e] < C
        seen[e] += 1
    assert np.array_equal(moe.dispatch(top_e, cfg.num_experts, C)[0]
                          .numpy(), keep)
    if zero_router:
        assert C < T and keep.sum() == k * C     # experts 0, 1 overflow
    out, _ = moe.moe_ffn(p, torch.from_numpy(xs), cfg=cfg,
                         dtype=torch.float32)
    xt = torch.from_numpy(xs.reshape(T, -1))
    act = torch.nn.functional.silu
    want = torch.zeros_like(xt)
    for r in np.flatnonzero(keep):
        t, e = r // k, flat[r]
        h = act(xt[t] @ p["w1"][e]) * (xt[t] @ p["w3"][e])
        want[t] += top_w.reshape(-1)[r] * (h @ p["w2"][e])
    close(out.reshape(T, -1), want.numpy(), ATOL)


def _slot(jcfg, seed):
    return both(draw(lambda k: jblocks.Moe.init(k, jcfg), seed))


@pytest.mark.parametrize("flash", [0, 1])
def test_moe_slot_apply_and_prefill_chunk(flash):
    """``Moe.apply`` (output and aux) at capacity 1.25, then two chunks of
    8 through ``prefill_chunk`` into an empty cache at 8.0 (no drops), each
    against the JAX slot's, and the chunks against the full apply."""
    jcfg, cfg = cfgs("olmoe-1b-7b", use_flash_attention=flash)
    jp, p = _slot(jcfg, 2)
    B, S, W = 2, 16, 24
    xs = x((B, S, cfg.d_model), 3)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)

    def japply(c):
        return jax.jit(lambda p_, x_, pos_: jblocks.Moe.apply(
            p_, x_, jblocks.BlockCtx(cfg=c, positions=pos_,
                                     dtype=jnp.float32,
                                     active=jnp.float32(1.0))))(
            jp, jnp.asarray(xs), jnp.asarray(pos))

    def apply(c):
        return blocks.Moe.apply(p, torch.from_numpy(xs), blocks.BlockCtx(
            cfg=c, positions=torch.from_numpy(pos), dtype=torch.float32,
            active=torch.tensor(1.0)))

    want, waux = japply(jcfg)
    got, aux = apply(cfg)
    close(got, want, ATOL)
    close(aux, waux, 1e-6)

    jcfg8, cfg8 = (c.with_overrides(capacity_factor=8.0)
                   for c in (jcfg, cfg))
    full, _ = apply(cfg8)
    jchunk = jax.jit(lambda p_, x_, c_, start: jblocks.Moe.prefill_chunk(
        p_, x_, c_, jblocks.BlockCtx(cfg=jcfg8, pos=start, dtype=jnp.float32,
                                     active=jnp.float32(1.0))),
        static_argnums=3)
    jc = jblocks.Moe.init_cache(jcfg8, B, W, jnp.float32)
    c = blocks.Moe.init_cache(cfg8, B, W, torch.float32)
    for start in (0, 8):
        xc = xs[:, start:start + 8]
        jy, jc = jchunk(jp, jnp.asarray(xc), jc, start)
        y, c = blocks.Moe.prefill_chunk(
            p, torch.from_numpy(xc), c,
            blocks.BlockCtx(cfg=cfg8, pos=start, dtype=torch.float32,
                            active=torch.tensor(1.0)))
        close(y, jy, ATOL)
        close(c["attn"]["k"], jc["attn"]["k"], 1e-5)
        close(y, full[:, start:start + 8].numpy(), ATOL)


def test_moe_slot_step_and_pad():
    """``Moe.step`` on a filled cache at per-slot positions, then as a pad
    slot (``active=0``): the identity, the cache unchanged."""
    jcfg, cfg = cfgs("olmoe-1b-7b")
    jp, p = _slot(jcfg, 4)
    B, W = 3, 12
    cache_np = {"attn": {"k": x((B, W, cfg.num_kv_heads, cfg.head_dim), 5),
                         "v": x((B, W, cfg.num_kv_heads, cfg.head_dim), 6)}}
    xs = x((B, 1, cfg.d_model), 7)
    pos = np.array([3, 11, 17], np.int32)
    for active in (1.0, 0.0):
        want, wc = jax.jit(lambda p_, x_, c_, pos_: jblocks.Moe.step(
            p_, x_, c_, jblocks.BlockCtx(cfg=jcfg, pos=pos_,
                                         dtype=jnp.float32,
                                         active=jnp.float32(active))))(
            jp, jnp.asarray(xs), jax.tree.map(jnp.asarray, cache_np),
            jnp.asarray(pos))
        got, gc = blocks.Moe.step(
            p, torch.from_numpy(xs), tree.map(torch.from_numpy, cache_np),
            blocks.BlockCtx(cfg=cfg, pos=torch.from_numpy(pos),
                            dtype=torch.float32,
                            active=torch.tensor(active)))
        close(got, want, ATOL)
        close(gc["attn"]["v"], wc["attn"]["v"], 1e-5)
    assert torch.equal(got, torch.from_numpy(xs))
    assert np.array_equal(gc["attn"]["k"].numpy(), cache_np["attn"]["k"])


@pytest.mark.parametrize("arch,flash", [("olmoe-1b-7b", 0),
                                        ("olmoe-1b-7b", 1),
                                        ("qwen3-moe-30b-a3b", 1)])
def test_sequential_lm_forward(arch, flash):
    """Logits and aux of the whole model (2 stages of 2 moe slots) at
    capacity 1.25, drops included."""
    jcfg, cfg = cfgs(arch, use_flash_attention=flash)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg), 8))
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24))
    want, waux, _ = jax.jit(lambda p_, t_: JM.sequential_lm_forward(
        p_, jcfg, t_))(jp, jnp.asarray(toks))
    got, aux, _ = M.sequential_lm_forward(p, cfg, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 24, cfg.vocab_size)
    close(got, want, ATOL)
    close(aux, waux, 1e-5)


def test_decode_steps_match_jax_and_the_full_forward():
    """8 decode steps from ``init_caches`` against the JAX package's, and
    (capacity 8.0: decode never drops, the full forward then neither)
    against the full forward's logits."""
    jcfg, cfg = cfgs("olmoe-1b-7b", capacity_factor=8.0)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg), 10))
    B, T = 2, 8
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, T))
    jc = JM.init_caches(jcfg, batch=B, cache_len=T, dtype=jnp.float32)
    c = M.init_caches(cfg, batch=B, cache_len=T, dtype=torch.float32,
                      device="cpu")
    jstep = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    full, _, _ = M.sequential_lm_forward(p, cfg, torch.from_numpy(toks))
    for t in range(T):
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                         jnp.int32(t))
        got, c = M.sequential_decode_step(
            p, cfg, torch.from_numpy(toks[:, t:t + 1]), c, t)
        close(got, want, ATOL)
        close(got[:, 0], full[:, t].numpy(), 1e-4)
    for a, b in zip(tree.leaves(c), jax.tree.leaves(jc)):
        close(a, b, 1e-5)
