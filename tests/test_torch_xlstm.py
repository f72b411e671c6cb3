"""The port's xLSTM family (``repro_torch.models.xlstm``, the ``mlstm`` and
``slstm`` slots, xlstm-125m reduced) against the JAX package's, on the
CPU.

Weights are drawn with numpy in the JAX package's layout (the forget-gate
biases keep the JAX init's 3.0) and carried across with
``params_from_numpy``; both sides run in f32, the JAX side under
``jax.jit``. Tolerance 1e-4 abs on outputs, as
``tests/test_torch_transformer.py``; each recurrent state (C, n, c, h, m)
within 1e-5 of its largest magnitude: the matrix memory C grows to ~20
and its elements differ by up to 3.6e-5 (measured), as f32 sums of
terms that size in two orders do. Where the stabiliser ``m`` still holds
its initial -1e30, 1e-5 relative.

The whole model's logits are held to 2e-3 abs (``ATOL_MODEL``), its
caches after 5 decode steps to 1e-2 of each leaf's largest magnitude
(2.4e-3 measured; a state feeds a norm and a gate before the logits, so
it carries more of the rounding than they do). At these random weights an mLSTM slot is
ill-conditioned: its group norm rescales rows whose spread is ~8,000x
smaller than others' (row std 0.028 to 237, measured), so moving one
slot's input by one f32 rounding (1e-7 relative) moves its output by
2.0-5.5e-5, and moving the embedding table by one rounding moves the
5-layer model's logits by 0.75-4.2e-4 (the port against itself,
measured). The port and the JAX package sum in different orders, so
their logits are 5.5e-4 apart there: the size of one rounding, not a
fault. A fault of the kind this file guards against (``torch.var``'s
default correction, a tie rule, a stabiliser in bf16) moves them by
1e-2 or more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import KEY, both, cfgs, close, draw, x  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

ATOL = 1e-4
ATOL_MODEL = 2e-3
F32 = dict(dtype=jnp.float32)


@pytest.fixture(scope="module")
def setup():
    """Both layers' weights, and the states the JAX package carries after
    a first chunk of 6 steps (non-trivial C, n, m; c, n, h, m)."""
    jcfg, cfg = cfgs("xlstm-125m")
    jm, m = both(draw(lambda k: jx.init_mlstm(k, jcfg), 1))
    js, s = both(draw(lambda k: jx.init_slstm(k, jcfg), 2))
    xs = jnp.asarray(x((2, 6, cfg.d_model), 3))
    _, jmc = jax.jit(lambda p_, x_: jx.mlstm_mixer_chunk(
        p_, x_, jx.init_mlstm_cache(jcfg, 2), cfg=jcfg, **F32))(jm, xs)
    _, jss = jax.jit(lambda p_, x_: jx.slstm_mixer_chunk(
        p_, x_, dict(zip("cnhm", jx.init_slstm_state(jcfg, 2))), cfg=jcfg,
        **F32))(js, xs)
    return jcfg, cfg, (jm, m), (js, s), (jmc, jss)


def _state_close(got, want, tol=1e-5):
    for a, b in zip(tree.leaves(got) if isinstance(got, (dict, list)) else got,
                    jax.tree.leaves(want)):
        b = np.asarray(b)
        if b.min() < -1e29:                    # the stabiliser's -1e30
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)
        else:
            close(a, b, tol * max(1.0, float(np.abs(b).max())))


def _t(a):
    return torch.from_numpy(np.array(a))


def _run(name, jcfg, cfg, jm, m, js, s, jmc, jss):
    """(port's output, port's state, JAX's output, JAX's state) of one of
    the eight mixer and step functions, on inputs from numpy, the chunk
    and step forms continuing from the carried states ``jmc``, ``jss``."""
    B, S, d = 2, 12, cfg.d_model
    xs = x((B, S, d), 3)
    x1 = x((B, 1, d), 4)
    H, dh = xlstm.slstm_dims(cfg)
    mc = tree.map(_t, jax.tree.map(np.asarray, jmc))
    ss = {k: _t(v) for k, v in jss.items()}
    jst = tuple(jss[k] for k in "cnhm")
    if name == "mlstm_mixer":
        want = jax.jit(lambda p_, x_: jx.mlstm_mixer(p_, x_, cfg=jcfg, **F32))(
            jm, jnp.asarray(xs))
        return (xlstm.mlstm_mixer(m, _t(xs), cfg=cfg, dtype=torch.float32),
                None, want, None)
    if name == "mlstm_mixer_chunk":
        want, wc = jax.jit(lambda p_, x_, c_: jx.mlstm_mixer_chunk(
            p_, x_, c_, cfg=jcfg, **F32))(jm, jnp.asarray(xs[:, 6:]), jmc)
        got, gc = xlstm.mlstm_mixer_chunk(m, _t(xs[:, 6:]), mc, cfg=cfg,
                                          dtype=torch.float32)
        return got, gc, want, wc
    if name == "mlstm_step":
        want, wc = jax.jit(lambda p_, x_, c_: jx.mlstm_step(
            p_, x_, c_, cfg=jcfg, **F32))(jm, jnp.asarray(x1), jmc)
        got, gc = xlstm.mlstm_step(m, _t(x1), mc, cfg=cfg,
                                   dtype=torch.float32)
        return got, gc, want, wc
    if name == "_slstm_cell":
        wx = x((B, H, 4 * dh), 5)
        want = jx._slstm_cell(js, jnp.asarray(wx), jst)
        got = xlstm._slstm_cell(s, _t(wx), tuple(ss[k] for k in "cnhm"))
        return got[2], got, want[2], want
    if name in ("slstm_mixer", "slstm_mixer_h0"):
        h0 = jst if name == "slstm_mixer_h0" else None
        want = jax.jit(lambda p_, x_: jx.slstm_mixer(
            p_, x_, cfg=jcfg, h0=h0, **F32))(js, jnp.asarray(xs))
        got = xlstm.slstm_mixer(
            s, _t(xs), cfg=cfg, dtype=torch.float32,
            h0=None if h0 is None else tuple(ss[k] for k in "cnhm"))
        return got, None, want, None
    if name == "slstm_mixer_chunk":
        want, wc = jax.jit(lambda p_, x_, c_: jx.slstm_mixer_chunk(
            p_, x_, c_, cfg=jcfg, **F32))(js, jnp.asarray(xs[:, 6:]), jss)
        got, gc = xlstm.slstm_mixer_chunk(s, _t(xs[:, 6:]), ss, cfg=cfg,
                                          dtype=torch.float32)
        return got, gc, want, wc
    assert name == "slstm_step"
    want, wst = jax.jit(lambda p_, x_, st_: jx.slstm_step(
        p_, x_, st_, cfg=jcfg, **F32))(js, jnp.asarray(x1), jst)
    got, gst = xlstm.slstm_step(s, _t(x1), tuple(ss[k] for k in "cnhm"),
                                cfg=cfg, dtype=torch.float32)
    return got, gst, want, wst


@pytest.mark.parametrize("name", [
    "mlstm_mixer", "mlstm_mixer_chunk", "mlstm_step", "_slstm_cell",
    "slstm_mixer", "slstm_mixer_h0", "slstm_mixer_chunk", "slstm_step"])
def test_mixer_and_step_functions(setup, name):
    jcfg, cfg, (jm, m), (js, s), (jmc, jss) = setup
    got, gst, want, wst = _run(name, jcfg, cfg, jm, m, js, s, jmc, jss)
    close(got, want, ATOL)
    if wst is not None:
        _state_close(gst, wst)


def test_init_caches_and_dims_match_jax(setup):
    jcfg, cfg = setup[:2]
    assert xlstm.mlstm_dims(cfg) == jx.mlstm_dims(jcfg)
    assert xlstm.slstm_dims(cfg) == jx.slstm_dims(jcfg)
    assert xlstm.slstm_ff_dim(cfg) == jx.slstm_ff_dim(jcfg)
    assert xlstm.slstm_ff_dim(cfg.with_overrides(d_model=768)) == 1024
    _state_close(xlstm.init_mlstm_cache(cfg, 3), jx.init_mlstm_cache(jcfg, 3))
    _state_close(xlstm.init_slstm_state(cfg, 3),
                 jx.init_slstm_state(jcfg, 3))


def test_group_norm_uses_the_population_variance():
    """Rows with a non-zero mean and few elements, where ``torch.var``'s
    default (``correction=1``) would differ by a factor dh/(dh-1)."""
    xs = x((2, 3, 4, 8), 6) * 3.0 + 5.0
    scale = x((4, 8), 7) + 1.0
    want = jx._group_norm(jnp.asarray(scale), jnp.asarray(xs))
    got = xlstm._group_norm(_t(scale), _t(xs))
    close(got, want, 1e-5)
    assert abs(float(got.std(-1, unbiased=False).mean()) - float(
        np.abs(scale).mean())) < 2.0


def _ctx(mod, c, **kw):
    return mod.BlockCtx(cfg=c, **kw)


@pytest.mark.parametrize("slot", ["mlstm", "slstm"])
@pytest.mark.parametrize("active", [1.0, 0.0])
def test_slot_apply_step_and_prefill_chunk(slot, active):
    """The ``MLstm`` and ``SLstm`` slots' ``apply``, two ``prefill_chunk``s
    and a ``step``, against the JAX slots', as an active slot and as a pad
    slot (``active=0``: the identity, the cache unchanged)."""
    jcfg, cfg = cfgs("xlstm-125m")
    J, P = {"mlstm": (jblocks.MLstm, blocks.MLstm),
            "slstm": (jblocks.SLstm, blocks.SLstm)}[slot]
    jp, p = both(draw(lambda k: J.init(k, jcfg), 8))
    B, S = 2, 8
    xs = x((B, S, cfg.d_model), 9)
    ja, ta = jnp.float32(active), torch.tensor(active)
    want, _ = jax.jit(lambda p_, x_: J.apply(p_, x_, _ctx(
        jblocks, jcfg, active=ja, **F32)))(jp, jnp.asarray(xs))
    got, _ = P.apply(p, _t(xs), _ctx(blocks, cfg, active=ta,
                                     dtype=torch.float32))
    close(got, want, ATOL)
    jc = J.init_cache(jcfg, B, S)
    c = P.init_cache(cfg, B, S)
    c0 = tree.map(torch.clone, c)
    jchunk = jax.jit(lambda p_, x_, c_: J.prefill_chunk(
        p_, x_, c_, _ctx(jblocks, jcfg, pos=0, active=ja, **F32)))
    for start in (0, 4):
        xc = xs[:, start:start + 4]
        jy, jc = jchunk(jp, jnp.asarray(xc), jc)
        y, c = P.prefill_chunk(p, _t(xc), c, _ctx(
            blocks, cfg, pos=start, active=ta, dtype=torch.float32))
        close(y, jy, ATOL)
        _state_close(c, jc)
    x1 = x((B, 1, cfg.d_model), 10)
    jy, jc = jax.jit(lambda p_, x_, c_: J.step(p_, x_, c_, _ctx(
        jblocks, jcfg, pos=0, active=ja, **F32)))(jp, jnp.asarray(x1), jc)
    y, c = P.step(p, _t(x1), c, _ctx(blocks, cfg, pos=0, active=ta,
                                     dtype=torch.float32))
    close(y, jy, ATOL)
    _state_close(c, jc)
    if active == 0.0:
        assert torch.equal(y, _t(x1)) and torch.equal(got, _t(xs))
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(c),
                                                     tree.leaves(c0)))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs("xlstm-125m", num_layers=5)
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg), 11))
    return jcfg, cfg, jp, p


def test_sequential_lm_forward(model):
    """xlstm-125m reduced to 5 layers: 2 stages of (mlstm, slstm, mlstm),
    assignment [3, 2], so the last slot of stage 1 is a pad."""
    jcfg, cfg, jp, p = model
    assert cfg.slot_layout == ("mlstm", "slstm", "mlstm")
    assert M.default_assignment(cfg) == [3, 2]
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 20))
    want, _, _ = jax.jit(lambda p_, t_: JM.sequential_lm_forward(
        p_, jcfg, t_))(jp, jnp.asarray(toks))
    got, aux, _ = M.sequential_lm_forward(p, cfg, _t(toks))
    assert aux == 0.0
    close(got, want, ATOL_MODEL)


def test_chunked_prefill_then_decode_matches_the_full_forward(model):
    """Two chunks of 8 through every slot's ``prefill_chunk``, then 4
    ``sequential_decode_step``s, against the full forward at every
    position (as ``tests/test_arch_smoke.py:82-113`` holds decode), and
    the decode steps against the JAX package's from the same caches."""
    jcfg, cfg, jp, p = model
    B, S, T = 2, 16, 20
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, T))
    full, _, _ = M.sequential_lm_forward(p, cfg, _t(toks))
    caches = M.init_caches(cfg, batch=B, cache_len=T, dtype=torch.float32,
                           device="cpu")
    pm = M.pad_mask(cfg)
    for start in (0, 8):
        xc = p["embed"]["table"][_t(toks[:, start:start + 8]).long()]
        for s in range(cfg.pipeline_stages):
            for j, t in enumerate(cfg.slot_layout):
                xc, c_out = blocks.BLOCKS[t].prefill_chunk(
                    M._slot_params(p["blocks"][j], s), xc,
                    tree.map(lambda a: a[s], caches[j]),
                    blocks.BlockCtx(cfg=cfg, pos=start, dtype=torch.float32,
                                    active=pm[s, j]))
                for full_leaf, upd in zip(tree.leaves(caches[j]),
                                          tree.leaves(c_out)):
                    full_leaf[s] = upd
        close(M.head(p, cfg, xc), full[:, start:start + 8].numpy(),
              ATOL_MODEL)
    jc = jax.tree.map(lambda a: jnp.asarray(a.numpy()), caches)
    jstep = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    for t in range(S, T):
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                         jnp.int32(t))
        got, caches = M.sequential_decode_step(
            p, cfg, _t(toks[:, t:t + 1]), caches, t)
        close(got, want, ATOL_MODEL)
        close(got[:, 0], full[:, t].numpy(), ATOL_MODEL)


def test_decode_from_init_caches_matches_jax(model):
    """Decode from ``init_caches`` (``m`` at -1e30), logits and every cache
    leaf against the JAX package's."""
    jcfg, cfg, jp, p = model
    B = 2
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (B, 5))
    jc = JM.init_caches(jcfg, batch=B, cache_len=5, dtype=jnp.float32)
    c = M.init_caches(cfg, batch=B, cache_len=5, dtype=torch.float32,
                      device="cpu")
    _state_close(c, jc, 0.0)
    jstep = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    for t in range(5):
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                         jnp.int32(t))
        got, c = M.sequential_decode_step(p, cfg, _t(toks[:, t:t + 1]), c, t)
        close(got, want, ATOL_MODEL)
    _state_close(c, jc, 1e-2)


def test_params_from_numpy_carries_the_xlstm_tree():
    jcfg, cfg = cfgs("xlstm-125m")
    np_p = jax.tree.map(np.asarray, JM.init_params(KEY, jcfg))
    p = M.params_from_numpy(np_p)
    jl, pl = jax.tree.leaves(np_p), tree.leaves(p)
    assert len(jl) == len(pl)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(jl, pl))
    own = M.init_params(0, cfg, device="cpu")
    assert [tuple(a.shape) for a in tree.leaves(own)] == \
        [a.shape for a in jl]
