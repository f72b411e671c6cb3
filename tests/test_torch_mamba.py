"""The port's hybrid family (``repro_torch.models.mamba2``, the ``mamba``
and ``hybrid`` slots, zamba2 through ``model``) against the JAX package's,
on the CPU.

Weights are drawn with numpy in the JAX package's parameter layout, except
the SSM leaves ``A_log``, ``dt_bias``, ``D`` and ``conv_b``, which keep the
values the JAX init gives them (A in [-16, -1], dt near its bias range):
random ones would put the scan outside any range the model reaches. They
are carried into the port with ``params_from_numpy``; tokens and
activations come from numpy with a seed. The JAX side runs under
``jax.jit``; both run in f32. The scan runs as each package's own model
runs it on the CPU: the JAX package's jnp ``ssd_chunked``, the port's plain
version through the K5 wrapper (the CUDA kernel is held against it on the
card by ``chip_smoke.py``), with the same chunk length (the JAX mixer's,
halved until it divides the length).

Tolerance: 1e-4 abs, as ``tests/test_torch_transformer.py`` holds the
dense stack.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ssd_scan_kernel  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ATOL = 1e-4
KEY = jax.random.PRNGKey(0)
SSM_LEAVES = ("A_log", "dt_bias", "'D'", "conv_b")


def _cfgs(**kw):
    return (jax_config("zamba2-7b").reduced(**kw),
            get_config("zamba2-7b").reduced(**kw))


def _draw(init, seed=0):
    """Numpy weights of the shapes ``init`` (a JAX init taking a key)
    makes; the SSM leaves keep the JAX init's own values."""
    rng = np.random.default_rng(seed)
    own = init(KEY)

    def one(path, s, v):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in SSM_LEAVES):
            return np.asarray(v)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        scale = 0.1 if len(s.shape) == 1 or "'b'" in name else \
            s.shape[-2] ** -0.5
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, jax.eval_shape(init, KEY),
                                            own)


def _both(np_tree):
    return jax.tree.map(jnp.asarray, np_tree), M.params_from_numpy(np_tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cache(np_cache):
    return (jax.tree.map(jnp.asarray, np_cache),
            tree.map(lambda a: torch.from_numpy(np.array(a)), np_cache))


# ------------------------------- config ----------------------------------

def test_zamba2_config_is_a_copy_at_published_widths():
    assert jax_config("zamba2-7b").__dict__ == get_config("zamba2-7b").__dict__
    cfg = get_config("zamba2-7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.ssm_state,
            cfg.pipeline_stages, cfg.tensor_parallel) == (
        81, 3584, 32, 32, 112, 14_336, 32_000, 64, 16, 1)
    assert cfg.slot_layout == ("hybrid",) + ("mamba",) * 5
    assert M.default_assignment(cfg) == [6] + [5] * 15
    assert m2.dims(cfg) == (7168, 112, 64)
    # 11,003,722,752 parameters, as the JAX init makes them
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jax_config(
        "zamba2-7b")), KEY)
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == \
        11_003_722_752


def test_init_params_is_deterministic_and_has_the_jax_layout():
    jcfg, cfg = _cfgs()
    a = M.init_params(3, cfg, device="cpu")
    b = M.init_params(3, cfg, device="cpu")
    assert all(torch.equal(x, y)
               for x, y in zip(tree.leaves(a), tree.leaves(b)))
    shapes = [tuple(x.shape) for x in jax.tree.leaves(
        jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY))]
    assert [tuple(x.shape) for x in tree.leaves(a)] == shapes
    mixer = a["blocks"][1]["mixer"]
    H = m2.dims(cfg)[1]
    assert torch.allclose(-torch.exp(mixer["A_log"][0]),
                          -torch.linspace(1.0, 16.0, H))
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool(((dt > 0.00099) & (dt < 0.1001)).all())


# ------------------------------- mixers ----------------------------------

@pytest.fixture(scope="module")
def mixer_setup():
    jcfg, cfg = _cfgs()
    jp, p = _both(_draw(lambda k: jm2.init_mamba2(k, jcfg), 1))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("S", [40, 130, 256])
def test_mamba2_mixer(mixer_setup, S):
    """S=40: one chunk of 40; 130: the JAX chunk halves to 2 (65 chunks);
    256: two chunks of 128."""
    jcfg, cfg, jp, p = mixer_setup
    x = _x((2, S, cfg.d_model), S)
    want = jax.jit(lambda p_, x_: jm2.mamba2_mixer(
        p_, x_, cfg=jcfg, dtype=jnp.float32))(jp, jnp.asarray(x))
    got = m2.mamba2_mixer(p, torch.from_numpy(x), cfg=cfg,
                          dtype=torch.float32)
    _close(got, want)


def test_mamba2_mixer_chunk_continues_the_cache(mixer_setup):
    """Two chunks of 24 from an empty cache: outputs and caches against the
    JAX package's, and the chunks agree with the full-sequence mixer."""
    jcfg, cfg, jp, p = mixer_setup
    x = _x((2, 48, cfg.d_model), 3)
    jc, c = _cache(jax.tree.map(np.asarray, jm2.init_mamba2_cache(jcfg, 2)))
    jchunk = jax.jit(lambda p_, x_, c_: jm2.mamba2_mixer_chunk(
        p_, x_, c_, cfg=jcfg, dtype=jnp.float32))
    ys = []
    for s in (0, 24):
        jy, jc = jchunk(jp, jnp.asarray(x[:, s:s + 24]), jc)
        y, c = m2.mamba2_mixer_chunk(p, torch.from_numpy(x[:, s:s + 24]), c,
                                     cfg=cfg, dtype=torch.float32)
        _close(y, jy)
        _close(c["conv"], jc["conv"], 1e-5)
        _close(c["ssm"], jc["ssm"])
        ys.append(y)
    full = m2.mamba2_mixer(p, torch.from_numpy(x), cfg=cfg,
                           dtype=torch.float32)
    _close(torch.cat(ys, 1), full.numpy())


def test_mamba2_step(mixer_setup):
    """Six one-token steps from a non-zero cache against the JAX package's,
    and the steps agree with the chunked mixer over the same tokens."""
    jcfg, cfg, jp, p = mixer_setup
    B = 2
    shapes = jax.tree.map(np.asarray, jm2.init_mamba2_cache(jcfg, B))
    np_cache = {"conv": _x(shapes["conv"].shape, 4),
                "ssm": 0.3 * _x(shapes["ssm"].shape, 5)}
    jc, c = _cache(np_cache)
    c0 = tree.map(torch.clone, c)
    x = _x((B, 6, cfg.d_model), 6)
    jstep = jax.jit(lambda p_, x_, c_: jm2.mamba2_step(
        p_, x_, c_, cfg=jcfg, dtype=jnp.float32))
    ys = []
    for t in range(6):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = m2.mamba2_step(p, torch.from_numpy(x[:, t:t + 1]), c, cfg=cfg,
                              dtype=torch.float32)
        _close(y, jy)
        ys.append(y)
    _close(c["conv"], jc["conv"], 1e-5)
    _close(c["ssm"], jc["ssm"])
    yc, cc = m2.mamba2_mixer_chunk(p, torch.from_numpy(x), c0, cfg=cfg,
                                   dtype=torch.float32)
    _close(torch.cat(ys, 1), yc.numpy())
    _close(c["ssm"], cc["ssm"].numpy())


# -------------------------------- slots ----------------------------------

@pytest.mark.parametrize("slot", ["mamba", "hybrid"])
@pytest.mark.parametrize("active", [1.0, 0.0])
def test_slot_apply_prefill_chunk_and_step(slot, active):
    """Each slot's apply, two prefill chunks and two decode steps against
    the JAX package's, as an active slot and as a pad slot (an exact
    identity that leaves its cache as it was)."""
    flash = 1 if slot == "hybrid" else 0
    jcfg, cfg = _cfgs(use_flash_attention=flash)
    J, T = jblocks.BLOCKS[slot], blocks.BLOCKS[slot]
    jp, p = _both(_draw(lambda k: J.init(k, jcfg), 7))
    B, S, W = 2, 16, 20
    x = _x((B, S, cfg.d_model), 8)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    jact, act = jnp.float32(active), torch.tensor(active)
    want, _ = jax.jit(lambda p_, x_, pos_: J.apply(p_, x_, jblocks.BlockCtx(
        cfg=jcfg, positions=pos_, dtype=jnp.float32, active=jact)))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got, aux = T.apply(p, torch.from_numpy(x), blocks.BlockCtx(
        cfg=cfg, positions=torch.from_numpy(pos), dtype=torch.float32,
        active=act))
    assert aux == 0.0
    _close(got, want)
    if active == 0.0:
        assert torch.equal(got, torch.from_numpy(x))

    jc = jax.tree.map(np.asarray, J.init_cache(jcfg, B, W, jnp.float32))
    c = T.init_cache(cfg, B, W, torch.float32)
    assert [tuple(a.shape) for a in tree.leaves(c)] == \
        [a.shape for a in jax.tree.leaves(jc)]
    jc, c = jax.tree.map(jnp.asarray, jc), tree.map(torch.clone, c)
    c_empty = tree.map(torch.clone, c)
    jchunk = jax.jit(lambda p_, x_, c_, start: J.prefill_chunk(
        p_, x_, c_, jblocks.BlockCtx(cfg=jcfg, pos=start, dtype=jnp.float32,
                                     active=jact)), static_argnums=3)
    for start in (0, 8):
        xs = x[:, start:start + 8]
        jy, jc = jchunk(jp, jnp.asarray(xs), jc, start)
        y, c = T.prefill_chunk(p, torch.from_numpy(xs), c, blocks.BlockCtx(
            cfg=cfg, pos=start, dtype=torch.float32, active=act))
        _close(y, jy)
        for a, b in zip(tree.leaves(c), jax.tree.leaves(jc)):
            _close(a, b)
    _close(y, want[:, 8:])          # the chunks agree with the full apply
    jstep = jax.jit(lambda p_, x_, c_, pos_: J.step(
        p_, x_, c_, jblocks.BlockCtx(cfg=jcfg, pos=pos_, dtype=jnp.float32,
                                     active=jact)))
    xt = _x((B, 2, cfg.d_model), 9)
    for t in range(2):
        jy, jc = jstep(jp, jnp.asarray(xt[:, t:t + 1]), jc,
                       jnp.int32(S + t))
        y, c = T.step(p, torch.from_numpy(xt[:, t:t + 1]), c,
                      blocks.BlockCtx(cfg=cfg, pos=torch.tensor(S + t),
                                      dtype=torch.float32, active=act))
        _close(y, jy)
    for a, b in zip(tree.leaves(c), jax.tree.leaves(jc)):
        _close(a, b)
    if active == 0.0:
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(c),
                                                     tree.leaves(c_empty)))


def test_pad_slot_promotes_bf16_like_jax():
    """A 0-d f32 pad-mask entry lifts bf16 activations to f32 in JAX;
    the port's mamba slot follows (``blocks._promote``)."""
    _, cfg = _cfgs()
    p = M.init_params(0, cfg, device="cpu")
    slot = tree.map(lambda a: a[0], p["blocks"][1])
    x = torch.from_numpy(_x((1, 6, cfg.d_model), 10)).to(torch.bfloat16)
    ctx = blocks.BlockCtx(cfg=cfg, dtype=torch.bfloat16,
                          active=torch.tensor(0.0))
    y, _ = blocks.Mamba.apply(slot, x, ctx)
    assert y.dtype == torch.float32 and torch.equal(y, x.float())


# -------------------------------- model ----------------------------------

@pytest.fixture(scope="module")
def model_setup():
    jcfg, cfg = _cfgs()
    jp, p = _both(_draw(lambda k: JM.init_params(k, jcfg), 11))
    return jcfg, cfg, jp, p


def test_forward_runs_pad_slots_and_launches_nothing_on_the_cpu(model_setup):
    """zamba2 reduced: 2 stages of (hybrid, mamba), 4 layers, no pad slot;
    with 3 layers stage 1's mamba slot is a pad, which runs and is blended
    out, as in the JAX package."""
    jcfg, cfg, jp, p = model_setup
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 24))
    n0 = ssd_scan_kernel.launches
    for assignment in ([2, 2], [2, 1]):
        want = jax.jit(lambda p_, t_: JM.sequential_lm_forward(
            p_, jcfg, t_, assignment=assignment)[0])(jp, jnp.asarray(toks))
        got = M.sequential_lm_forward(p, cfg, torch.from_numpy(toks),
                                      assignment=assignment)[0]
        _close(got, want)
    assert ssd_scan_kernel.launches == n0


def test_sequential_decode_steps_and_caches_match_jax(model_setup):
    """8 decode steps from an empty cache, per-slot positions after the
    first, logits and every cache leaf (attn k/v, conv tail, SSM state)
    against the JAX package's."""
    jcfg, cfg, jp, p = model_setup
    B, W = 2, 12
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, 8))
    jc = JM.init_caches(jcfg, batch=B, cache_len=W, dtype=jnp.float32)
    c = M.init_caches(cfg, batch=B, cache_len=W, dtype=torch.float32,
                      device="cpu")
    assert [tuple(x.shape) for x in tree.leaves(c)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    jstep = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    for t in range(8):
        pos = 0 if t == 0 else np.array([t, t + 3], np.int32)
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                         jnp.asarray(pos))
        got, c = M.sequential_decode_step(
            p, cfg, torch.from_numpy(toks[:, t:t + 1]), c,
            torch.as_tensor(pos))
        _close(got, want)
    for a, b in zip(tree.leaves(c), jax.tree.leaves(jc)):
        _close(a, b)


@pytest.mark.parametrize("flash", [0, 1])
def test_decode_matches_full_forward(model_setup, flash):
    """tests/test_arch_smoke.py:82-113 on the port: a full forward's
    logits at every position against decode steps from an empty cache,
    and against chunked prefill through every slot's ``prefill_chunk``."""
    _, cfg, _, p = model_setup
    cfg = cfg.with_overrides(use_flash_attention=flash)
    B, T = 2, 16
    toks = torch.from_numpy(
        np.random.default_rng(14).integers(0, cfg.vocab_size, (B, T)))
    full = M.sequential_lm_forward(p, cfg, toks)[0]
    c = M.init_caches(cfg, batch=B, cache_len=T, dtype=torch.float32,
                      device="cpu")
    for t in range(T):
        lg, c = M.sequential_decode_step(p, cfg, toks[:, t:t + 1], c, t)
        _close(lg[:, 0], full[:, t].numpy())
    c = M.init_caches(cfg, batch=B, cache_len=T, dtype=torch.float32,
                      device="cpu")
    pm = M.pad_mask(cfg)
    for start in (0, 8):
        x = p["embed"]["table"][toks[:, start:start + 8]]
        for s in range(cfg.pipeline_stages):
            for j, t in enumerate(cfg.slot_layout):
                x, c_out = blocks.BLOCKS[t].prefill_chunk(
                    M._slot_params(p["blocks"][j], s), x,
                    tree.map(lambda a: a[s], c[j]),
                    blocks.BlockCtx(cfg=cfg, pos=start, dtype=torch.float32,
                                    active=pm[s, j]))
                for full_leaf, upd in zip(tree.leaves(c[j]),
                                          tree.leaves(c_out)):
                    full_leaf[s] = upd
        _close(M.head(p, cfg, x), full[:, start:start + 8].numpy())
