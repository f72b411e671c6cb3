"""The port's dense transformer stack (``repro_torch.models``: modules,
attention, blocks, model) against the JAX package's, on the CPU.

Weights are drawn with numpy in the JAX package's parameter layout (its
``init_params`` shapes, with non-zero biases and norm scales) and carried
into the port with ``params_from_numpy``; tokens and activations come from
numpy with a seed. The JAX side runs under ``jax.jit``.
Both sides run in f32 (the reduced configs' dtype). Flash attention runs
as each package's own tests run it on the CPU: the JAX package's Pallas
kernel in interpret mode, the port's plain version (the CUDA kernel is
held against that version on the card by ``chip_smoke.py``).

Tolerance: 1e-4 abs, as ``tests/test_perf_features.py:99-106`` holds the
JAX package's flash path to its own jnp path. The two packages sum in
different orders (XLA vs. oneDNN matmuls, blocked vs. dense softmax);
measured differences are ~1e-5 on 4-layer models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import KEY, x as _x  # noqa: E402
from _torch_parity import both as _both, cfgs as _cfgs  # noqa: E402
from _torch_parity import close, draw as _draw  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as jmod  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import modules  # noqa: E402
from repro_torch.models.tp import TP  # noqa: E402

ATOL = 1e-4


def _close(got, want, atol=ATOL):
    close(got, want, atol)


# ------------------------------ configs, tree ----------------------------

def test_configs_are_copies():
    for arch in ("qwen2-1.5b", "llama3-8b", "chatglm3-6b", "whisper-base"):
        a, b = jax_config(arch), get_config(arch)
        assert a.__dict__ == b.__dict__
    cfg = get_config("qwen2-1.5b").with_overrides(tensor_parallel=1,
                                                  use_flash_attention=1)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.padded_vocab) == (
        28, 1536, 12, 2, 128, 8960, 151_936)
    assert cfg.layers_per_stage * cfg.pipeline_stages == 28


def test_params_from_numpy_keeps_structure_and_jax_tree_order():
    jcfg, _ = _cfgs("qwen2-1.5b", num_layers=4)
    jp, p = _both(_draw(lambda k: JM.init_params(k, jcfg)))
    assert isinstance(p["blocks"], list) and len(p["blocks"]) == 2
    jl = jax.tree.leaves(jp)
    pl, paths = tree.flatten(p)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.array_equal(np.asarray(a), b.numpy())
    assert tree.unflatten(paths, pl)["blocks"][1]["attn"]["wq"]["b"] is \
        p["blocks"][1]["attn"]["wq"]["b"]


def test_init_params_is_deterministic_in_the_seed_and_has_the_layout():
    jcfg, cfg = _cfgs("qwen2-1.5b", num_layers=4)
    a = M.init_params(3, cfg, device="cpu")
    b = M.init_params(3, cfg, device="cpu")
    c = M.init_params(4, cfg, device="cpu")
    la, lb, lc = tree.leaves(a), tree.leaves(b), tree.leaves(c)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    shapes = [tuple(x.shape) for x in jax.tree.leaves(
        jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY))]
    assert [tuple(x.shape) for x in la] == shapes


def test_unported_parts_raise():
    """Only tensor parallelism (ROADMAP Queue 1 item 12) still raises:
    every slot type of the JAX package is a real slot of the port, and
    ``init_params`` builds every architecture at reduced size with the
    JAX package's leaf shapes."""
    with pytest.raises(NotImplementedError, match="item 12"):
        TP("tensor", 2)
    assert set(blocks.BLOCKS) == set(jblocks.BLOCKS)
    for name, slot in blocks.BLOCKS.items():
        assert isinstance(slot, type) and callable(slot.init), name
    for arch in ARCH_IDS:
        jcfg, cfg = _cfgs(arch)
        shapes = [tuple(x.shape) for x in jax.tree.leaves(
            jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY))]
        p = M.init_params(0, cfg, device="cpu")
        assert [tuple(x.shape) for x in tree.leaves(p)] == shapes, arch


# ------------------------------- modules ---------------------------------

def test_rmsnorm_and_dense_with_bias():
    x = _x((2, 5, 64), 0)
    p = {"scale": _x((64,), 1) + 1.0, "bias": _x((64,), 2)}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(modules.rmsnorm(pt, torch.from_numpy(x)),
           jmod.rmsnorm(p, jnp.asarray(x)), 1e-5)
    _close(modules.layernorm(pt, torch.from_numpy(x)),
           jmod.layernorm(p, jnp.asarray(x)), 1e-5)
    d = {"w": _x((64, 48), 3), "b": _x((48,), 4)}
    dt = {k: torch.from_numpy(v) for k, v in d.items()}
    _close(modules.dense(dt, torch.from_numpy(x), torch.float32),
           jmod.dense(d, jnp.asarray(x), jnp.float32), 1e-4)
    got = modules.dense(dt, torch.from_numpy(x), torch.bfloat16)
    want = jmod.dense(d, jnp.asarray(x), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.25,
                               rtol=2e-2)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    x = _x((2, 7, 4, 32), 5)
    pos = np.arange(100, 107, dtype=np.int32)[None].repeat(2, 0)
    got = modules.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e4, fraction)
    want = jmod.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, fraction)
    _close(got, want, 1e-5)
    if fraction < 1:
        assert torch.equal(got[..., 16:], torch.from_numpy(x)[..., 16:])


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "relu6"])
def test_activation(name):
    x = _x((64,), 6) * 4
    _close(modules.activation(name)(torch.from_numpy(x)),
           jmod.activation(name)(jnp.asarray(x)), 1e-6)


# ------------------------------ attention --------------------------------

@pytest.fixture(scope="module")
def attn_setup():
    jcfg, cfg = _cfgs("qwen2-1.5b", num_layers=2)
    jp, p = _both(_draw(lambda k: jattn.init_attention(k, jcfg), 1))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("flash", [0, 1])
@pytest.mark.parametrize("window", [0, 8])
def test_attention(attn_setup, flash, window):
    jcfg, cfg, jp, p = attn_setup
    jcfg = jcfg.with_overrides(use_flash_attention=flash)
    cfg = cfg.with_overrides(use_flash_attention=flash)
    x = _x((2, 24, cfg.d_model), 7)
    pos = np.arange(24, dtype=np.int32)[None].repeat(2, 0)
    want = jax.jit(lambda p_, x_, pos_: jattn.attention(
        p_, x_, cfg=jcfg, positions=pos_, window=window,
        dtype=jnp.float32))(jp, jnp.asarray(x), jnp.asarray(pos))
    got = attn.attention(p, torch.from_numpy(x), cfg=cfg,
                         positions=torch.from_numpy(pos), window=window,
                         dtype=torch.float32)
    _close(got, want)


@pytest.mark.parametrize("flash", [0, 1])
def test_chunk_attention(attn_setup, flash):
    jcfg, cfg, jp, p = attn_setup
    jcfg = jcfg.with_overrides(use_flash_attention=flash)
    cfg = cfg.with_overrides(use_flash_attention=flash)
    B, L, W, start = 2, 8, 40, 16
    k0 = _x((B, W, cfg.num_kv_heads, cfg.head_dim), 8)
    k0[:, start:] = 0.0
    cache_np = {"k": k0, "v": _x(k0.shape, 9) * (k0 != 0)}
    x = _x((B, L, cfg.d_model), 10)
    want, wc = jax.jit(lambda p_, x_, c_: jattn.chunk_attention(
        p_, x_, c_, cfg=jcfg, start=start, dtype=jnp.float32))(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache_np))
    got, gc = attn.chunk_attention(
        p, torch.from_numpy(x), tree.map(torch.from_numpy, cache_np),
        cfg=cfg, start=start, dtype=torch.float32)
    _close(got, want)
    _close(gc["k"], wc["k"], 1e-5)
    _close(gc["v"], wc["v"], 1e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention(attn_setup, per_slot):
    jcfg, cfg, jp, p = attn_setup
    B, W = 3, 12
    cache_np = {"k": _x((B, W, cfg.num_kv_heads, cfg.head_dim), 11),
                "v": _x((B, W, cfg.num_kv_heads, cfg.head_dim), 12)}
    x = _x((B, 1, cfg.d_model), 13)
    pos = np.array([3, 11, 17], np.int32) if per_slot else 5   # 17 wraps
    want, wc = jax.jit(lambda p_, x_, c_, pos_: jattn.decode_attention(
        p_, x_, c_, cfg=jcfg, pos=pos_, dtype=jnp.float32))(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache_np),
        jnp.asarray(pos))
    cache = tree.map(torch.from_numpy, cache_np)
    got, gc = attn.decode_attention(
        p, torch.from_numpy(x), cache, cfg=cfg,
        pos=torch.as_tensor(pos), dtype=torch.float32)
    _close(got, want)
    _close(gc["k"], wc["k"], 1e-5)
    assert np.array_equal(cache["k"].numpy(), cache_np["k"])   # not written


# -------------------------------- blocks ---------------------------------

@pytest.mark.parametrize("flash", [0, 1])
def test_dense_block_apply_and_prefill_chunk(flash):
    jcfg, cfg = _cfgs("qwen2-1.5b", num_layers=2, use_flash_attention=flash)
    jp, p = _both(_draw(lambda k: jblocks.Dense.init(k, jcfg), 2))
    B, S, W = 2, 16, 24
    x = _x((B, S, cfg.d_model), 14)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    want, _ = jax.jit(lambda p_, x_, pos_: jblocks.Dense.apply(
        p_, x_, jblocks.BlockCtx(cfg=jcfg, positions=pos_,
                                 dtype=jnp.float32)))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    ctx = blocks.BlockCtx(cfg=cfg, positions=torch.from_numpy(pos),
                          dtype=torch.float32)
    got, _ = blocks.Dense.apply(p, torch.from_numpy(x), ctx)
    _close(got, want)

    # two chunks of 8 into an empty cache, as chunked prefill runs them
    jchunk = jax.jit(lambda p_, x_, c_, start: jblocks.Dense.prefill_chunk(
        p_, x_, c_, jblocks.BlockCtx(cfg=jcfg, pos=start, dtype=jnp.float32,
                                     active=jnp.float32(1.0))),
        static_argnums=3)
    jc = jblocks.Dense.init_cache(jcfg, B, W, jnp.float32)
    c = blocks.Dense.init_cache(cfg, B, W, torch.float32)
    for start in (0, 8):
        xs = x[:, start:start + 8]
        jy, jc = jchunk(jp, jnp.asarray(xs), jc, start)
        y, c = blocks.Dense.prefill_chunk(
            p, torch.from_numpy(xs), c,
            blocks.BlockCtx(cfg=cfg, pos=start, dtype=torch.float32,
                            active=torch.tensor(1.0)))
        _close(y, jy)
        _close(c["attn"]["k"], jc["attn"]["k"], 1e-5)
        _close(c["attn"]["v"], jc["attn"]["v"], 1e-5)
    _close(y, want[:, 8:])          # the chunks agree with the full apply


def test_pad_slot_is_identity_and_promotes_like_jax():
    jcfg, cfg = _cfgs("qwen2-1.5b", num_layers=2)
    p = M.init_params(0, cfg, device="cpu")
    slot = tree.map(lambda a: a[0], p["blocks"][0])
    x = torch.from_numpy(_x((1, 6, cfg.d_model), 15)).to(torch.bfloat16)
    pos = torch.arange(6, dtype=torch.int32)[None]
    ctx = blocks.BlockCtx(cfg=cfg, positions=pos, dtype=torch.bfloat16,
                          active=torch.tensor(0.0))
    y, _ = blocks.Dense.apply(slot, x, ctx)
    assert y.dtype == torch.float32 and torch.equal(y, x.float())
    jy = jax.eval_shape(lambda s_, x_: jblocks.Dense.apply(
        s_, x_, jblocks.BlockCtx(cfg=jcfg, positions=jnp.asarray(pos.numpy()),
                                 dtype=jnp.bfloat16,
                                 active=jnp.float32(0.0)))[0],
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                     slot), jax.ShapeDtypeStruct(x.shape, jnp.bfloat16))
    assert jy.dtype == jnp.float32
    ctx1 = blocks.BlockCtx(cfg=cfg, positions=pos, dtype=torch.bfloat16)
    assert blocks.Dense.apply(slot, x, ctx1)[0].dtype == torch.bfloat16


# --------------------------------- model ---------------------------------

@pytest.mark.parametrize("arch,flash", [
    (arch, flash) for arch in ("qwen2-1.5b", "llama3-8b", "zamba2-7b",
                               "chatglm3-6b", "granite-3-8b",
                               "llava-next-mistral-7b")
    for flash in (0, 1)])
def test_sequential_lm_forward(arch, flash):
    """Logits and loss mask against the JAX package's: chatglm3-6b rotates
    half of each head (``rope_fraction=0.5``) with qkv biases, and the vlm
    (llava-next-mistral-7b) runs a 12-token patch prefix through
    ``embed(prefix=...)``."""
    jcfg, cfg = _cfgs(arch, num_layers=4, use_flash_attention=flash)
    jp, p = _both(_draw(lambda k: JM.init_params(k, jcfg), 3))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    pre = (_x((2, 12, cfg.d_model), 9),) if cfg.family == "vlm" else ()
    want, _, wmask = jax.jit(lambda p_, t_, *x_: JM.sequential_lm_forward(
        p_, jcfg, t_, prefix=x_[0] if x_ else None))(
            jp, jnp.asarray(toks), *map(jnp.asarray, pre))
    got, aux, mask = M.sequential_lm_forward(
        p, cfg, torch.from_numpy(toks),
        prefix=torch.from_numpy(pre[0]) if pre else None)
    S = 40 + (12 if pre else 0)
    assert tuple(got.shape) == (2, S, cfg.vocab_size) and aux == 0.0
    _close(got, want)
    _close(mask, wmask, 0)
    if pre:
        assert float(mask[:, :12].abs().sum()) == 0.0


def test_sequential_decode_steps_match_jax():
    """6 decode steps from an empty cache, per-slot positions, scalar pos
    on the first step; logits and caches against the JAX package's."""
    jcfg, cfg = _cfgs("qwen2-1.5b", num_layers=4)
    jp, p = _both(_draw(lambda k: JM.init_params(k, jcfg), 4))
    B, W = 2, 8
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 6))
    jc = JM.init_caches(jcfg, batch=B, cache_len=W, dtype=jnp.float32)
    c = M.init_caches(cfg, batch=B, cache_len=W, dtype=torch.float32,
                      device="cpu")
    assert [tuple(x.shape) for x in tree.leaves(c)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    jstep = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    for t in range(6):
        pos = 0 if t == 0 else np.array([t, t + 2], np.int32)
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                         jnp.asarray(pos))
        got, c = M.sequential_decode_step(
            p, cfg, torch.from_numpy(toks[:, t:t + 1]), c,
            torch.as_tensor(pos))
        _close(got, want)
    for a, b in zip(tree.leaves(c), jax.tree.leaves(jc)):
        _close(a, b, 1e-5)
