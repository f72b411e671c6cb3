"""The port's audio family (Whisper: the ``enc`` and ``dec`` slots,
``embed_frames``, ``sequential_encdec_forward`` and decode with
``kv_source``; whisper-base reduced) against the JAX package's, on the
CPU.

Weights are drawn with numpy in the JAX package's layout (biased
LayerNorms with non-zero biases) and carried across with
``params_from_numpy``; frames and tokens from numpy with a seed; both
sides in f32, the JAX side under ``jax.jit``. Tolerance 1e-4 abs, as
``tests/test_torch_transformer.py``.

Flash attention: with ``use_flash_attention=1`` the JAX package's wrapper
zero-pads the keys to a multiple of 128, and its kernel admits the padded
keys when ``causal=False`` (ROADMAP Queue 3), which is what Whisper's
encoder runs. So the port's flash path is held against the JAX package's
dense path (``use_flash_attention=0``) at every frame count, a ragged 40
included, and against the JAX flash path only where the frame count is a
multiple of 128.
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
from repro_torch import tree  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs("whisper-base")
    jp, p = both(draw(lambda k: JM.init_params(k, jcfg), 1))
    return jcfg, cfg, jp, p


def test_layout_and_params(model):
    """Two stages of one encoder and one decoder slot; the decoder stack in
    ``dec_blocks``; a biased final LayerNorm; every leaf carried across."""
    jcfg, cfg, jp, p = model
    assert cfg.slot_layout == ("enc",) and cfg.decoder_slot_layout == ("dec",)
    assert M.decoder_assignment(cfg) == JM.decoder_assignment(jcfg) == [1, 1]
    assert M.default_assignment(cfg) == JM.default_assignment(jcfg)
    assert set(p["final_norm"]) == {"scale", "bias"}
    own = M.init_params(0, cfg, device="cpu")
    assert [tuple(a.shape) for a in tree.leaves(own)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    assert set(own["dec_blocks"][0]["xattn"]["wq"]) == {"w"}   # no qkv bias


def test_embed_frames_and_token_positions(model):
    jcfg, cfg, jp, p = model
    frames = x((2, 40, cfg.d_model), 2)
    want, wpos = JM.embed_frames(jcfg, jnp.asarray(frames), jnp.float32)
    got, pos = M.embed_frames(cfg, _t(frames), torch.float32)
    close(got, want, 1e-6)
    assert np.array_equal(pos.numpy(), np.asarray(wpos))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    want, _, _ = JM.embed(jp, jcfg, jnp.asarray(toks), dtype=jnp.float32)
    got, _, _ = M.embed(p, cfg, _t(toks), dtype=torch.float32)
    close(got, want, 1e-6)


def _slot_ctx(mod, c, dtype, **kw):
    return mod.BlockCtx(cfg=c, dtype=dtype, **kw)


@pytest.mark.parametrize("flash", [0, 1])
def test_enc_and_dec_apply(model, flash):
    """One ``Enc`` and one ``Dec`` slot's ``apply`` (the decoder
    cross-attending over 40 encoder rows), the port's flash path against
    the JAX dense path; ``Enc.step`` raises in both."""
    jcfg, cfg, jp, p = model
    jcfg0 = jcfg.with_overrides(use_flash_attention=0)
    cfg = cfg.with_overrides(use_flash_attention=flash)
    je, e = (JM._slot_params(jp["blocks"][0], 0),
             M._slot_params(p["blocks"][0], 0))
    jd, d = (JM._slot_params(jp["dec_blocks"][0], 1),
             M._slot_params(p["dec_blocks"][0], 1))
    xe, xd = x((2, 40, cfg.d_model), 4), x((2, 9, cfg.d_model), 5)
    pe = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
    pd = np.arange(9, dtype=np.int32)[None].repeat(2, 0)
    want, _ = jax.jit(lambda p_, x_, pos_: jblocks.Enc.apply(
        p_, x_, _slot_ctx(jblocks, jcfg0, jnp.float32, positions=pos_)))(
        je, jnp.asarray(xe), jnp.asarray(pe))
    got, _ = blocks.Enc.apply(e, _t(xe), _slot_ctx(
        blocks, cfg, torch.float32, positions=_t(pe)))
    close(got, want, ATOL)
    want, _ = jax.jit(lambda p_, x_, pos_, kv_: jblocks.Dec.apply(
        p_, x_, _slot_ctx(jblocks, jcfg0, jnp.float32, positions=pos_,
                          kv_source=kv_)))(
        jd, jnp.asarray(xd), jnp.asarray(pd), jnp.asarray(xe))
    got, _ = blocks.Dec.apply(d, _t(xd), _slot_ctx(
        blocks, cfg, torch.float32, positions=_t(pd), kv_source=_t(xe)))
    close(got, want, ATOL)
    with pytest.raises(NotImplementedError):
        blocks.Enc.step(e, _t(xd[:, :1]), None, None)


def test_dec_step_matches_jax_and_apply(model):
    """``Dec.step`` from an empty cache, 9 steps with ``kv_source``, against
    the JAX slot's steps and against ``Dec.apply`` over the 9 rows."""
    jcfg, cfg, jp, p = model
    jd, d = (JM._slot_params(jp["dec_blocks"][0], 0),
             M._slot_params(p["dec_blocks"][0], 0))
    B, S = 2, 9
    xd, kv = x((B, S, cfg.d_model), 6), x((B, 40, cfg.d_model), 7)
    pd = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    full, _ = blocks.Dec.apply(d, _t(xd), _slot_ctx(
        blocks, cfg, torch.float32, positions=_t(pd), kv_source=_t(kv)))
    jc = jblocks.Dec.init_cache(jcfg, B, S, jnp.float32)
    c = blocks.Dec.init_cache(cfg, B, S, torch.float32)
    jstep = jax.jit(lambda p_, x_, c_, pos_, kv_: jblocks.Dec.step(
        p_, x_, c_, _slot_ctx(jblocks, jcfg, jnp.float32, pos=pos_,
                              kv_source=kv_, active=jnp.float32(1.0))))
    for t in range(S):
        want, jc = jstep(jd, jnp.asarray(xd[:, t:t + 1]), jc, jnp.int32(t),
                         jnp.asarray(kv))
        got, c = blocks.Dec.step(d, _t(xd[:, t:t + 1]), c, _slot_ctx(
            blocks, cfg, torch.float32, pos=t, kv_source=_t(kv),
            active=torch.tensor(1.0)))
        close(got, want, ATOL)
        close(got[:, 0], full[:, t].numpy(), ATOL)
    close(c["attn"]["k"], jc["attn"]["k"], 1e-5)


@pytest.mark.parametrize("frames,flash,jflash", [
    (16, 0, 0), (16, 1, 0), (40, 1, 0), (128, 1, 1)])
def test_sequential_encdec_forward(model, frames, flash, jflash):
    jcfg, cfg, jp, p = model
    jcfg = jcfg.with_overrides(use_flash_attention=jflash)
    cfg = cfg.with_overrides(use_flash_attention=flash)
    fr = x((2, frames, cfg.d_model), 8)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12))
    want, _, wmask = jax.jit(lambda p_, f_, t_: JM.sequential_encdec_forward(
        p_, jcfg, f_, t_))(jp, jnp.asarray(fr), jnp.asarray(toks))
    got, aux, mask = M.sequential_encdec_forward(p, cfg, _t(fr), _t(toks))
    assert tuple(got.shape) == (2, 12, cfg.vocab_size) and aux == 0.0
    close(got, want, ATOL)
    close(mask, wmask, 0)


def _encode(p, cfg, frames):
    xe, pos = M.embed_frames(cfg, frames, torch.float32)
    xe, _ = M.forward_blocks(p["blocks"], cfg.slot_layout, xe,
                             blocks.BlockCtx(cfg=cfg, positions=pos,
                                             dtype=torch.float32,
                                             causal=False), M.pad_mask(cfg))
    return xe


def test_decode_with_kv_source_matches_the_full_forward_and_jax(model):
    """10 ``sequential_decode_step``s over the decoder layout's caches,
    cross-attending to the encoder's output, against the full forward at
    every position (as ``tests/test_arch_smoke.py:90-113``) and against
    the JAX package's decode steps."""
    jcfg, cfg, jp, p = model
    B, T = 2, 10
    fr = x((B, 40, cfg.d_model), 10)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, T))
    full, _, _ = M.sequential_encdec_forward(p, cfg, _t(fr), _t(toks))
    kv = _encode(p, cfg, _t(fr))
    c = M.init_caches(cfg, batch=B, cache_len=T, dtype=torch.float32,
                      layout=cfg.decoder_slot_layout, device="cpu")
    jc = JM.init_caches(jcfg, batch=B, cache_len=T, dtype=jnp.float32,
                        layout=jcfg.decoder_slot_layout)
    jstep = jax.jit(lambda p_, t_, c_, pos_, kv_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_, kv_source=kv_))
    jkv = jnp.asarray(kv.numpy())
    for t in range(T):
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t),
                         jkv)
        got, c = M.sequential_decode_step(p, cfg, _t(toks[:, t:t + 1]), c, t,
                                          kv_source=kv)
        close(got, want, ATOL)
        close(got[:, 0], full[:, t].numpy(), ATOL)
