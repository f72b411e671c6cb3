"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both packages: the JAX
side through ``repro.kernels.flash_attention`` as its own tests run it
(interpret-mode Pallas on the CPU), the port through its wrappers, which
take the plain version (``ref.py``) for CPU tensors — the version the CUDA
kernel (K4) is held against on the card (``chip_smoke.py`` phase A).

Tolerances are the JAX package's own (``tests/test_kernels.py:31``):
5e-5 max abs in f32, 2e-2 in bf16 (the output is rounded to bf16); the
blocked and the dense sums are added in different orders. Gradients: 1e-4
(``tests/test_kernels.py:47-55``).

Non-causal attention over a ragged ``Skv`` is held against the JAX
package's dense ``attention_reference``, not its flash wrapper: that
wrapper zero-pads k and v to a block multiple and its kernel's mask then
admits the zero keys (ROADMAP Queue 3). The port masks the true ``Skv``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.kernels.flash_attention import (  # noqa: E402
    attention_reference as jax_reference, flash_attention as jax_flash)
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel as jax_flash_kernel)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention, flash_attention_kernel)

TOL = {"float32": 5e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, H, Hkv, Sq, Skv, dh, seed, dtype="float32"):
    """The same q, k, v in both packages (numpy f32, each cast to the
    dtype by round-to-nearest-even on both sides)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, dh), (B, Hkv, Skv, dh), (B, Hkv, Skv, dh))]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# the six cases of tests/test_kernels.py:17-24
@pytest.mark.parametrize(
    "B,H,Hkv,S,dh,causal,window,dtype",
    [(2, 4, 2, 256, 64, True, 0, "float32"),
     (1, 4, 4, 128, 64, False, 0, "float32"),
     (2, 8, 2, 200, 64, True, 64, "float32"),     # ragged + window
     (1, 2, 1, 384, 128, True, 0, "float32"),
     (1, 4, 2, 128, 64, True, 0, "bfloat16"),
     (2, 2, 2, 96, 32, True, 32, "bfloat16")])
def test_flash_attention_matches_jax(B, H, Hkv, S, dh, causal, window,
                                     dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Hkv, S, S, dh, S + dh, dtype)
    want = jax_flash(jq, jk, jv, causal, window, 128, 128, True)
    got = flash_attention(q, k, v, causal, window)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, H, S, dh)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])
    direct = flash_attention_kernel(q, k, v, causal=causal, window=window)
    assert torch.equal(direct, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_112_matches_jax(dtype):
    """zamba2-7b's attention head dim (the kernel's dh=112 instance), held
    against the JAX package's flash attention (interpret mode) and its
    dense reference."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 4, 160, 160, 112, 112, dtype)
    got = flash_attention(q, k, v, True, 0)
    assert got.dtype == q.dtype and tuple(got.shape) == (1, 4, 160, 112)
    want = jax_flash(jq, jk, jv, True, 0, 128, 128, True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])
    want = jax_reference(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])


@pytest.mark.parametrize("L,start", [(64, 128), (40, 88)])
def test_q_offset_chunk_matches_jax_kernel(L, start):
    """A chunk of queries at global positions start + [0, L) over the
    whole kv, as chunked prefill calls it (tests/test_perf_features.py:132)."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 2, 256, 256, 64, L)
    want = jax_flash_kernel(jq[:, :, start:start + L], jk, jv,
                            jnp.array([start]), causal=True)
    got = flash_attention_kernel(q[:, :, start:start + L], k, v, start,
                                 causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-5)
    # a one-element int tensor as the offset, as the JAX package passes it
    same = flash_attention_kernel(q[:, :, start:start + L], k, v,
                                  torch.tensor([start]), causal=True)
    assert torch.equal(same, got)


def test_chunks_reassemble_the_full_attention():
    (_, _, _), (q, k, v) = _qkv(1, 2, 2, 256, 256, 64, 3)
    full = flash_attention_kernel(q, k, v, causal=True)
    parts = [flash_attention_kernel(q[:, :, s:s + 64], k, v, s, causal=True)
             for s in range(0, 256, 64)]
    np.testing.assert_allclose(_f32(torch.cat(parts, dim=2)), _f32(full),
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 16])
def test_non_causal_ragged_kv_masks_the_true_length(window):
    """B=1, H=4, Hkv=2, S=40, dh=32: held against the JAX package's dense
    reference (its flash wrapper admits the zero-padded keys here)."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 2, 40, 40, 32, 40)
    want = jax_reference(jq, jk, jv, causal=False, window=window)
    got = flash_attention(q, k, v, False, window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=5e-5)


def test_bf16_queries_over_f32_cache():
    """chunk_attention hands the kernel q in the compute dtype and k/v in
    the cache's: each is read in its own type."""
    (_, jk, jv), (q, k, v) = _qkv(1, 4, 2, 64, 96, 64, 5)
    qb = q.to(torch.bfloat16)
    got = flash_attention_kernel(qb, k, v, 32, causal=True)
    want = jax_flash_kernel(jnp.asarray(qb.float().numpy(), jnp.bfloat16),
                            jk, jv, jnp.array([32]), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2)


def test_grad_matches_jax():
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 2, 64, 64, 32, 11)
    g_j = jax.grad(lambda a: jnp.sum(
        jax_flash(a, jk, jv, True, 0, 32, 32, True) ** 2))(jq)
    qg = q.clone().requires_grad_(True)
    (flash_attention(qg, k, v, True, 0) ** 2).sum().backward()
    np.testing.assert_allclose(_f32(qg.grad), np.asarray(g_j), atol=1e-4)


def test_grad_of_all_inputs_matches_the_plain_version():
    _, (q, k, v) = _qkv(1, 4, 2, 48, 48, 32, 12)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*ins, True, 16).pow(2).sum().backward()
    attention_reference(*ref_ins, causal=True, window=16).pow(2).sum() \
        .backward()
    for a, b in zip(ins, ref_ins):
        assert torch.allclose(a.grad, b.grad, atol=1e-6)


def test_kernel_wrapper_raises_instead_of_falling_back():
    n0 = flash_attention_kernel.launches
    _, (q, k, v) = _qkv(1, 2, 1, 8, 8, 32, 0)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_kernel(*(torch.zeros(1, 2, 8, 48),) * 3)
    with pytest.raises(ValueError):                     # meta device
        flash_attention_kernel(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):                     # mixed devices
        flash_attention_kernel(q, k.to("meta"), v)
    with pytest.raises(ValueError):                     # k and v differ
        flash_attention_kernel(q, k, v.to(torch.bfloat16))
    with pytest.raises(ValueError):                     # f16 is not taken
        flash_attention_kernel(q.half(), k, v)
    with pytest.raises(ValueError):                     # 3 kv heads for 2
        flash_attention_kernel(q, torch.zeros(1, 3, 8, 32),
                               torch.zeros(1, 3, 8, 32))
    flash_attention_kernel(q, k, v)                     # CPU: plain version
    assert flash_attention_kernel.launches == n0


# ------------------------- routing (no card needed) -----------------------

from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _strides, launch_plan, prepare)
from repro_torch.models import attention as attn  # noqa: E402


def _views(kind, dt, dh, B=2, H=4, Hkv=2, S=48):
    """q, k, v of one layout: ``contiguous`` [B, heads, S, dh]; ``model``,
    the [B, S, heads, dh].transpose(1, 2) views ``attention()`` passes;
    ``cache``, a 16-row chunk over a slice of a [B, S + 8, Hkv, dh] cache,
    as ``chunk_attention()`` passes it."""
    dq, dkv = dt
    if kind == "contiguous":
        return (torch.zeros(B, H, S, dh, dtype=dq),
                torch.zeros(B, Hkv, S, dh, dtype=dkv),
                torch.zeros(B, Hkv, S, dh, dtype=dkv))
    if kind == "model":
        return (torch.zeros(B, S, H, dh, dtype=dq).transpose(1, 2),
                torch.zeros(B, S, Hkv, dh, dtype=dkv).transpose(1, 2),
                torch.zeros(B, S, Hkv, dh, dtype=dkv).transpose(1, 2))
    cache = torch.zeros(2, B, S + 8, Hkv, dh, dtype=dkv)
    return (torch.zeros(B, 16, H, dh, dtype=dq).transpose(1, 2),
            cache[0, :, :S].transpose(1, 2), cache[1, :, :S].transpose(1, 2))


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("kind", ["contiguous", "model", "cache"])
@pytest.mark.parametrize("dh", [32, 64, 112, 128])
@pytest.mark.parametrize("dt,route", [((BF16, BF16), 1), ((F32, F32), 2),
                                      ((BF16, F32), 2), ((F32, BF16), 2)])
def test_launch_plan_routes_by_dtype_and_copies_nothing_the_model_passes(
        kind, dh, dt, route):
    q, k, v = _views(kind, dt, dh)
    assert launch_plan(q, k, v) == (route, (False, False, False))


@pytest.mark.parametrize("dt,route", [((BF16, BF16), 1), ((F32, F32), 2)])
def test_launch_plan_copies_what_the_kernel_cannot_read(dt, route):
    dq, dkv = dt
    q, k, v = _views("model", dt, 64)
    # a base 2 bytes off 16-byte alignment: TMA (route 1) needs a copy
    odd = torch.zeros(1 + q.numel(), dtype=dq)[1:].view(q.shape)
    assert launch_plan(odd, k, v) == (route, (route == 1, False, False))
    # rows of 64 + 4 elements: a head stride that is no multiple of 16 B
    # in bf16 (136 B); 272 B in f32 is one
    wide = torch.zeros(2, 4, 48, 68, dtype=dq)[..., :64]
    assert launch_plan(wide, k, v) == (route, (route == 1, False, False))
    # a last axis that is not contiguous: every route copies
    step = torch.zeros(2, 2, 48, 128, dtype=dkv)[..., ::2]
    assert launch_plan(q, step, v) == (route, (False, True, False))
    # a stride over a dimension of size 1 is never used
    one = torch.zeros(1, 4, 48, 64, dtype=dq).as_strided(
        (1, 4, 48, 64), (3, 64 * 48, 64, 1))
    k1, v1 = (t[:1] for t in (k, v))
    assert launch_plan(one, k1, v1) == (route, (False, False, False))
    # ... and the kernel is handed one TMA takes in its place
    assert _strides(one)[0] * one.element_size() % 16 == 0
    # what is copied comes out readable, with the same values
    for args in ((odd, k, v), (wide, k, v), (q, step, v)):
        got = prepare(*args)
        assert launch_plan(*got[1:]) == (route, (False, False, False))
        assert all(torch.equal(a, b) for a, b in zip(args, got[1:]))


@pytest.mark.parametrize("dtype,cache_dtype,route",
                         [(BF16, BF16, 1), (F32, F32, 2), (BF16, F32, 2)])
def test_model_attention_views_take_their_route_without_a_copy(
        monkeypatch, dtype, cache_dtype, route):
    """The tensors ``attention()`` and ``chunk_attention()`` hand the
    kernel, recorded on their way in, and the plan made for them."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b").reduced(num_layers=2).with_overrides(
        use_flash_attention=1)
    p = attn.init_attention(torch.Generator().manual_seed(0), cfg)
    plans = []

    def record(fn):
        def wrapped(q, k, v, *a, **kw):
            plans.append(launch_plan(q, k, v))
            return fn(q, k, v, *a, **kw)
        return wrapped

    monkeypatch.setattr(attn, "flash_attention", record(attn.flash_attention))
    monkeypatch.setattr(attn, "flash_attention_kernel",
                        record(attn.flash_attention_kernel))
    B, S, L, hd = 2, 24, 8, cfg.head_dim
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(S)[None].repeat(B, 1)
    attn.attention(p, x.to(dtype), cfg=cfg, positions=pos, dtype=dtype)
    cache = {n: torch.zeros(B, S + 8, cfg.num_kv_heads, hd,
                            dtype=cache_dtype) for n in ("k", "v")}
    attn.chunk_attention(p, x[:, :L].to(dtype), cache, cfg=cfg, start=16,
                         dtype=dtype)
    # attention() casts its kv to the compute dtype; the cache keeps its own
    want_prefill = (1 if dtype == BF16 else 2, (False,) * 3)
    assert plans == [want_prefill, (route, (False,) * 3)]


# ------------------- route 1's rounding, modelled on the CPU ---------------

def _route1_model(q, k, v, *, causal, window, q_offset, BK=128):
    """Route 1's arithmetic in torch on bf16 inputs: f32 products of the
    bf16 values, the f32 scores scaled after the product, an online
    softmax over kv tiles of BK (the kernel's tiles and skips), P rounded
    to bf16 before P.V, l summed over the f32 P, clamped at 1e-30."""
    B, H, Sq, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    heads = torch.arange(H) * Hkv // H
    qf = q.float()
    kf, vf = (t.float().index_select(1, heads) for t in (k, v))
    scale = dh ** -0.5
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, dh)
    qpos = q_offset + torch.arange(Sq)[:, None]
    hi = -(-Skv // BK)
    if causal:
        hi = min(hi, (q_offset + Sq - 1) // BK + 1)
    lo = max(q_offset - window + 1, 0) // BK if window else 0
    for t in range(lo, hi):
        kpos = t * BK + torch.arange(min(BK, Skv - t * BK))[None, :]
        s = (qf @ kf[:, :, t * BK:t * BK + BK].transpose(-1, -2)) * scale
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pf = torch.exp(s - m_new)
        l = l * corr + pf.sum(-1, keepdim=True)
        acc = acc * corr + pf.to(BF16).float() @ vf[:, :, t * BK:t * BK + BK]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(BF16)


@pytest.mark.parametrize("dh", [112, 128])
@pytest.mark.parametrize("causal,window,q_offset,Sq", [
    (True, 0, 0, 2048), (True, 256, 0, 2048), (False, 0, 0, 2048),
    (True, 0, 1536, 512)])
def test_route1_rounding_model_is_within_the_bf16_budget(dh, causal, window,
                                                         q_offset, Sq):
    """The bf16 budget of route 1, known before the card: its rounding,
    emulated at S=2048, against the JAX package's dense reference (f32
    softmax of the same bf16 inputs, output rounded to bf16), within the
    limits chip_smoke.py holds the kernel to: 2e-2 max abs, 1e-2 rel L2.
    A q_offset chunk is held against those rows of the full attention."""
    B, H, Hkv, Skv = 1, 4, 2, 2048
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Hkv, Skv, Skv, dh, dh + Sq,
                                   "bfloat16")
    got = _route1_model(q[:, :, q_offset:q_offset + Sq], k, v, causal=causal,
                        window=window, q_offset=q_offset)
    want = _f32(jax_reference(jq, jk, jv, causal=causal, window=window))[
        :, :, q_offset:q_offset + Sq]
    diff = _f32(got) - want
    assert np.abs(diff).max() <= 2e-2
    assert np.linalg.norm(diff) / np.linalg.norm(want) <= 1e-2
