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
