"""The port's SSD scan (``repro_torch.kernels.ssm_scan``, K5) against the
JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both packages: the JAX
side through ``repro.kernels.ssm_scan`` as its own tests run it
(interpret-mode Pallas on the CPU) and through its step-by-step oracle,
the port through its wrappers, which take the plain version (``ref.py``)
for CPU tensors — the version the CUDA kernel is held against on the card
(``chip_smoke.py`` phase S).

Tolerances are the JAX package's own (``tests/test_kernels.py:73,90``):
1e-4 max abs in f32, 5e-2 in bf16 (y is rounded to bf16); chunked and
stepwise sums are added in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.kernels.ssm_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssm_scan.ref import (  # noqa: E402
    ssd_scan_stepwise as jax_stepwise)
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssd_scan, ssd_scan_kernel, ssd_scan_reference, ssd_scan_stepwise)
from repro_torch.kernels.ssm_scan.ref import ssd_chunked  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _inputs(B, S, H, P, N, seed, dtype="float32", draw="jax"):
    """The same (xh, dt, A, Bm, Cm, D) in both packages. ``draw`` "jax" is
    tests/test_kernels.py:65-71's distribution; "zamba2" the model's
    ranges (A = -linspace(1, 16), dt up to ~1), under which a 128-step
    chunk's cumulative decay passes -100."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xh, Bm, Cm = n(B, S, H, P), n(B, S, N), n(B, S, N)
    if draw == "jax":
        dt = _softplus(n(B, S, H)) * np.float32(0.1)
        A = -np.exp(0.3 * n(H)).astype(np.float32)
    else:
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
        dt = _softplus(n(B, S, H) + np.float32(-2.0))
    D = np.ones(H, np.float32)
    j = [jnp.asarray(xh, JDT[dtype])] + [jnp.asarray(a) for a in
                                         (dt, A, Bm, Cm, D)]
    t = [torch.from_numpy(xh).to(TDT[dtype])] + [torch.from_numpy(a) for a in
                                                 (dt, A, Bm, Cm, D)]
    return j, t


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# the four cases of tests/test_kernels.py:58-62
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk,dtype",
    [(2, 256, 4, 64, 16, 64, "float32"),
     (1, 130, 2, 32, 8, 64, "float32"),            # ragged padding
     (2, 128, 3, 64, 64, 128, "float32"),
     (1, 128, 2, 64, 32, 64, "bfloat16")])
def test_ssd_scan_matches_jax(B, S, H, P, N, chunk, dtype):
    (jins, tins) = _inputs(B, S, H, P, N, S + N, dtype)
    want = jax_ssd_scan(*jins, chunk, True)
    want_step = jax_stepwise(*jins)
    got = ssd_scan(*tins, chunk)
    assert got.dtype == tins[0].dtype and tuple(got.shape) == (B, S, H, P)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(want_step), atol=TOL[dtype])
    step = ssd_scan_stepwise(*tins)
    np.testing.assert_allclose(_f32(step), _f32(want_step), atol=TOL[dtype])
    direct = ssd_scan_kernel(*tins, chunk)
    assert torch.equal(direct, got)


def test_chunk_invariance():
    """The same result for chunks of 32, 64 and 128: the scan's key
    invariant (tests/test_kernels.py:78-91)."""
    _, tins = _inputs(1, 128, 2, 32, 16, 3)
    outs = [ssd_scan(*tins, c) for c in (32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(_f32(o), _f32(outs[0]), atol=1e-4)


@pytest.mark.parametrize("chunk", [32, 64])
def test_h0_and_h_final_match_jax_ssd_chunked(chunk):
    """A continuation from a carried state, as chunked prefill calls it:
    y and h_final against the JAX package's ``ssd_chunked(..., h0=)``."""
    B, S, H, P, N = 2, 128, 3, 32, 16
    jins, tins = _inputs(B, S, H, P, N, 4)
    h0 = 0.5 * np.random.default_rng(5).standard_normal(
        (B, H, P, N)).astype(np.float32)
    want, wh = jax_ssd_chunked(*jins, chunk=chunk, h0=jnp.asarray(h0))
    got, gh = ssd_scan(*tins, chunk, h0=torch.from_numpy(h0))
    assert gh.dtype == torch.float32 and tuple(gh.shape) == (B, H, P, N)
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(_f32(gh), np.asarray(wh), atol=1e-4)
    # the plain chunked form itself, and the split run reassembles
    y2, h2 = ssd_chunked(*tins, chunk=chunk, h0=torch.from_numpy(h0))
    assert torch.equal(y2, got) and torch.equal(h2, gh)
    ya, ha = ssd_scan(*(t[:, :64] if t.dim() > 1 else t for t in tins),
                      chunk, h0=torch.from_numpy(h0))
    yb, hb = ssd_scan(*(t[:, 64:] if t.dim() > 1 else t for t in tins),
                      chunk, h0=ha)
    np.testing.assert_allclose(_f32(torch.cat([ya, yb], 1)), _f32(got),
                               atol=1e-4)
    np.testing.assert_allclose(_f32(hb), _f32(gh), atol=1e-4)


def test_ragged_tail_leaves_the_state_at_S():
    """Positions padded past S (dt = 0) decay nothing and inject nothing:
    h_final equals the stepwise recurrence's state at S."""
    _, tins = _inputs(2, 130, 2, 32, 16, 6)
    y, h = ssd_scan_reference(*tins, chunk=64, return_state=True)
    ys, hs = ssd_scan_stepwise(*tins, return_state=True)
    np.testing.assert_allclose(_f32(y), _f32(ys), atol=1e-4)
    np.testing.assert_allclose(_f32(h), _f32(hs), atol=1e-5)


def test_zamba2_ranges_stay_finite_forward_and_backward():
    """Under the model's decays a chunk's seg above the diagonal overflows
    exp; the plain version never evaluates it there, so the forward agrees
    with the recurrence and the gradient is finite (JAX's where-select
    gives 0 * inf = NaN in its gradient there)."""
    jins, tins = _inputs(1, 256, 4, 32, 16, 7, draw="zamba2")
    cum = np.cumsum(np.asarray(jins[1])[0, :128] * np.asarray(jins[2]),
                    axis=0)
    assert cum[-1].min() < -100          # exp(-cum) overflows f32
    want = jax_stepwise(*jins)
    ins = [t.clone().requires_grad_(True) for t in tins]
    got = ssd_scan(*ins, 128)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)
    got.pow(2).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in tins]
    ssd_scan_stepwise(*ref).pow(2).sum().backward()
    for a, b in zip(ins, ref):
        assert torch.isfinite(a.grad).all()
        np.testing.assert_allclose(_f32(a.grad), _f32(b.grad), rtol=1e-3,
                                   atol=1e-3)


def test_grad_matches_jax():
    """Gradients of every input against ``jax.grad`` of the JAX package's
    ``ssd_scan`` (its custom VJP recomputes its reference)."""
    jins, tins = _inputs(1, 96, 2, 32, 16, 8)
    loss = lambda *a: jnp.sum(jax_ssd_scan(*a, 32, True) ** 2)  # noqa: E731
    want = jax.grad(loss, argnums=tuple(range(6)))(*jins)
    ins = [t.clone().requires_grad_(True) for t in tins]
    ssd_scan(*ins, 32).pow(2).sum().backward()
    for a, b in zip(ins, want):
        np.testing.assert_allclose(_f32(a.grad), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_grad_through_h0_and_h_final():
    """The state in and out of a chunk carries gradient too (the chunked
    prefill's form), held against the stepwise recurrence's autograd."""
    _, tins = _inputs(1, 64, 2, 32, 16, 9)
    h0 = torch.from_numpy(0.3 * np.random.default_rng(10).standard_normal(
        (1, 2, 32, 16)).astype(np.float32))
    outs = []
    for fn, kw in ((ssd_scan, {"chunk": 32}), (ssd_scan_stepwise, {})):
        ins = [t.clone().requires_grad_(True) for t in (*tins, h0)]
        y, h = fn(*ins[:6], h0=ins[6], **kw)
        (y.pow(2).sum() + h.pow(3).sum()).backward()
        outs.append([t.grad for t in ins])
    for a, b in zip(*outs):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-4, atol=1e-4)


def test_wrapper_raises_on_bad_inputs_and_counts_no_cpu_launch():
    n0 = ssd_scan_kernel.launches
    _, (xh, dt, A, Bm, Cm, D) = _inputs(1, 16, 2, 32, 16, 11)
    with pytest.raises(ValueError, match="4-D"):
        ssd_scan_kernel(xh[0], dt, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan_kernel(xh, dt[:, :8], A, Bm, Cm, D)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan_kernel(xh, dt, A, Bm, Cm[..., :8], D)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan_kernel(xh, dt, A, Bm, Cm, D, h0=torch.zeros(1, 2, 32, 8))
    with pytest.raises(ValueError, match="not f32 or bf16"):
        ssd_scan_kernel(xh.half(), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError):                     # mixed devices
        ssd_scan_kernel(xh, dt.to("meta"), A, Bm, Cm, D)
    with pytest.raises(ValueError):                     # meta device
        ssd_scan_kernel(*(t.to("meta") for t in (xh, dt, A, Bm, Cm, D)))
    y = ssd_scan_kernel(xh, dt, A, Bm, Cm, D)           # CPU: plain version
    y2, h = ssd_scan_kernel(xh, dt, A, Bm, Cm, D, return_state=True)
    assert torch.equal(y, y2) and tuple(h.shape) == (1, 2, 32, 16)
    assert ssd_scan_kernel.launches == n0
