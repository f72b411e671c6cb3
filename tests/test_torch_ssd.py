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
    # meta: the plain version's shapes (meta computes nothing), no launch
    ym = ssd_scan_kernel(*(t.to("meta") for t in (xh, dt, A, Bm, Cm, D)))
    assert ym.is_meta and ym.shape == xh.shape and ym.dtype == xh.dtype
    y = ssd_scan_kernel(xh, dt, A, Bm, Cm, D)           # CPU: plain version
    y2, h = ssd_scan_kernel(xh, dt, A, Bm, Cm, D, return_state=True)
    assert torch.equal(y, y2) and tuple(h.shape) == (1, 2, 32, 16)
    assert ssd_scan_kernel.launches == n0


# ------------- the CUDA kernels' algorithm, modelled on the CPU -------------
#
# csrc/ssd_scan.cu runs the scan as three passes (chunk states, the state
# passed across chunks, chunk outputs) with every product in 3xTF32 on the
# tensor cores. It cannot run here, so the passes are written below in
# plain PyTorch, in the kernels' order, with each operand of a product
# split into two tf32 values (a 10-bit mantissa, rounded to nearest) and
# the three products hi.hi + hi.lo + lo.hi summed: this models the
# operands' rounding only; the tensor cores' own accumulation is measured
# on the card (chip_smoke.py phase S). Limits are phase S's: 1e-4 max abs,
# and 1e-5 relative L2 for the model's own dt draw, whose y reaches ~10^2.

from repro_torch.kernels.ssm_scan import ops as ssd_ops  # noqa: E402

Q = ssd_ops.CHUNK


def _tf32(a):
    """a rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero: cvt.rna.tf32.f32), kept as f32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b in 3xTF32: hi.hi + hi.lo + lo.hi, the small terms first."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _three_passes(xh, dt, A, Bm, Cm, D, h0=None):
    """(y, h_final) as the kernels compute them; positions past S read as
    zeros, as TMA fills them."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(a):
        a = torch.nn.functional.pad(a.float(), (0, 0) * (a.dim() - 2)
                                    + (0, pad))
        return a.reshape(B, nc, Q, *a.shape[2:])

    x, d, Bc, Cc = chunks(xh), chunks(dt), chunks(Bm), chunks(Cm)
    cum = torch.cumsum(d * A, dim=2)                       # [B, nc, Q, H]
    last = cum[:, :, -1]                                   # [B, nc, H]
    # pass 1: s_c = (coeff x)^T B, coeff_t = exp(cum_last - cum_t) dt_t
    coef = torch.exp(last[:, :, None] - cum) * d
    xc = (coef[..., None] * x).permute(0, 1, 3, 4, 2)      # [B, nc, H, P, Q]
    states = _mm3(xc, Bc[:, :, None])                      # [B, nc, H, P, N]
    # pass 2: the state before each chunk
    h = torch.zeros(B, H, P, N) if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(last[:, c])[..., None, None] * h + states[:, c]
    h_in = torch.stack(h_in, 1)
    # pass 3: y = (exp(cum) C) h_in^T + M x + D x, M on and below the
    # diagonal, exp(seg) never evaluated above it
    cb = _mm3(Cc, Bc.transpose(-1, -2))                    # [B, nc, Q, Q]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B, nc, t, s, H]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[..., None]
    M = (cb[..., None] * torch.exp(seg.masked_fill(~tri, float("-inf")))
         * d[:, :, None]).permute(0, 1, 4, 2, 3)           # [B, nc, H, t, s]
    y1 = _mm3(M, x.permute(0, 1, 3, 2, 4))
    ec = (torch.exp(cum).permute(0, 1, 3, 2)[..., None]
          * Cc[:, :, None])                                # [B, nc, H, Q, N]
    y2 = _mm3(ec, h_in.transpose(-1, -2))
    y = (y2 + y1).permute(0, 1, 3, 2, 4).reshape(B, nc * Q, H, P)[:, :S]
    y = y + xh.float() * D[:, None]
    return y.to(xh.dtype), h


def _zamba2_inputs(B, S, H, P, N, seed, draw):
    """Inputs as phase S draws them: "zamba2" is the model's ranges, A =
    -linspace(1, 16, H) (its A_log init) and dt log-uniform in [0.001,
    0.1] (its dt_bias range); "model" is what the mixer hands the scan at
    random weights, dt = softplus(n + dt_bias), under which y reaches
    ~10^2. Returned as numpy, for both packages."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    xh, Bm, Cm = n(B, S, H, P), n(B, S, N), n(B, S, N)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    lo, hi = np.log(0.001), np.log(0.1)
    if draw == "zamba2":
        dt = np.exp(rng.uniform(size=(B, S, H)) * (hi - lo) + lo)
    else:
        u = rng.uniform(size=H)
        dt_bias = np.log(np.expm1(np.exp(u * (hi - lo) + lo)))
        dt = _softplus(n(B, S, H) + dt_bias.astype(np.float32))
    return [a.astype(np.float32) for a in
            (xh, dt, A, Bm, Cm, np.ones(H, np.float32))]


def _jax_chunked(ins, h0):
    """The JAX package's ``ssd_chunked`` (chunk 128) on inputs padded with
    zeros to a chunk multiple (dt = 0 there: exact), y cut back to S."""
    S = ins[0].shape[1]
    pad = -S % Q
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in ins]
    y, h = jax_ssd_chunked(*map(jnp.asarray, padded), chunk=Q,
                           h0=None if h0 is None else jnp.asarray(h0))
    return np.asarray(y)[:, :S], np.asarray(h)


@pytest.mark.parametrize("draw", ["jax", "zamba2", "model"])
@pytest.mark.parametrize("S,with_h0", [(256, False), (300, True)])
def test_three_passes_in_3xtf32_match_jax_and_the_plain_version(
        draw, S, with_h0):
    """The kernels' passes and operand rounding at zamba2's P=64, N=64
    (fewer heads and rows), a ragged S with h0 and h_final, against the
    JAX package's ``ssd_chunked`` and the port's plain version."""
    B, H, P, N = 2, 3, 64, 64
    if draw == "jax":
        jins, tins = _inputs(B, S, H, P, N, 20 + S)
        ins = [np.asarray(a, np.float32) for a in jins]
    else:
        ins = _zamba2_inputs(B, S, H, P, N, 20 + S, draw)
        tins = [torch.from_numpy(a) for a in ins]
    h0 = (0.5 * np.random.default_rng(S).standard_normal((B, H, P, N))
          .astype(np.float32) if with_h0 else None)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = _three_passes(*tins, h0=th0)
    want_y, want_h = _jax_chunked(ins, h0)
    plain_y, plain_h = ssd_scan_reference(*tins, h0=th0, return_state=True)
    if draw == "model":
        assert np.abs(want_y).max() > 10          # y is large here
        for got, want in ((y, want_y), (y, plain_y), (h, want_h)):
            g, w = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-5
    else:
        for got, want in ((y, want_y), (y, plain_y), (h, want_h),
                          (h, plain_h)):
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)


def test_three_passes_round_bf16_outputs_from_their_f32_values():
    """bf16 xh: y is the f32 result rounded once, so it is within half a
    bf16 spacing (plus the f32 limit) of the plain f32 result."""
    ins = _zamba2_inputs(1, 200, 2, 64, 64, 31, "zamba2")
    tins = [torch.from_numpy(a) for a in ins]
    tins[0] = tins[0].to(torch.bfloat16)
    y, _ = _three_passes(*tins)
    assert y.dtype == torch.bfloat16
    want = ssd_scan_reference(tins[0].float(), *tins[1:])
    half = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 9)
    assert ((y.float() - want).abs() - half).max() <= 1e-4


def test_tf32_rounding_model():
    """The split is exact (hi + lo recovers a to ~2^-22 of it) and hi keeps
    10 mantissa bits, rounded to nearest."""
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -3.0000001, 1e-3, 123.456])
    hi = _tf32(a)
    assert hi[0] == 1.0 + 2.0 ** -10           # the tie rounds away
    assert hi[1] == 1.0 + 2.0 ** -10
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    lo = _tf32(a - hi)
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()


# --------------------------- the launch plan --------------------------------

F32, BF16 = torch.float32, torch.bfloat16


def _mixer_views(B, S, H, N, dtype):
    """xh, Bm, Cm as ``mamba2._ssm_inputs`` hands them to the scan: slices
    of one conv output [B, S, H*64 + 2N], each ``.to(f32)`` (a no-op on
    an f32 forward, a contiguous copy on a bf16 one)."""
    conv = torch.zeros(B, S, H * 64 + 2 * N, dtype=dtype)
    xi, Bm, Cm = torch.split(conv, [H * 64, N, N], dim=-1)
    return (xi.reshape(B, S, H, 64).to(F32), Bm.to(F32), Cm.to(F32))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("H,N", [(112, 64), (8, 16), (4, 128)])
def test_launch_plan_copies_nothing_the_mixer_passes(dtype, H, N):
    xh, Bm, Cm = _mixer_views(2, 300, H, N, dtype)
    if dtype == F32:             # zamba2's: an s-stride of 7,296 floats
        assert xh.stride(1) == H * 64 + 2 * N and not xh.is_contiguous()
    plan = ssd_ops.launch_plan(xh, Bm, Cm, want_state=False)
    assert plan.copy == (False, False, False)


def test_launch_plan_copies_what_tma_cannot_read():
    xh, Bm, Cm = (torch.zeros(2, 64, 4, 64), torch.zeros(2, 64, 16),
                  torch.zeros(2, 64, 16))
    plan = ssd_ops.launch_plan
    assert plan(xh, Bm, Cm, False).copy == (False, False, False)
    # a base 4 bytes off 16-byte alignment
    odd = torch.zeros(1 + xh.numel())[1:].view(xh.shape)
    assert plan(odd, Bm, Cm, False).copy == (True, False, False)
    # an s-stride of 18 floats (72 B) in f32; of 24 bf16 (48 B) it is one
    wide = torch.zeros(2, 64, 18)[..., :16]
    assert plan(xh, wide, Cm, False).copy == (False, True, False)
    assert plan(xh, Bm, wide.to(BF16)[..., :16].contiguous()[:, :, :16],
                False).copy == (False, False, False)
    wide_bf = torch.zeros(2, 64, 24, dtype=BF16)[..., :16]
    assert plan(xh, Bm, wide_bf, False).copy == (False, False, False)
    # a head stride of 66 floats: no multiple of 16 bytes
    heads = torch.zeros(2, 64, 4, 66)[..., :64]
    assert plan(heads, Bm, Cm, False).copy == (True, False, False)
    # a last axis that is not contiguous
    step = torch.zeros(2, 64, 32)[..., ::2]
    assert plan(xh, Bm, step, False).copy == (False, False, True)
    # a stride over a dimension of size 1 is never used ...
    one = torch.zeros(1, 64, 16).as_strided((1, 64, 16), (3, 16, 1))
    assert plan(xh[:1], one, one, False).copy == (False, False, False)
    # ... and the kernel is handed one TMA takes in its place
    assert ssd_ops.tma.strides(one, 2)[0] * 4 % 16 == 0


@pytest.mark.parametrize("B,S,want_state,heads_state,heads_out", [
    (4, 2048, False, 9, 14), (1, 2048, False, 14, 14),
    (4, 512, True, 14, 14), (4, 1000, False, 8, 14), (1, 32, False, 1, 1)])
def test_launch_plan_scratch_and_heads_per_block(B, S, want_state,
                                                 heads_state, heads_out):
    """Phase S's shapes at zamba2's H=112, P=64, N=64: the f32 state
    scratch [B, nc, H, P, N] (117 MB at B=4, S=2048), the chunks pass 1
    computes (the last only for h_final), and the heads each block takes,
    which fill the card's 132 SMs in whole waves as far as they can."""
    xh, Bm, Cm = _mixer_views(B, S, 112, 64, F32)
    plan = ssd_ops.launch_plan(xh, Bm, Cm, want_state)
    nc = -(-S // 128)
    assert plan.states == (B, nc, 112, 64, 64)
    assert plan.decays == (B, nc, 112)
    assert plan.state_chunks == (nc if want_state else nc - 1)
    assert (plan.heads_state, plan.heads_out) == (heads_state, heads_out)
    if (B, S) == (4, 2048):
        assert 4 * np.prod(plan.states) == 117_440_512
    blocks = B * nc * -(-112 // plan.heads_out)
    assert blocks <= 132 or blocks / (-(-blocks // 132) * 132) > 0.9


def test_model_mixers_hand_the_scan_views_it_reads_in_place(monkeypatch):
    """The tensors ``mamba2_mixer`` and ``mamba2_mixer_chunk`` hand the
    scan in the f32 forward, recorded on their way in, and the plan made
    for them: no copy."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2 as m2
    cfg = get_config("zamba2-7b").reduced(num_layers=2)
    p = m2.init_mamba2(torch.Generator().manual_seed(0), cfg)
    plans = []

    def record(xh, dt, A, Bm, Cm, D, **kw):
        plans.append(ssd_ops.launch_plan(xh, Bm, Cm, "h0" in kw))
        return ssd_scan(xh, dt, A, Bm, Cm, D, **kw)

    monkeypatch.setattr(m2, "ssd_scan", record)
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    m2.mamba2_mixer(p, x, cfg=cfg, dtype=torch.float32)
    cache = m2.init_mamba2_cache(cfg, 2)
    m2.mamba2_mixer_chunk(p, x[:, :8], cache, cfg=cfg, dtype=torch.float32)
    assert [pl.copy for pl in plans] == [(False, False, False)] * 2
