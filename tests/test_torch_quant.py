"""The port's fused quantize/dequantize (``repro_torch.kernels.quant``) and
its int8-fused wire tier against the JAX package, on the CPU.

Inputs come from numpy with a seed and go through both packages: the JAX
side through ``repro.kernels.quant.quantize_ef``/``dequantize`` as its own
tests run them (interpret-mode Pallas on the CPU), the port through its
wrappers, which take the plain version (``ref.py``) for CPU tensors — the
same version the CUDA kernels are held against bit for bit on the card
(``chip_smoke.py``).

Tolerances, and why:
  * ``q``, ``lo``, ``scale``, ``z`` and ``ok``: exact. They are what goes
    on the wire (or the exact fallback), computed by the same f32
    operations in the same order in both packages;
  * ``res'`` and the dequantized value: within 2 spacings of
    ``max(|z|, |lo|)``. The JAX package's CPU path contracts
    ``lo + scale*q`` into an FMA; the port rounds the product and the sum
    separately (as the JAX package's numpy reference does, which the port
    matches exactly);
  * the error-feedback invariant ``res' == z - dequantize(q)``: exact,
    within the port only (inside the JAX package it does not hold at every
    shape, its two kernels contracting differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.kernels.quant import dequantize as ref_dequantize  # noqa: E402
from repro.kernels.quant import quantize_ef as ref_quantize_ef  # noqa: E402
from repro.kernels.quant.ref import quantize_ef_reference as np_ref  # noqa: E402
from repro.runtime import codec as ref_codec  # noqa: E402
from repro.runtime import stage_executor as ref_se  # noqa: E402
from repro.runtime import workload as ref_wl  # noqa: E402
from repro.runtime.qtensor import DeviceQuantized as RefDQ  # noqa: E402
from repro_torch.kernels.quant import dequantize, quantize_ef  # noqa: E402
from repro_torch.runtime import codec  # noqa: E402
from repro_torch.runtime import stage_executor as se  # noqa: E402
from repro_torch.runtime import workload as wl  # noqa: E402
from repro_torch.runtime.qtensor import DeviceQuantized  # noqa: E402

SHAPES = [(8,), (16, 3), (2, 5, 33), (2, 3, 4, 7), (4096, 24)]
MODES = ["normal", "zeros", "const", "mixed"]
LR, MOM, WD = 0.05, 0.9, 4e-5


def _sample(shape, mode, seed):
    rng = np.random.default_rng(seed)
    if mode == "zeros":
        return np.zeros(shape, np.float32)
    if mode == "const":
        return np.full(shape, np.float32(rng.normal()), np.float32)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    if mode == "mixed":                 # some exactly-constant channels
        x[..., ::2] = 1.5
    return x


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _to_ref(p):
    """The port's tag-13 payload as the JAX package's own class."""
    return RefDQ(p.shape, p.data, p.lo, p.scale)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("levels", [4, 255])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_jax_package(shape, mode, levels, with_res):
    x = _sample(shape, mode, 11)
    res = (np.random.default_rng(12).normal(size=shape).astype(np.float32)
           * 0.01) if with_res else None
    n0 = (quantize_ef.launches, dequantize.launches)
    got = quantize_ef(torch.from_numpy(x),
                      None if res is None else torch.from_numpy(res),
                      levels=levels)
    want = ref_quantize_ef(jnp.asarray(x),
                           None if res is None else jnp.asarray(res),
                           levels=levels)
    q, lo, scale, res2, ok, z = map(_np, got)
    rq, rlo, rscale, rres2, rok, rz = map(np.asarray, want)
    assert q.dtype == np.uint8 and q.shape == shape
    assert lo.shape == scale.shape == (shape[-1],)
    assert bool(ok) == bool(rok)
    for a, b in ((q, rq), (lo, rlo), (scale, rscale), (z, rz)):
        np.testing.assert_array_equal(a, b)
    tol = 2 * np.spacing(np.maximum(np.abs(rz), np.abs(rlo)))
    assert np.all(np.abs(res2 - rres2) <= tol)
    dq = dequantize(got[0], got[1], got[2]).numpy()
    rdq = np.asarray(ref_dequantize(want[0], want[1], want[2]))
    assert np.all(np.abs(dq - rdq) <= tol)
    # the port rounds as the JAX package's numpy oracle does: bit for bit
    for a, b in zip((q, lo, scale, res2, z),
                    (o for i, o in enumerate(np_ref(x, res, levels=levels))
                     if i != 4)):
        np.testing.assert_array_equal(a, b)
    # EF invariant, exact within the port; degenerate channels exact
    np.testing.assert_array_equal(res2, z - dq)
    np.testing.assert_array_equal(dq[..., scale == 0], np.broadcast_to(
        lo[scale == 0], dq[..., scale == 0].shape))
    assert np.all(np.abs(dq - z) <= 0.5 * scale + 4 * np.spacing(
        np.abs(z) + 1.0))
    # CPU tensors take the plain version: no kernel launch is counted
    assert (quantize_ef.launches, dequantize.launches) == n0


def test_zeros_and_constants_round_trip_exactly():
    for mode in ("zeros", "const"):
        x = torch.from_numpy(_sample((10, 6), mode, 5))
        q, lo, scale, res2, ok, z = quantize_ef(x)
        assert bool(ok) and torch.all(scale == 0)
        assert torch.equal(dequantize(q, lo, scale), x)
        assert torch.equal(res2, torch.zeros_like(x))


@pytest.mark.parametrize("where", ["x-nan", "x-inf", "res-inf"])
def test_non_finite_input_reports_not_ok_like_jax(where):
    x = _sample((8, 4), "normal", 9)
    res = _sample((8, 4), "normal", 10) * 0.01
    if where == "res-inf":
        res[0, 0] = np.inf
    else:
        x[3, 2] = np.nan if where == "x-nan" else np.inf
    *_, ok, z = quantize_ef(torch.from_numpy(x), torch.from_numpy(res))
    *_, rok, rz = ref_quantize_ef(jnp.asarray(x), jnp.asarray(res))
    assert not bool(ok) and not bool(rok)
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz))   # x + res


@pytest.mark.parametrize("with_res", [False, True])
def test_quantize_without_z_returns_the_same_codes(with_res):
    """``with_z=False`` (how the live runtime calls K2) leaves out z and
    nothing else."""
    x = torch.from_numpy(_sample((64, 5), "mixed", 12))
    res = torch.from_numpy(_sample((64, 5), "normal", 13) * 0.01) \
        if with_res else None
    full = quantize_ef(x, res, levels=255)
    lean = quantize_ef(x, res, levels=255, with_z=False)
    assert lean[5] is None
    for a, b in zip(full[:5], lean[:5]):
        assert torch.equal(a, b)


def test_quantize_ef_rejects_degenerate_inputs():
    with pytest.raises(ValueError):
        quantize_ef(torch.tensor(3.0))                   # rank 0
    with pytest.raises(ValueError):
        quantize_ef(torch.zeros((0, 4)))                 # empty
    with pytest.raises(ValueError):
        quantize_ef(torch.zeros((4, 4)), levels=256)     # not a u8 code
    with pytest.raises(ValueError):
        quantize_ef(torch.zeros((4, 4)), torch.zeros((4, 3)))


# ---------------------------- tag-13 frames ------------------------------

def test_tag13_frames_decode_across_packages():
    x = _sample((6, 18), "normal", 21)
    q, lo, scale, *_ = quantize_ef(torch.from_numpy(x))
    port_dq = DeviceQuantized.from_arrays(q, lo, scale)
    ref_dq = _to_ref(port_dq)
    frame = codec.encode("act", (3, 0, port_dq))
    assert frame == ref_codec.encode("act", (3, 0, ref_dq))   # same bytes
    for enc, dec, payload, cls in (
            (codec.encode, ref_codec.decode, port_dq, RefDQ),
            (ref_codec.encode, codec.decode, ref_dq, DeviceQuantized)):
        kind, (seg, b, got) = dec(enc("act", (3, 0, payload)))
        assert kind == "act" and (seg, b) == (3, 0)
        assert isinstance(got, cls) and got.shape == port_dq.shape
        for have, want in zip(got.arrays(), port_dq.arrays()):
            np.testing.assert_array_equal(have, want)
        np.testing.assert_array_equal(
            got.to_f32(), dequantize(q, lo, scale).numpy())


# ------------------------ StageExecutor integration ----------------------

@pytest.fixture(scope="module")
def mlp():
    """(JAX chain, port chain) on the JAX package's weights."""
    ref = ref_wl.mlp_chain(jax.random.PRNGKey(7), num_layers=6, width=16,
                           in_dim=8)
    port = wl.mlp_chain(torch.Generator().manual_seed(7), num_layers=6,
                        width=16, in_dim=8)
    port.load_flat_params(
        {j: np.asarray(f) for j, f in ref.flat_params().items()})
    return ref, port


def _executors(mlp, a, e):
    ref, port = mlp
    rsl, rbuf = ref.flat_slice(a, e)
    psl, pbuf = port.flat_slice(a, e)
    kw = dict(last=False, lr=LR, momentum=MOM, weight_decay=WD)
    return (ref_se.StageExecutor(ref, rsl, compiled=True, **kw), rbuf,
            se.StageExecutor(port, psl, device="cpu", **kw), pbuf, psl)


def test_stage_executor_forward_q_emits_device_quantized(mlp):
    ex_r, rbuf, ex_p, pbuf, _ = _executors(mlp, 0, 2)
    x = np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)
    y = ex_p.forward(pbuf, x).numpy()
    np.testing.assert_allclose(y, np.asarray(ex_r.forward(rbuf, x)),
                               rtol=1e-5, atol=1e-6)
    payload, res = ex_p.forward_q(pbuf, x, None)
    rpayload, _ = ex_r.forward_q(rbuf, jnp.asarray(x), None)
    assert isinstance(payload, DeviceQuantized)
    assert payload.shape == rpayload.shape == y.shape
    scale = np.frombuffer(payload.scale, "<f4")
    # per-channel levels=255: boundary error bounded by scale/2; the two
    # packages' forwards differ by f32 rounding, so their codes by <= 1
    assert np.all(np.abs(payload.to_f32() - y) <= 0.5 * scale + 1e-5)
    assert np.all(np.abs(payload.to_f32() - rpayload.to_f32())
                  <= scale + 1e-5)
    # the residual is what the wire lost, on the executor's device
    assert torch.is_tensor(res) and res.device.type == "cpu"
    np.testing.assert_array_equal(res.numpy(), y - payload.to_f32())
    payload2, res2 = ex_p.forward_q(pbuf, x, res)      # EF threads on
    assert isinstance(payload2, DeviceQuantized)
    np.testing.assert_array_equal(
        res2.numpy(), (y + res.numpy()) - payload2.to_f32())


def test_stage_executor_accepts_quantized_inputs(mlp):
    """A downstream stage consumes the upstream's DeviceQuantized: its
    forward equals the forward of the dequantized tensor, and step_q
    takes a quantized input and cotangent and emits a quantized grad."""
    ex1_r, rbuf1, ex1, buf1, _ = _executors(mlp, 0, 2)
    ex2_r, rbuf2, ex2, buf2, sl2 = _executors(mlp, 3, 4)
    x = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)
    payload, _ = ex1.forward_q(buf1, x, None)
    y_from_q = ex2.forward(buf2, payload)
    y_from_f32 = ex2.forward(buf2, payload.to_f32())
    assert torch.equal(y_from_q, y_from_f32)
    # the JAX package reads the port's payload the same way
    np.testing.assert_allclose(
        y_from_q.numpy(), np.asarray(ex2_r.forward(rbuf2, _to_ref(payload))),
        rtol=1e-5, atol=1e-6)
    ct_payload, _ = ex1.forward_q(buf1, x, None)   # activation-shaped ct
    n0 = ex2.change_counts[3]
    g, new_buf, mom, res = ex2.step_q(buf2, buf2, sl2.zeros(), payload,
                                      ct=ct_payload)
    assert isinstance(g, DeviceQuantized)
    assert g.shape == (8, payload.shape[-1])
    assert tuple(res.shape) == g.shape and ex2.change_counts[3] == n0 + 1
    assert not torch.equal(new_buf, buf2)
    # the same step on the dequantized tensors gives the same update and
    # the gradient that g quantizes
    dx, new_f, mom_f = ex2.step(buf2, buf2, sl2.zeros(), payload.to_f32(),
                                ct_payload.to_f32())
    assert torch.equal(new_buf, new_f) and torch.equal(mom, mom_f)
    np.testing.assert_array_equal(res.numpy(), dx.numpy() - g.to_f32())
    rg, rnew, _, _ = ex2_r.step_q(rbuf2, rbuf2, ex2_r.slice.zeros(),
                                  _to_ref(payload), ct=_to_ref(ct_payload))
    np.testing.assert_allclose(new_buf.numpy(), np.asarray(rnew),
                               rtol=1e-5, atol=1e-6)
    gs = np.frombuffer(g.scale, "<f4")
    assert np.all(np.abs(g.to_f32() - rg.to_f32()) <= gs + 1e-6)


def test_stage_executor_nan_falls_back_to_exact(mlp):
    ex_r, rbuf, ex_p, pbuf, _ = _executors(mlp, 0, 2)
    x = np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32)
    x[0, 0] = np.nan
    payload, res = ex_p.forward_q(pbuf, x, None)
    rpayload, _ = ex_r.forward_q(rbuf, jnp.asarray(x), None)
    assert isinstance(payload, np.ndarray)        # exact f32, not quantized
    assert isinstance(rpayload, np.ndarray)
    np.testing.assert_array_equal(np.isnan(payload), np.isnan(rpayload))
    assert torch.equal(res, torch.zeros_like(res))   # residual reset


def test_stage_executor_non_finite_residual_ships_x_plus_res(mlp):
    """With a carried residual, the exact fallback ships ``y + res``, the
    tensor K2 would have quantized, and resets the residual."""
    _, _, ex_p, pbuf, _ = _executors(mlp, 0, 2)
    x = np.random.default_rng(3).normal(size=(8, 8)).astype(np.float32)
    y = ex_p.forward(pbuf, x)
    res = torch.from_numpy(
        np.random.default_rng(4).normal(size=tuple(y.shape)).astype(
            np.float32) * 0.01)
    res[2, 1] = float("inf")
    payload, res2 = ex_p.forward_q(pbuf, x, res)
    assert isinstance(payload, np.ndarray)
    np.testing.assert_array_equal(payload, (y + res).numpy())
    assert torch.equal(res2, torch.zeros_like(res2))
