"""The expert layer's combine (``repro_torch.kernels.moe_combine``): the
gather of the experts' output rows back to the routes and the weighted
sum over the top-k.

On the CPU: ``ref.py`` is the expression ``models/moe.py`` ran inline
before the kernel pair, bit for bit in the output and both gradients;
``dispatch`` gives each kept local route a row of its own (what the
backward kernel relies on); the kernels' wrapper refuses what they do not
take rather than fall back. On the card (``card`` tests, skipped without
CUDA): the kernels against ``ref.py`` at these shapes and at
olmoe-1b-7b's. This file imports no JAX; on a machine without it, skip
``tests/conftest.py`` (which imports JAX):

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_moe_combine.py
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_combine import ops  # noqa: E402
from repro_torch.kernels.moe_combine.ref import combine_reference  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# (name, T, E, k, d, tensor shard (index, of), top_e rule)
CASES = {
    "none_dropped": (256, 64, 8, 64, (0, 1), "balanced"),
    "70pct_dropped": (256, 64, 8, 64, (0, 1), "hot16"),
    "all_dropped": (64, 64, 8, 64, (1, 2), "low8"),
    "shard_e0": (128, 64, 8, 64, (1, 2), "random"),
    "one_token": (1, 64, 8, 64, (0, 1), "random"),
}
OLMOE = (4096, 64, 8, 2048, (0, 1), "hot16")      # C = 640, 40,960 rows


def routes(T, E, k, rule, rng):
    """top_e [T, k] by ``rule``: ``balanced`` spreads the routes evenly
    (none dropped at capacity 1.25); ``hot16`` puts every token on 8 of 16
    experts (~69% dropped, as the benchmark's random router); ``low8`` on
    the first 8 experts (none local to shard 1 of 2); ``random`` on k
    distinct experts drawn at random."""
    if rule == "balanced":
        return (np.arange(T * k) % E).reshape(T, k)
    if rule == "low8":
        return np.tile(np.arange(8), (T, 1))[:, :k]
    pool = 16 if rule == "hot16" else E
    return np.stack([rng.permutation(pool)[:k] for _ in range(T)])


def draw(case, dtype, device="cpu", seed=0):
    """(y, slot, w, dout) as ``_moe_ffn`` makes them: slot from
    ``dispatch`` at capacity factor 1.25, w the renormalised top-k weights
    masked by keep and local, in ``dtype``."""
    T, E, k, d, (index, of), rule = case
    rng = np.random.default_rng(seed)
    cfg = types.SimpleNamespace(moe_top_k=k, num_experts=E,
                                capacity_factor=1.25)
    C = moe.capacity(T, cfg)
    E_local = E // of
    top_e = torch.as_tensor(routes(T, E, k, rule, rng), device=device)
    keep, local, slot = moe.dispatch(top_e, E, C, index * E_local, E_local)
    top_w = torch.as_tensor(rng.random((T, k), dtype=np.float32) + 0.05,
                            device=device)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    w = (top_w.reshape(-1) * keep * local).to(dtype).reshape(T, k)
    y = torch.as_tensor(rng.standard_normal((E_local * C, d), np.float32),
                        device=device).to(dtype)
    dout = torch.as_tensor(rng.standard_normal((T, d), np.float32),
                           device=device).to(dtype)
    return y, slot.reshape(T, k), w, dout


def inline(y, slot, w):
    """The inline expression of ``models/moe.py`` before the kernel pair,
    as it stood there."""
    T, k = slot.shape
    trash, d = y.shape
    yf = torch.cat([y.reshape(trash, d),
                    torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    tok_y = yf[slot.reshape(-1)]
    w = w.reshape(-1)
    return (tok_y * w[:, None]).reshape(T, k, d).sum(dim=1)


def grads(fn, y, w, dout):
    y, w = (t.detach().requires_grad_(True) for t in (y, w))
    return fn(y, w), *torch.autograd.grad(fn(y, w), (y, w), dout)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(CASES))
def test_reference_is_the_inline_expression_bit_for_bit(name, dtype):
    y, slot, w, dout = draw(CASES[name], dtype)
    got = grads(lambda y_, w_: combine_reference(y_, slot, w_), y, w, dout)
    want = grads(lambda y_, w_: inline(y_, slot, w_), y, w, dout)
    for g, h in zip(got, want):
        assert g.dtype == h.dtype and torch.equal(g, h)
    # moe_combine on the CPU is the reference, gradients and all
    via = grads(lambda y_, w_: ops.moe_combine(y_, slot, w_), y, w, dout)
    for g, h in zip(via, want):
        assert torch.equal(g, h)


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_gives_each_kept_local_route_its_own_row(name):
    """The backward kernel writes each row of dy from at most one route,
    with plain stores: dispatch must never give two kept routes a row."""
    y, slot, _, _ = draw(CASES[name], torch.float32)
    rows = y.shape[0]
    owned = slot[slot < rows]
    assert bool((slot <= rows).all())
    assert owned.unique().numel() == owned.numel()
    share = 1.0 - owned.numel() / slot.numel()
    want = {"none_dropped": (0.0, 0.0), "70pct_dropped": (0.6, 0.75),
            "all_dropped": (1.0, 1.0), "one_token": (0.0, 0.0)}
    lo, hi = want.get(name, (0.0, 1.0))
    assert lo <= share <= hi


def test_meta_tensors_give_the_shape():
    y, slot, w, _ = draw(CASES["70pct_dropped"], torch.bfloat16)
    out = ops.moe_combine(y.to("meta"), slot.to("meta"), w.to("meta"))
    assert out.device.type == "meta" and out.shape == (slot.shape[0],
                                                       y.shape[1])


@pytest.mark.parametrize("bad", ["float16", "w_dtype", "d12", "slot32",
                                 "cpu"])
def test_the_kernel_wrapper_refuses_what_it_does_not_take(bad):
    """The launchers check before they launch and raise; they never run
    the plain version instead (a CPU tensor is refused too)."""
    y, slot, w, dout = draw(CASES["one_token"], torch.bfloat16)
    if bad == "float16":
        y, w, dout = y.half(), w.half(), dout.half()
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "d12":
        y, dout = y[:, :12].contiguous(), dout[:, :12].contiguous()
    elif bad == "slot32":
        slot = slot.int()
    with pytest.raises(ValueError, match="moe_combine"):
        ops.combine_forward(y, slot, w)
    with pytest.raises(ValueError, match="moe_combine"):
        ops.combine_backward(dout, y, slot, w)


# ----------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
    return "cuda"


def exact(y, slot, w, dout):
    """f64 out, dw and the scale Σ_j |w y| of each output element."""
    rows = y.shape[0]
    yf = torch.cat([y.double(), torch.zeros_like(y[:1], dtype=torch.float64)])
    tok = yf[slot.clamp(max=rows)]                           # [T, k, d]
    wd = w.double()[..., None]
    out = (tok * wd).sum(1)
    scale = (tok * wd).abs().sum(1)
    dw = (tok * dout.double()[:, None]).sum(-1)
    dw_scale = (tok * dout.double()[:, None]).abs().sum(-1)
    return out, scale, dw, dw_scale


CARD_CASES = {**CASES, "olmoe": OLMOE,
              "olmoe_none_dropped": (4096, 64, 8, 2048, (0, 1), "balanced")}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernels_match_the_reference_on_the_card(card, name, dtype):
    y, slot, w, dout = draw(CARD_CASES[name], dtype, device=card, seed=7)
    rows = y.shape[0]
    n0, n1 = ops.combine_forward.launches, ops.combine_backward.launches
    out, dy, dw_grad = grads(lambda y_, w_: ops.moe_combine(y_, slot, w_),
                             y, w, dout)
    assert (ops.combine_forward.launches - n0,
            ops.combine_backward.launches - n1) == (2, 1)
    ref_out, ref_dy, ref_dw = grads(
        lambda y_, w_: combine_reference(y_, slot, w_), y, w, dout)
    want, scale, dw_exact, dw_scale = exact(y, slot, w, dout)
    # 2u: one rounding to bf16 (2^-8 relative), two to f32; the f32 sums
    # add at most ~(terms a lane + 5) x 2^-24 of the scale (k routes; 64
    # of d = 2,048 a lane)
    u = 2.0 ** -9 if dtype == torch.bfloat16 else 2.0 ** -24
    # out: f32 sums rounded once, so within one rounding of the exact sum;
    # the reference also rounds each product, so within a few of it
    err = (out.double() - want).abs()
    assert bool((err <= 2 * u * want.abs() + 1e-6 * scale + 1e-30).all())
    assert bool(((out.double() - ref_out.double()).abs()
                 <= (4 * u + 2e-6) * scale + 1e-30).all())
    # dy: w * dout is exact in f32 and rounded once, as the reference does
    assert torch.equal(dy, ref_dy)
    owned = torch.zeros(rows, dtype=torch.bool, device=card)
    owned[slot[slot < rows]] = True
    bits = dy[~owned].view(torch.int16 if dtype == torch.bfloat16
                           else torch.int32)
    assert bool((bits == 0).all())
    # dw: f32 dot products rounded once to the dtype (the gradient autograd
    # gives, with no cast after the kernel), 0 for a route at the trash row
    dy2, dw = ops.combine_backward(dout, y, slot, w)
    assert dw.dtype == dtype and torch.equal(dw_grad, dw)
    assert bool(((dw.double() - dw_exact).abs()
                 <= 2 * u * dw_exact.abs() + 1e-5 * dw_scale + 1e-30).all())
    assert bool((dw[slot >= rows] == 0).all())
    assert bool(((dw.double() - ref_dw.double()).abs()
                 <= (4 * u + 2e-5) * dw_scale + 1e-30).all())
    # two backward calls give the same bits
    dy3, dw3 = ops.combine_backward(dout, y, slot, w)
    assert torch.equal(dy2, dy3) and torch.equal(dw, dw3)
    assert torch.equal(dy2, dy)


@pytest.mark.card
@pytest.mark.parametrize("bad", ["float16", "d12"])
def test_cuda_tensors_go_through_the_kernels_or_raise(card, bad):
    y, slot, w, _ = draw(CASES["one_token"], torch.bfloat16, device=card)
    if bad == "float16":
        y, w = y.half(), w.half()
    else:
        y = y[:, :12].contiguous()
    with pytest.raises(ValueError, match="moe_combine"):
        ops.moe_combine(y, slot, w)
