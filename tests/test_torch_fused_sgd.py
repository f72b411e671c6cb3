"""Fused SGD in the PyTorch port (``repro_torch.kernels.fused_sgd``) against
the JAX reference (``repro.kernels.fused_sgd``, Pallas in interpret mode).

On the CPU the port's wrapper runs its plain version (``ref.py``); the CUDA
kernel is held bit for bit against that plain version on the card by
``chip_smoke.py``. Tolerance against the reference: atol 1e-6 — both are
f32, and at most one fused multiply-add apart (XLA may contract
``g + wd * p``; the port rounds every operation).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.fused_sgd.ops import fused_sgd as ref_fused_sgd  # noqa: E402
from repro.kernels.fused_sgd.ops import fused_sgd_tree as ref_fused_sgd_tree  # noqa: E402
from repro.kernels.fused_sgd.ref import sgd_reference as ref_sgd  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.kernels.fused_sgd import ops  # noqa: E402
from repro_torch.optim.sgd import sgd_init, sgd_update  # noqa: E402

ATOL = 1e-6


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(3)]


def _both(n, seed, lr, mu, wd):
    p, g, m = _inputs(n, seed)
    po, mo = ops.fused_sgd(*(torch.from_numpy(a) for a in (p, g, m)),
                           lr=lr, momentum=mu, weight_decay=wd)
    pr, mr = ref_fused_sgd(*(jnp.asarray(a) for a in (p, g, m)), lr=lr,
                           momentum=mu, weight_decay=wd, interpret=True)
    return (po.numpy(), mo.numpy()), (np.asarray(pr), np.asarray(mr)), \
        (p, g, m)


@pytest.mark.parametrize("n", [1, 255, 1000, 65536 + 3])
def test_matches_reference_kernel_across_sizes(n):
    (po, mo), (pr, mr), _ = _both(n, n, lr=0.05, mu=0.9, wd=4e-5)
    assert po.shape == (n,) and mo.shape == (n,)
    np.testing.assert_allclose(po, pr, atol=ATOL, rtol=0)
    np.testing.assert_allclose(mo, mr, atol=ATOL, rtol=0)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 5000), st.floats(0.001, 1.0), st.floats(0.0, 0.99),
       st.floats(0.0, 1e-2))
def test_property_matches_reference(n, lr, mu, wd):
    (po, mo), _, (p, g, m) = _both(n, n, lr, mu, wd)
    pr, mr = ref_sgd(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), lr=lr,
                     momentum=mu, weight_decay=wd)
    np.testing.assert_allclose(po, np.asarray(pr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(mo, np.asarray(mr), atol=ATOL, rtol=0)


def test_inputs_are_not_written():
    p, g, m = (torch.from_numpy(a) for a in _inputs(300, 1))
    before = [t.clone() for t in (p, g, m)]
    versions = [t._version for t in (p, g, m)]
    po, mo = ops.fused_sgd(p, g, m, lr=0.1)
    assert po.data_ptr() != p.data_ptr() and mo.data_ptr() != m.data_ptr()
    for t, b, v in zip((p, g, m), before, versions):
        assert torch.equal(t, b) and t._version == v


def test_cpu_tensors_take_the_plain_version_without_counting():
    n0 = ops.fused_sgd.launches
    p, g, m = (torch.from_numpy(a) for a in _inputs(64, 2))
    ops.fused_sgd(p, g, m, lr=0.1)
    assert ops.fused_sgd.launches == n0


@pytest.mark.parametrize("bad", ["dtype", "shape", "2d", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p = torch.zeros(16)
    g, m = torch.zeros(16), torch.zeros(16)
    if bad == "dtype":
        p = p.double()
    elif bad == "shape":
        g = torch.zeros(15)
    elif bad == "2d":
        p, g, m = (t.reshape(4, 4) for t in (p, g, m))
    else:
        p = torch.zeros(32)[::2]
    with pytest.raises(ValueError):
        ops.fused_sgd(p, g, m, lr=0.1)


def _nested(seed):
    rng = np.random.default_rng(seed)
    return {"w_proj": rng.normal(size=(1, 1, 6, 4)).astype(np.float32),
            "bn1": {"scale": rng.normal(size=6).astype(np.float32),
                    "bias": rng.normal(size=6).astype(np.float32)},
            "a": {"z": rng.normal(size=(3,)).astype(np.float32),
                  "b": rng.normal(size=(2, 5)).astype(np.float32)}}


def test_leaf_order_matches_jax_tree_flatten():
    import jax
    params = _nested(0)
    ref_leaves = jax.tree.leaves(params)
    port_leaves, paths = tree.flatten(params)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    assert paths == [("a", "b"), ("a", "z"), ("bn1", "bias"),
                     ("bn1", "scale"), ("w_proj",)]
    packed = ops.pack_leaves([torch.from_numpy(l) for l in port_leaves])
    from repro.kernels.fused_sgd.ops import pack_leaves as ref_pack
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(ref_pack(ref_leaves)))
    back = ops.unpack_leaves(packed, [l.shape for l in port_leaves],
                             [torch.float32] * len(port_leaves))
    for a, b in zip(back, port_leaves):
        np.testing.assert_array_equal(a.numpy(), b)


def test_tree_update_matches_reference_and_unfused():
    params, grads, mom = _nested(1), _nested(2), _nested(3)
    t = lambda d: tree.map(torch.from_numpy, d)  # noqa: E731
    po, mo = ops.fused_sgd_tree(t(params), t(grads), t(mom), lr=0.1)
    pr, mr = ref_fused_sgd_tree(*(tree.map(jnp.asarray, d)
                                  for d in (params, grads, mom)),
                                lr=0.1, interpret=True)
    for a, b in zip(tree.leaves(po), tree.leaves(pr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    for a, b in zip(tree.leaves(mo), tree.leaves(mr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    # the port's leafwise optimizer is the same update
    pu, st_ = sgd_update(t(params), t(grads), {"momentum": t(mom)}, lr=0.1)
    for a, b in zip(tree.leaves(po), tree.leaves(pu)):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(mo), tree.leaves(st_["momentum"])):
        assert torch.equal(a, b)
    zeros = sgd_init(t(params))["momentum"]
    assert all(float(z.abs().sum()) == 0.0 for z in tree.leaves(zeros))
