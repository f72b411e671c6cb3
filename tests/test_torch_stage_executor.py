"""The port's packed layouts and ``StageExecutor`` against the JAX reference
(``repro.runtime.stage_executor``), on identical weights.

Each package runs 5 steps on its OWN state (a real multi-step parity, the
way a stage trains), against the reference's ``compiled=False`` path
(eager ``jax.vjp`` + ``optim/sgd``). Tolerances grow with the depth of
what is compared:
  * mlp slices: rtol 1e-4, atol 1e-5. f32 on both sides; the reference's
    own two paths already drift ~1e-6 abs apart by step 4 (reassociation),
    and the port's differ from it by the same kind of rounding;
  * MobileNet slices: rtol 1e-4, atol 1e-4. Train-mode BatchNorm
    amplifies the convolutions' different summation orders in the
    backward (at batch 4 the gradient is ill-conditioned in f32), and
    five SGD steps feed that back into the weights and the next forward.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.models import mobilenet as ref_mn  # noqa: E402
from repro.runtime import stage_executor as ref_se  # noqa: E402
from repro.runtime import workload as ref_wl  # noqa: E402
from repro_torch.runtime import stage_executor as se  # noqa: E402
from repro_torch.runtime import workload as wl  # noqa: E402

LR, MOM, WD = 0.05, 0.9, 4e-5


def _mobilenet_shapes():
    box = []

    def init(k):
        layers, meta = ref_mn.init_layers(k)
        box.append(meta)
        return layers

    return jax.eval_shape(init, jax.random.PRNGKey(0)), box[0]


def _ref_mobilenet_chain(np_layers, meta):
    """The reference's LayerChain over given weights (``mobilenet_chain``
    without its jax.random init)."""
    def loss(y, batch):
        logp = jax.nn.log_softmax(y)
        return -jnp.mean(jnp.take_along_axis(
            logp, batch["labels"][:, None], axis=1))

    return ref_wl.LayerChain(
        params=[jax.tree.map(jnp.asarray, p) for p in np_layers],
        apply_layer=lambda j, p, x: ref_mn.apply_layer(p, meta[j], x),
        loss=loss, input_of=lambda b: b["x"])


@pytest.fixture(scope="module")
def chains():
    """(reference chain, port chain) pairs on identical weights."""
    ref_mlp = ref_wl.mlp_chain(jax.random.PRNGKey(7), num_layers=6)
    port_mlp = wl.mlp_chain(torch.Generator().manual_seed(7), num_layers=6)
    port_mlp.load_flat_params(
        {j: np.asarray(f) for j, f in ref_mlp.flat_params().items()})
    shapes, meta = _mobilenet_shapes()
    rng = np.random.default_rng(0)
    np_layers = [jax.tree.map(
        lambda s: (rng.normal(size=s.shape)
                   / math.sqrt(math.prod(s.shape[:-1]) or 1)
                   ).astype(np.float32), s) for s in shapes]
    ref_mn_chain = _ref_mobilenet_chain(np_layers, meta)
    port_mn = wl.mobilenet_chain(torch.Generator().manual_seed(0))
    port_mn.load_flat_params(
        {j: np.asarray(f) for j, f in ref_mn_chain.flat_params().items()})
    return {"mlp": (ref_mlp, port_mlp), "mobilenet": (ref_mn_chain, port_mn)}


# ============================== layouts ==================================

@pytest.mark.parametrize("kind", ["mlp", "mobilenet"])
def test_layouts_and_offsets_match_reference(chains, kind):
    ref, port = chains[kind]
    rl, pl = ref.flat_layout(), port.flat_layout()
    L = rl.num_layers
    assert pl.num_layers == L
    assert [pl.layer_size(j) for j in range(L)] == \
        [rl.layer_size(j) for j in range(L)]
    assert [pl.layer_nbytes(j) for j in range(L)] == \
        [rl.layer_nbytes(j) for j in range(L)]
    for a, e in [(0, L - 1), (1, 3), (L - 2, L - 1)]:
        assert pl.slice(a, e).offsets == rl.slice(a, e).offsets
        assert pl.slice(a, e).size == rl.slice(a, e).size
    # flat buffers swap between the packages: the reference's packed
    # layer unpacks in the port into the reference's own leaves
    for j in range(L):
        flat = np.asarray(ref.flat_params(j, j)[j])
        got = pl.unpack_layer(j, torch.tensor(flat))
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got)),
                        jax.tree.leaves(ref.params[j])):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(port.flat_params(j, j)[j].numpy(), flat)


# ============================ step parity ================================

CASES = {
    # kind, (a, e), last, input shape, tolerance
    "mlp-mid": ("mlp", (1, 3), False, (4, 16), dict(rtol=1e-4, atol=1e-5)),
    "mlp-last": ("mlp", (3, 5), True, (8, 16), dict(rtol=1e-4, atol=1e-5)),
    "mobilenet-mid": ("mobilenet", (2, 4), False, (4, 8, 8, 16),
                      dict(rtol=1e-4, atol=1e-4)),
    "mobilenet-last": ("mobilenet", (16, 18), True, (4, 2, 2, 160),
                       dict(rtol=1e-4, atol=1e-4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_reference(chains, case):
    kind, (a, e), last, shape, tol = CASES[case]
    ref, port = chains[kind]
    rsl, buf_r = ref.flat_slice(a, e)
    psl, buf_p = port.flat_slice(a, e)
    ex_r = ref_se.StageExecutor(ref, rsl, last=last, lr=LR, momentum=MOM,
                                weight_decay=WD, compiled=False)
    # the reference's uncompiled step and forward, traced once each
    # instead of dispatched op by op (the same computation, much faster)
    ex_r._step, ex_r._forward = jax.jit(ex_r._step), jax.jit(ex_r._forward)
    ex_p = se.StageExecutor(port, psl, last=last, lr=LR, momentum=MOM,
                            weight_decay=WD, device="cpu")
    mom_r, mom_p = rsl.zeros(), psl.zeros()
    ver_r, ver_p = [buf_r], [buf_p]           # vertical-sync version ring
    rng = np.random.default_rng(3)
    n_cls = 4 if kind == "mlp" else 10
    for t in range(5):
        x = rng.normal(size=shape).astype(np.float32)
        ct = None
        if not last:
            # a mean-loss-sized cotangent (1/size per element) for the
            # conv chain: unit entries would make its gradients ~100x a
            # real loss's and the five steps a divergent run
            y_shape = ex_r.forward(buf_r, x).shape
            scale = 1.0 if kind == "mlp" else 1.0 / math.prod(y_shape)
            ct = (scale * rng.normal(size=y_shape)).astype(np.float32)
        labels = rng.integers(0, n_cls, shape[0]).astype(np.int32)
        batch_r = {"labels": jnp.asarray(labels)} if last else None
        batch_p = {"labels": torch.from_numpy(labels)} if last else None
        y_r = ex_r.forward(ver_r[-1], x, batch_r)
        y_p = ex_p.forward(ver_p[-1], x, batch_p)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **tol)
        v = max(0, t - 1)                     # pin an older version
        dx_r, new_r, mom_r = ex_r.step(ver_r[v], ver_r[-1], mom_r, x, ct,
                                       batch_r)
        dx_p, new_p, mom_p = ex_p.step(ver_p[v], ver_p[-1], mom_p, x, ct,
                                       batch_p)
        np.testing.assert_allclose(dx_p.numpy(), np.asarray(dx_r), **tol)
        np.testing.assert_allclose(new_p.numpy(), np.asarray(new_r), **tol)
        np.testing.assert_allclose(mom_p.numpy(), np.asarray(mom_r), **tol)
        ver_r.append(new_r)
        ver_p.append(new_p)


@pytest.mark.parametrize("compiled", [True, False])
def test_step_writes_no_input_in_place(chains, compiled):
    """The stash and the replica stores keep references to the buffers a
    step reads: a step must build new tensors and bump no version
    counter, and must leave no autograd state on them."""
    _, port = chains["mlp"]
    sl, buf = port.flat_slice(1, 3)
    ex = se.StageExecutor(port, sl, last=False, lr=LR, momentum=MOM,
                          weight_decay=WD, compiled=compiled, device="cpu")
    old = buf * 0.5
    mom = sl.zeros() + 0.1
    x, ct = torch.randn(4, 16), torch.randn(4, 16)
    ins = (old, buf, mom, x, ct)
    versions = [t._version for t in ins]
    copies = [t.clone() for t in ins]
    dx, new, new_mom = ex.step(old, buf, mom, x, ct)
    assert [t._version for t in ins] == versions
    for t, c in zip(ins, copies):
        assert torch.equal(t, c) and not t.requires_grad and t.grad is None
    ptrs = {t.data_ptr() for t in ins}
    assert new.data_ptr() not in ptrs and new_mom.data_ptr() not in ptrs
    assert not (new.requires_grad or new_mom.requires_grad
                or dx.requires_grad)
    assert ex.change_counts == {1: 1, 2: 1, 3: 1}


def test_aggregate_and_pack_build_new_tensors(chains):
    _, port = chains["mlp"]
    sl, buf = port.flat_slice(0, 2)
    other = buf + 1.0
    mean = se.aggregate_packed([buf, other])
    torch.testing.assert_close(mean, buf + 0.5)
    assert mean.data_ptr() not in (buf.data_ptr(), other.data_ptr())
    flats = {j: sl.view(buf, j) for j in sl.layer_ids}
    packed = sl.pack(flats)
    assert torch.equal(packed, buf) and packed.data_ptr() != buf.data_ptr()
