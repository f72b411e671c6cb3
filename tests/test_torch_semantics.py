"""The port's async-semantics oracle (``repro_torch.runtime.semantics``,
``repro_torch.core.stash``): the cases of ``tests/test_semantics.py`` on
the port, and the port's ``AsyncTrainingExecutor`` against the JAX
package's on the same initial weights (carried across as numpy arrays)
and batches — per-batch losses rtol 1e-5, final parameters rtol 1e-5,
atol 1e-6 — with and without weight aggregation, and with aggregation
routed through each package's ``fleet.layer_aggregate_op`` (the live
runtime's packed mean)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core.stash import tree_mean as ref_tree_mean  # noqa: E402
from repro.data.synthetic import SyntheticClassification as RefData  # noqa: E402
from repro.data.synthetic import class_batches as ref_batches  # noqa: E402
from repro.optim import sgd_init as ref_sgd_init  # noqa: E402
from repro.optim import sgd_update as ref_sgd_update  # noqa: E402
from repro.runtime import fleet as ref_fleet  # noqa: E402
from repro.runtime.semantics import AsyncTrainingExecutor as RefExecutor  # noqa: E402
from repro.runtime.stage_executor import ChainLayout as RefLayout  # noqa: E402
from repro_torch.core.schedule import version_for_batch  # noqa: E402
from repro_torch.core.stash import VersionedWeights, tree_mean  # noqa: E402
from repro_torch.data.synthetic import (SyntheticClassification,  # noqa: E402
                                        class_batches)
from repro_torch.optim import sgd_init, sgd_update  # noqa: E402
from repro_torch.runtime import fleet  # noqa: E402
from repro_torch.runtime.semantics import AsyncTrainingExecutor  # noqa: E402
from repro_torch.runtime.stage_executor import ChainLayout  # noqa: E402

DIMS = (64, 32, 32, 10)


def _np_mlp():
    """The weights of ``tests/test_semantics.py``'s ``_mlp`` (its
    ``jax.random`` draws), carried across as numpy arrays: its lr=0.3
    regime (plain run diverges, aggregated run stays bounded) is a
    property of these weights, in both packages."""
    import jax
    params, d_in, key = [], 64, jax.random.PRNGKey(0)
    for d in DIMS:
        key, k = jax.random.split(key)
        params.append({"w": np.asarray(jax.random.normal(k, (d_in, d))
                                       / np.sqrt(d_in), np.float32),
                       "b": np.zeros(d, np.float32)})
        d_in = d
    return params


def _mlp():
    return [{k: torch.tensor(v) for k, v in p.items()} for p in _np_mlp()]


def _loss(layers, batch):
    x, y = batch
    h = x.reshape(x.shape[0], -1)
    for i, p in enumerate(layers):
        h = h @ p["w"] + p["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    lp = torch.log_softmax(h, dim=-1)
    return -lp.gather(1, y[:, None].long()).mean()


def _ref_loss(layers, batch):
    import jax
    x, y = batch
    h = x.reshape(x.shape[0], -1)
    for i, p in enumerate(layers):
        h = h @ p["w"] + p["b"]
        if i < len(layers) - 1:
            h = jax.nn.relu(h)
    lp = jax.nn.log_softmax(h)
    return -jnp.mean(jnp.take_along_axis(lp, y[:, None], 1))


def _np_batches(n, batch=32):
    ds = SyntheticClassification(num_classes=10, image_hw=8, channels=1,
                                 noise=0.8)
    return list(class_batches(ds, batch, n, seed=0))


def _batches(n=60, batch=32):
    return [(torch.tensor(x), torch.tensor(y))
            for x, y in _np_batches(n, batch)]


def _assignment(L, n_stages):
    base, extra = divmod(L, n_stages)
    return [base + (1 if i < extra else 0) for i in range(n_stages)]


def _run(n_stages, aggregate_every, lr=0.02, n=60, aggregate_op=None):
    params = _mlp()
    ex = AsyncTrainingExecutor(
        _loss, num_stages=n_stages,
        assignment=_assignment(len(params), n_stages),
        update_fn=lambda p, g, s: sgd_update(p, g, s, lr=lr,
                                             weight_decay=0.0),
        opt_state=sgd_init(params), aggregate_every=aggregate_every,
        aggregate_op=aggregate_op)
    return ex.run(params, _batches(n))


def _ref_run(n_stages, aggregate_every, lr=0.02, n=60, aggregate_op=None):
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in _np_mlp()]
    ex = RefExecutor(
        _ref_loss, num_stages=n_stages,
        assignment=_assignment(len(params), n_stages),
        update_fn=lambda p, g, s: ref_sgd_update(p, g, s, lr=lr,
                                                 weight_decay=0.0),
        opt_state=ref_sgd_init(params), aggregate_every=aggregate_every,
        aggregate_op=aggregate_op)
    ds = RefData(num_classes=10, image_hw=8, channels=1, noise=0.8)
    batches = [(jnp.asarray(x), jnp.asarray(y))
               for x, y in ref_batches(ds, 32, n, seed=0)]
    return ex.run(params, batches)


# --------------------- the cases of tests/test_semantics.py ---------------

def test_single_stage_equals_synchronous_sgd():
    """n=1: no staleness — must match a plain SGD loop exactly."""
    from repro_torch.runtime.semantics import value_and_grad
    batches = _batches(20)
    _, losses_async = _run(1, 0, n=20)
    p = _mlp()
    st = sgd_init(p)
    ref = []
    for b in batches:
        loss, g = value_and_grad(_loss, p, b)
        ref.append(loss.item())
        p, st = sgd_update(p, g, st, lr=0.02, weight_decay=0.0)
    np.testing.assert_allclose(losses_async, ref, rtol=1e-5)


def test_multi_stage_converges():
    _, losses = _run(3, 0, lr=0.01)
    assert np.mean(losses[-10:]) < np.mean(losses[:10])


def test_aggregation_stabilizes_high_lr():
    """Paper Fig. 4 mechanism: at lr=0.3 the plain 3-stage async run
    diverges to a non-finite loss, while periodic aggregation keeps the
    same run bounded."""
    _, base = _run(3, 0, lr=0.3, n=120)
    _, agg = _run(3, 3, lr=0.3, n=120)
    assert not np.isfinite(np.mean(base[-20:]))
    agg_tail = np.mean(agg[-20:])
    assert np.isfinite(agg_tail) and agg_tail < 5.0


def test_versions_are_stale_by_pipeline_depth():
    """Batch b trains on weights v(b) = max(0, b - n + 1)."""
    params = _mlp()
    ex = AsyncTrainingExecutor(
        _loss, num_stages=3, assignment=[2, 1, 1],
        update_fn=lambda p, g, s: sgd_update(p, g, s, lr=0.0,
                                             weight_decay=0.0),
        opt_state=sgd_init(params), aggregate_every=0)
    orig_get = ex.stash.get
    fetches = []
    ex.stash.get = lambda v: (fetches.append(v), orig_get(v))[1]
    ex.run(params, _batches(10))
    assert fetches == [version_for_batch(b, 3) for b in range(10)]


# ----------------------------- against the JAX package --------------------

def _assert_params_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("aggregate_every", [0, 3])
def test_executor_matches_reference(aggregate_every):
    got_p, got_l = _run(3, aggregate_every, n=40)
    want_p, want_l = _ref_run(3, aggregate_every, n=40)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    _assert_params_close(got_p, want_p)


def test_packed_aggregation_matches_reference_and_tree_mean():
    """Aggregation through each package's ``layer_aggregate_op`` (the live
    runtime's ``aggregate_packed``): the two packages agree, and the port's
    packed mean is the plain tree mean to f32 rounding."""
    layout = ChainLayout.of_params(_mlp())
    got_p, got_l = _run(3, 3, n=40,
                        aggregate_op=fleet.layer_aggregate_op(layout))
    ref_layout = RefLayout.of_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in _np_mlp()])
    want_p, want_l = _ref_run(
        3, 3, n=40, aggregate_op=ref_fleet.layer_aggregate_op(ref_layout))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    _assert_params_close(got_p, want_p)
    plain_p, plain_l = _run(3, 3, n=40)
    np.testing.assert_allclose(got_l, plain_l, rtol=1e-5)


def test_tree_mean_and_versioned_weights_match_reference():
    rng = np.random.default_rng(1)
    trees = [[{"w": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.standard_normal(4).astype(np.float32)}]
             for _ in range(3)]
    got = tree_mean([[{k: torch.tensor(v) for k, v in t[0].items()}]
                     for t in trees])
    want = ref_tree_mean([[{k: jnp.asarray(v) for k, v in t[0].items()}]
                          for t in trees])
    for k in ("w", "b"):
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                   rtol=1e-6, atol=1e-7)
    vw = VersionedWeights(depth=2)
    for v in range(4):
        vw.put(v, {"x": torch.full((2,), float(v))})
    assert vw.live_versions() == [2, 3]
    assert vw.get(1)["x"][0].item() == 2.0      # never a newer version...
    assert vw.get(9)["x"][0].item() == 3.0      # ...nor a missing one
    mean = vw.aggregate()
    assert vw.head == 4 and vw.live_versions() == [4]
    assert mean["x"].tolist() == [2.5, 2.5]
