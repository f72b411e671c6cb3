"""The port's train step (``repro_torch.pipeline.make_train_step``: the
weight stash, the per-stage version blend, the optimizers) against the
JAX package's, on the CPU, and its own identities.

Both engines run three steps from the same numpy weights on a (2, 2, 2)
mesh (the JAX one under ``jax.jit`` over 8 host devices, the port's on a
``LocalMesh`` of that shape on the CPU). After each step every leaf of
the state (params, stash, optimizer state, step) and the metrics are
held within 1e-4 abs, in f32: the gradients agree to ~1e-6
(``tests/test_torch_pipeline.py``) and the learning rates are small
enough that three updates stay there (Adam's normalised step moves a
parameter by at most ~lr, SGD by lr times the gradient). With
``bf16_grads`` a gradient that lies within rounding of a bf16 boundary
rounds to neighbouring bf16 values in the two packages, one bf16 spacing
apart (at most 2^-7 of the value), and SGD's momentum holds the two
roundings. Measured: one embedding entry 1.2e-4 apart after step 1,
4.9e-4 after step 3 (the momentum sums three such gradients); 20 of
16,384 entries of one leaf (0.12%) beyond 1e-4, about what gradients
1e-6 apart in relative terms give against a bf16 spacing over three
steps. So in those cases at most 1% of an optimizer-state leaf may lie
beyond 1e-4, and those within 2^-6 of the leaf's largest |value| (two
bf16 spacings of it); the params move by lr times that and stay within
1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import both, cfgs, draw  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch.mesh import axis_types_kwarg, mesh_context  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.pipeline import pipeline_step as jps  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, lm_batches  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline import pipeline_step as ps  # noqa: E402

ATOL = 1e-4
STEPS = 3


@pytest.fixture(scope="module")
def jmesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 host devices")
    return jax.make_mesh((2, 2, 2), ("data", "stage", "tensor"),
                         **axis_types_kwarg(3))


@pytest.fixture(scope="module")
def mesh():
    return make_debug_mesh(2, 2, 2, device="cpu")


def _setup(**kw):
    jcfg, cfg = cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=2,
                     num_layers=4, **kw)
    np_p = draw(lambda k: JM.init_params(k, jcfg))
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (4, 16))
        .astype(np.int32)} for _ in range(STEPS)]
    return jcfg, cfg, np_p, batches


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_close_but_bf16_flips(a, w):
    """Within ATOL but for at most 1% of the entries, which stay within
    2^-6 of the leaf's largest |value| (see the module's docstring)."""
    off = np.abs(a - w) > ATOL
    assert off.sum() <= max(1, off.size // 100), off.sum()
    np.testing.assert_allclose(a, w, atol=2 ** -6 * np.abs(w).max())


# (optimizer, lr, stash_depth, aggregate_every, bf16_grads)
CASES = [("sgd", 0.05, 2, 2, False), ("sgd", 0.05, 1, 0, True),
         ("adam", 1e-4, 2, 2, True), ("adam", 1e-4, 1, 2, False)]


@pytest.mark.parametrize("opt,lr,depth,agg,bf16", CASES)
def test_train_steps_match_jax(jmesh, mesh, opt, lr, depth, agg, bf16):
    jcfg, cfg, np_p, batches = _setup(stash_depth=depth, aggregate_every=agg)
    kw = dict(learning_rate=lr, optimizer=opt, microbatches=2,
              weight_decay=1e-3, bf16_grads=bf16)
    jp, p = both(np_p)
    with mesh_context(jmesh):
        jstep_fn, _ = jps.make_train_step(jmesh, jcfg, JTrainConfig(**kw))
        jstate = jstep_fn.init_state(jp)
        jstep = jax.jit(jstep_fn)
        jhist = []
        for b in batches:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            jhist.append((jax.tree.leaves(jstate), jm))
    step_fn, _ = ps.make_train_step(mesh, cfg, TrainConfig(**kw))
    state = step_fn.init_state(p)
    for b, (jleaves, jm) in zip(batches, jhist):
        state, m = step_fn(state, _tb(b))
        leaves, paths = tree.flatten(state)
        assert len(leaves) == len(jleaves)
        for a, w, path in zip(leaves, jleaves, paths):
            assert a.dtype == {"float32": torch.float32,
                               "int32": torch.int32}[str(w.dtype)]
            if bf16 and path[0] == "opt_state":
                assert_close_but_bf16_flips(a.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                           atol=ATOL)
        for k in ("loss", "aux"):
            assert float(m[k]) == pytest.approx(float(jm[k]), abs=ATOL)
    assert int(state["step"]) == STEPS


def test_stash_and_blend_identities_bit_for_bit(mesh):
    """stash_depth 2: the stash after step 1 IS the initial params; at
    step 2 (aggregate_every 2) the last stage keeps the new params bit for
    bit and every earlier stage equals an independent 0.5 blend of (new,
    stash) bit for bit; embed, head and final norm are not blended. Every
    tensor of a state passed in is left as it was, including the initial
    one, whose params and stash are the same tensors."""
    _, cfg, np_p, batches = _setup(stash_depth=2, aggregate_every=2)
    p = M.params_from_numpy(np_p)
    tc = TrainConfig(learning_rate=0.05, optimizer="adam", microbatches=2,
                     weight_decay=0.0)
    step_fn, _ = ps.make_train_step(mesh, cfg, tc)
    plain_fn, _ = ps.make_train_step(
        mesh, cfg.with_overrides(aggregate_every=0), tc)
    s0 = step_fn.init_state(p)
    assert s0["params"] is s0["stash"]
    before = [t.clone() for t in tree.leaves(s0)]
    s1, _ = step_fn(s0, _tb(batches[0]))
    for a, b in zip(tree.leaves(s0), before):
        assert torch.equal(a, b) and not a.requires_grad
    for a, b in zip(tree.leaves(s1["stash"]), tree.leaves(p)):
        assert torch.equal(a, b)
    before = [t.clone() for t in tree.leaves(s1)]
    s2, _ = step_fn(s1, _tb(batches[1]))
    n2, _ = plain_fn(s1, _tb(batches[1]))       # the same step, no blend
    for a, b in zip(tree.leaves(s1), before):
        assert torch.equal(a, b)
    assert int(s2["step"]) == 2
    S = cfg.pipeline_stages
    for key in ("embed", "head", "final_norm"):
        for a, b in zip(tree.leaves(s2["params"][key]),
                        tree.leaves(n2["params"][key])):
            assert torch.equal(a, b)
    moved = 0
    for a, n, st in zip(tree.leaves(s2["params"]["blocks"]),
                        tree.leaves(n2["params"]["blocks"]),
                        tree.leaves(s1["stash"]["blocks"])):
        assert torch.equal(a[S - 1], n[S - 1])
        assert torch.equal(a[:S - 1], 0.5 * n[:S - 1] + 0.5 * st[:S - 1])
        moved += int(not torch.equal(a[:S - 1], n[:S - 1]))
    assert moved > 0
    for a, b in zip(tree.leaves(s2["stash"]), tree.leaves(s1["params"])):
        assert a is b


def _train(mesh, cfg, steps=40, lr=0.02, opt="adam"):
    tc = TrainConfig(learning_rate=lr, optimizer=opt, microbatches=2,
                     weight_decay=0.0)
    step_fn, _ = ps.make_train_step(mesh, cfg, tc)
    state = step_fn.init_state(M.init_params(0, cfg, device="cpu"))
    ds = SyntheticLM(vocab_size=cfg.vocab_size)
    losses = []
    for x, y in lm_batches(ds, 8, 32, steps):
        state, m = step_fn(state, {"tokens": torch.from_numpy(x),
                                   "labels": torch.from_numpy(y)})
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("depth,agg,margin", [(1, 0, 0.1), (2, 4, 0.05)])
def test_pipelined_training_learns(mesh, depth, agg, margin):
    """tests/test_system.py:44-60 on the port: 40 Adam steps on
    SyntheticLM, the mean of the last 8 losses below the first 8's by the
    JAX test's margins."""
    _, cfg = cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=2,
                  num_layers=4, vocab_size=256, stash_depth=depth,
                  aggregate_every=agg)
    losses, _ = _train(mesh, cfg)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - margin


def test_checkpoint_recovery_roundtrip(mesh, tmp_path):
    """tests/test_system.py:84-112 on the port: train, checkpoint, 'lose'
    the state, restore, bit-equality; training goes on from the restored
    params as from the live ones."""
    _, cfg = cfgs("qwen2-1.5b", pipeline_stages=2, tensor_parallel=2,
                  num_layers=4, vocab_size=256)
    _, state = _train(mesh, cfg, steps=3)
    cs = CheckpointStore(str(tmp_path))
    cs.save(3, state["params"])
    like = tree.map(torch.zeros_like, state["params"])
    restored, step = cs.restore_latest(like)
    assert step == 3
    for a, b in zip(tree.leaves(restored), tree.leaves(state["params"])):
        assert torch.equal(a, b)
    tc = TrainConfig(learning_rate=0.02, optimizer="sgd", microbatches=2)
    step_fn, _ = ps.make_train_step(mesh, cfg, tc)
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "labels": torch.ones((8, 16), dtype=torch.int32)}
    a, _ = step_fn(step_fn.init_state(restored), batch)
    b, _ = step_fn(step_fn.init_state(copy.copy(state["params"])), batch)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
