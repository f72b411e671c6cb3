"""The port's optimizers and LR schedules (``repro_torch.optim``) against
the JAX package's, on the CPU: Adam over a few steps on a tree of dicts
and lists (f32 and bf16 leaves), with and without weight decay, at a
fixed and at a scheduled learning rate; both schedules over a range of
steps. Tolerances: 1e-6 relative on f32 values (the same f32 operations,
in the same order, elementwise); a bf16 param one bf16 spacing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import optim as joptim  # noqa: E402
from repro_torch import optim, tree  # noqa: E402


def _tree(seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"a": n(5, 3),
            "blocks": [{"w": n(4, 4), "b": n(4)}, {"w": n(2, 4)}]}


def _both(np_tree, jdtype=jnp.float32, tdtype=torch.float32):
    return (jax.tree.map(lambda a: jnp.asarray(a, jdtype), np_tree),
            tree.map(lambda a: torch.from_numpy(a).to(tdtype), np_tree))


def _close(got, want, rtol=1e-6, atol=1e-7):
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("weight_decay,scheduled", [
    (0.0, False), (0.01, False), (0.01, True)])
def test_adam_matches_jax_over_steps(weight_decay, scheduled):
    np_p = _tree(0)
    jp, p = _both(np_p)
    js, s = joptim.adam_init(jp), optim.adam_init(p)
    assert s["count"].dtype == torch.int32 and int(s["count"]) == 0
    jlr = joptim.warmup_cosine(1e-2, 2, 6) if scheduled else (lambda i: 1e-2)
    lr = optim.warmup_cosine(1e-2, 2, 6) if scheduled else (lambda i: 1e-2)
    jupd = jax.jit(lambda p_, g_, s_, lr_: joptim.adam_update(
        p_, g_, s_, lr=lr_, weight_decay=weight_decay))
    for i in range(6):
        np_g = _tree(10 + i)
        jg, g = _both(np_g)
        jp, js = jupd(jp, jg, js, jlr(i))
        p, s = optim.adam_update(p, g, s, lr=lr(i),
                                 weight_decay=weight_decay)
        _close(p, jp)
        _close(s["m"], js["m"])
        _close(s["v"], js["v"])
        assert int(s["count"]) == int(js["count"]) == i + 1


def test_adam_keeps_bf16_params_bf16_with_f32_moments():
    np_p = _tree(1)
    jp, p = _both(np_p, jnp.bfloat16, torch.bfloat16)
    js, s = joptim.adam_init(jp), optim.adam_init(p)
    np_g = _tree(2)
    jg, g = _both(np_g, jnp.bfloat16, torch.bfloat16)
    for _ in range(3):
        jp, js = joptim.adam_update(jp, jg, js, lr=1e-2, weight_decay=0.1)
        p, s = optim.adam_update(p, g, s, lr=1e-2, weight_decay=0.1)
    assert all(a.dtype == torch.bfloat16 for a in tree.leaves(p))
    assert all(a.dtype == torch.float32 for a in tree.leaves(s["m"]))
    _close(s["v"], js["v"])
    # equal up to one bf16 spacing of the param (the f32 update is rounded
    # once; the two packages may round a tie differently)
    _close(p, jp, rtol=2 ** -7, atol=0)


def test_adam_writes_no_input():
    np_p = _tree(3)
    _, p = _both(np_p)
    before = tree.map(torch.clone, p)
    s = optim.adam_init(p)
    _, g = _both(_tree(4))
    optim.adam_update(p, g, s, lr=0.1)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p),
                                                 tree.leaves(before)))
    assert int(s["count"]) == 0


def test_step_decay_matches_jax():
    for kw in ({}, {"boundaries": (3, 7), "factor": 0.5},
               {"boundaries": ()}):
        j, t = joptim.step_decay(0.1, **kw), optim.step_decay(0.1, **kw)
        for e in range(0, 200, 3):
            got = t(e)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(j(e)), rtol=1e-7)
        assert float(t(torch.tensor(135))) == pytest.approx(float(j(135)))


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (0, 50, 0.0),
                                                (5, 5, 0.2)])
def test_warmup_cosine_matches_jax(warmup, total, floor):
    j = joptim.warmup_cosine(3e-4, warmup, total, floor)
    t = optim.warmup_cosine(3e-4, warmup, total, floor)
    for step in range(0, total + 20):
        got = t(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j(step)), rtol=1e-6)


def test_get_optimizer_names():
    assert set(optim.OPTIMIZERS) == set(joptim.OPTIMIZERS) == {"sgd", "adam"}
    assert optim.get_optimizer("adam") == (optim.adam_init,
                                           optim.adam_update)
