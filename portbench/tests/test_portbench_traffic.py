"""Traffic and weights are deterministic in ``--seed`` (a large one
too), and differ between seeds."""
import json

import numpy as np
import pytest
import torch

from portbench import harness, weights

SMALL = harness.BENCH_DIR / "tests" / "small"
SEEDS = (0, 2 ** 31 + 12345, 987654321987)


def mix(name):
    return json.loads((SMALL / "traffic" / f"{name}.json").read_text())


def config(name):
    return json.loads((SMALL / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("kind,name", [("train", "train_small"),
                                       ("prefill", "prefill_small")])
@pytest.mark.parametrize("seed", SEEDS)
def test_pool_deterministic(kind, name, seed):
    k = harness.load_module(harness.BENCH_DIR / "traffic" / f"{kind}.py",
                            "kind")
    a, b = k.draw_pool(config("tiny"), mix(name), seed), \
        k.draw_pool(config("tiny"), mix(name), seed)
    other = k.draw_pool(config("tiny"), mix(name), seed + 1)
    for x, y, z in zip(*(v if isinstance(v, tuple) else (v,)
                         for v in (a, b, other))):
        assert np.array_equal(x, y) and not np.array_equal(x, z)
        assert x.shape[0] == mix(name)["pool"]
        assert 0 <= x.min() and x.max() < config("tiny")["vocab_size"]


def test_batches_differ_row_by_row():
    k = harness.load_module(harness.BENCH_DIR / "traffic" / "train.py",
                            "kind")
    tokens, _ = k.draw_pool(config("tiny"), mix("train_small"), 5)
    rows = tokens.reshape(-1, tokens.shape[-1])
    assert len({r.tobytes() for r in rows}) == len(rows)


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_deterministic(seed):
    c = config("tinymoe")
    a, b = weights.draw(c, seed, "cpu"), weights.draw(c, seed, "cpu")
    other = weights.draw(c, seed + 1, "cpu")
    fa, fb, fo = (weights.flatten(t) for t in (a, b, other))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))
    drawn = [(x, z) for (p, x), (_, z) in zip(fa, fo) if x.std() > 0]
    assert drawn and all(not torch.equal(x, z) for x, z in drawn)


def test_weights_have_the_programs_layout():
    c = config("tiny")
    harness.check_layout(harness.port_config(c), weights.draw(c, 1, "cpu"))
