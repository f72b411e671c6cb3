"""The port's continuous-batching serving engine
(``repro_torch.serving.ServingEngine``) against the JAX package's, on the
CPU: on identical weights (drawn with numpy, carried across with
``params_from_numpy``) the two engines stream the same tokens, token for
token, for the prompts of ``tests/test_serving.py`` — interleaving in
fewer slots than requests, slot reuse with its cache-row reset, EOS, and
retirement at the cache length. Greedy decoding compares argmaxes, so the
weights are scaled to make the logits' top-2 gaps large against the
~1e-6 by which the two packages' f32 sums differ (checked below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def setup():
    kw = dict(num_layers=2, vocab_size=128)
    jcfg = jax_config("qwen2-1.5b").reduced(**kw)
    cfg = get_config("qwen2-1.5b").reduced(**kw)
    rng = np.random.default_rng(0)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if "table" in name:         # O(1) embeddings: peaked logits
            return rng.standard_normal(s.shape).astype(np.float32)
        scale = 0.1 if "'b'" in name else s.shape[-2] ** -0.5
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            M.params_from_numpy(np_params))


def _streams(setup, prompts, max_new, **kw):
    jcfg, jparams, cfg, params = setup
    out = []
    for Engine, c, p, extra in ((JaxEngine, jcfg, jparams, {}),
                                (ServingEngine, cfg, params,
                                 {"device": "cpu"})):
        eng = Engine(c, p, **kw, **extra)
        uids = [eng.submit(q, max_new_tokens=max_new) for q in prompts]
        res = eng.run_until_drained()
        out.append([res[u] for u in uids])
    return out


def test_single_request(setup):
    want, got = _streams(setup, [[5, 9, 2]], 6, max_slots=2, cache_len=32)
    assert got == want and len(got[0]) == 6


def test_interleaved_requests_in_fewer_slots(setup):
    prompts = [[5, 9, 2], [7], [11, 3], [1, 2, 3, 4]]
    want, got = _streams(setup, prompts, 5, max_slots=2, cache_len=32)
    assert got == want and all(len(g) == 5 for g in got)


def test_slot_reuse_resets_cache(setup):
    want, got = _streams(setup, [[5, 9, 2], [7, 7]], 4, max_slots=1,
                         cache_len=32)
    assert got == want


def test_eos_stops_generation(setup):
    (ref,), _ = _streams(setup, [[5, 9, 2]], 8, max_slots=1, cache_len=32)
    eos = ref[2]
    want, got = _streams(setup, [[5, 9, 2]], 8, max_slots=1, cache_len=32,
                         eos_id=eos)
    assert got == want and got[0][-1] == eos and len(got[0]) <= 3


def test_retires_at_cache_length(setup):
    want, got = _streams(setup, [[5, 9, 2], [4]], 20, max_slots=2,
                         cache_len=8)
    assert got == want and [len(g) for g in got] == [6, 8]


def test_logit_gaps_dwarf_the_rounding(setup):
    """What makes token-for-token equality a fair check: on these weights
    the port's and the JAX package's logits agree to 1e-4 while the
    smallest top-2 gap along a greedy stream is far larger."""
    jcfg, jparams, cfg, params = setup
    jc = JM.init_caches(jcfg, batch=1, cache_len=32, dtype=jnp.float32)
    c = M.init_caches(cfg, batch=1, cache_len=32, dtype=torch.float32,
                      device="cpu")
    step = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    tok, gaps = 5, []
    for pos in range(12):
        want, jc = step(jparams, jnp.asarray([[tok]], jnp.int32), jc,
                        jnp.int32(pos))
        got, c = M.sequential_decode_step(params, cfg, [[tok]], c, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        top2 = torch.topk(got[0, 0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        tok = int(torch.argmax(got[0, 0]))
    assert min(gaps) > 1e-3, gaps


def test_temperature_sampling_is_deterministic_in_the_seed(setup):
    _, _, cfg, params = setup

    def run(seed):
        eng = ServingEngine(cfg, params, max_slots=2, cache_len=32,
                            temperature=1.0, seed=seed, device="cpu")
        uids = [eng.submit(q, max_new_tokens=6) for q in ([5, 9], [3])]
        out = eng.run_until_drained()
        return [out[u] for u in uids]

    a, b = run(1), run(1)
    assert a == b and all(len(s) == 6 for s in a)
    assert all(0 <= t < cfg.vocab_size for s in a for t in s)


# ------------------- the hybrid family (zamba2, reduced) -------------------

@pytest.fixture(scope="module")
def hybrid_setup():
    """zamba2-7b reduced (2 stages of a hybrid and a mamba slot), drawn as
    ``setup`` draws qwen2's; the SSM leaves keep the JAX init's values."""
    kw = dict(num_layers=4, vocab_size=128)
    jcfg = jax_config("zamba2-7b").reduced(**kw)
    cfg = get_config("zamba2-7b").reduced(**kw)
    rng = np.random.default_rng(1)
    own = JM.init_params(KEY, jcfg)

    def draw(path, s, v):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("A_log", "dt_bias", "'D'", "conv_b")):
            return np.asarray(v)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if "table" in name:
            return rng.standard_normal(s.shape).astype(np.float32)
        scale = 0.1 if "'b'" in name else s.shape[-2] ** -0.5
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY), own)
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            M.params_from_numpy(np_params))


def test_hybrid_interleaved_requests_in_fewer_slots(hybrid_setup):
    prompts = [[5, 9, 2], [7], [11, 3], [1, 2, 3, 4]]
    want, got = _streams(hybrid_setup, prompts, 5, max_slots=2,
                         cache_len=32)
    assert got == want and all(len(g) == 5 for g in got)


def test_hybrid_slot_reuse_resets_the_ssm_state(hybrid_setup):
    """A reused slot starts from zero conv and SSM state, not the last
    request's: the second request's stream equals the JAX engine's and a
    fresh engine's."""
    want, got = _streams(hybrid_setup, [[5, 9, 2], [7, 7]], 4, max_slots=1,
                         cache_len=32)
    assert got == want
    _, _, cfg, params = hybrid_setup
    eng = ServingEngine(cfg, params, max_slots=1, cache_len=32,
                        device="cpu")
    eng.submit([5, 9, 2], max_new_tokens=4)
    eng.run_until_drained()
    assert all(bool((c["mamba"]["ssm"] != 0).any()) for c in eng.caches)
    eng.submit([7, 7], max_new_tokens=4)
    eng.step()                               # admits: rows zeroed, 1 step
    fresh = ServingEngine(cfg, params, max_slots=1, cache_len=32,
                          device="cpu")
    fresh.submit([7, 7], max_new_tokens=4)
    fresh.step()
    for a, b in zip(eng.caches, fresh.caches):
        for x, y in zip(a["mamba"].values(), b["mamba"].values()):
            assert torch.equal(x, y)


def test_hybrid_logit_gaps_dwarf_the_rounding(hybrid_setup):
    """The port's and the JAX package's decode logits agree to 1e-4 while
    the smallest top-2 gap along a greedy stream is far larger."""
    jcfg, jparams, cfg, params = hybrid_setup
    jc = JM.init_caches(jcfg, batch=1, cache_len=32, dtype=jnp.float32)
    c = M.init_caches(cfg, batch=1, cache_len=32, dtype=torch.float32,
                      device="cpu")
    step = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    tok, gaps = 5, []
    for pos in range(12):
        want, jc = step(jparams, jnp.asarray([[tok]], jnp.int32), jc,
                        jnp.int32(pos))
        got, c = M.sequential_decode_step(params, cfg, [[tok]], c, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        top2 = torch.topk(got[0, 0], 2).values
        gaps.append(float(top2[0] - top2[1]))
        tok = int(torch.argmax(got[0, 0]))
    assert min(gaps) > 1e-3, gaps
