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

from _torch_parity import both, cfgs, draw  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def _family_setup(arch, seed, **kw):
    """``arch`` reduced to a 128-token vocab, weights drawn with numpy
    (``_torch_parity.draw``, O(1) embeddings: peaked logits), as (JAX
    config, JAX params, port config, port params)."""
    jcfg, cfg = cfgs(arch, vocab_size=128, **kw)
    jparams, params = both(draw(lambda k: JM.init_params(k, jcfg), seed,
                                table_scale=1.0))
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def setup():
    return _family_setup("qwen2-1.5b", 0, num_layers=2)


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
    """zamba2-7b reduced (2 stages of a hybrid and a mamba slot); the SSM
    leaves keep the JAX init's values."""
    return _family_setup("zamba2-7b", 1, num_layers=4)


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


# -------------- the moe and ssm families (olmoe, xlstm reduced) ------------

@pytest.fixture(scope="module")
def moe_setup():
    return _family_setup("olmoe-1b-7b", 2)


@pytest.fixture(scope="module")
def xlstm_setup():
    return _family_setup("xlstm-125m", 3, num_layers=6)


def _jax_sequential(setup, prompt, max_new):
    """Greedy tokens of the JAX package's ``sequential_decode_step`` from
    ``init_caches`` (batch 1), and the smallest top-2 logit gap among the
    generated tokens."""
    jcfg, jparams, _, _ = setup
    jc = JM.init_caches(jcfg, batch=1, cache_len=32, dtype=jnp.float32)
    step = jax.jit(lambda p_, t_, c_, pos_: JM.sequential_decode_step(
        p_, jcfg, t_, c_, pos_))
    fed, out, gap = list(prompt), [], float("inf")
    for pos in range(len(prompt) + max_new - 1):
        lg, jc = step(jparams, jnp.asarray([[fed[pos]]], jnp.int32), jc,
                      jnp.int32(pos))
        if pos >= len(prompt) - 1:
            row = np.sort(np.asarray(lg[0, 0]))
            gap = min(gap, float(row[-1] - row[-2]))
            out.append(int(np.argmax(np.asarray(lg[0, 0]))))
            fed.append(out[-1])
    return out, gap


@pytest.mark.parametrize("family", ["moe", "xlstm"])
def test_family_streams_equal_jax_sequential_decode(family, moe_setup,
                                                    xlstm_setup):
    """olmoe-1b-7b and xlstm-125m reduced: the engine's token streams, 4
    requests in 2 slots (so two slots are reused), equal the JAX
    package's ``sequential_decode_step`` from ``init_caches``, request by
    request. The top-2 gaps along those streams (0.095 and up for olmoe,
    0.0022 and up for xLSTM, measured) stand above the two packages'
    logit differences (~1e-5 for olmoe; up to 5.5e-4 for xLSTM, whose
    mLSTM slots amplify rounding, see ``tests/test_torch_xlstm.py``)."""
    setup = {"moe": moe_setup, "xlstm": xlstm_setup}[family]
    _, _, cfg, params = setup
    prompts = [[5, 9, 2], [7], [11, 3], [1, 2, 3, 4]]
    eng = ServingEngine(cfg, params, max_slots=2, cache_len=32,
                        device="cpu")
    uids = [eng.submit(q, max_new_tokens=5) for q in prompts]
    got = eng.run_until_drained()
    for q, u in zip(prompts, uids):
        want, gap = _jax_sequential(setup, q, 5)
        assert got[u] == want and gap > 1e-3, (q, got[u], want, gap)


def test_xlstm_reused_slot_equals_a_fresh_request(xlstm_setup):
    """A reused xLSTM slot starts from ``init_caches`` values (the
    stabiliser ``m`` at -1e30, not 0): the second request's stream in a
    one-slot engine equals a fresh engine's and the JAX package's
    sequential decode from ``init_caches``, and the slot's caches after
    admission equal a fresh engine's."""
    _, _, cfg, params = xlstm_setup
    eng = ServingEngine(cfg, params, max_slots=1, cache_len=32,
                        device="cpu")
    eng.submit([5, 17, 3, 99, 42], max_new_tokens=6)
    eng.run_until_drained()
    second = [7, 7, 12]
    u = eng.submit(second, max_new_tokens=6)
    fresh = ServingEngine(cfg, params, max_slots=1, cache_len=32,
                          device="cpu")
    fu = fresh.submit(second, max_new_tokens=6)
    eng.step()
    fresh.step()                              # both admitted, one step
    for a, b in zip(tree.leaves(eng.caches), tree.leaves(fresh.caches)):
        assert torch.equal(a, b)
    got = eng.run_until_drained()[u]
    assert got == fresh.run_until_drained()[fu]
    assert got == _jax_sequential(xlstm_setup, second, 6)[0]
