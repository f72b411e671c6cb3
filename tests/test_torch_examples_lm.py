"""The port's LM examples against the JAX package's, on the CPU, on the
same weights: the JAX example's init (``jax.random.PRNGKey(0)``) carried
across by ``params_from_numpy``, the example's own batches.

- ``quickstart`` and ``train_e2e --tiny``: the first 3 losses of the
  port example's ``train`` within 1e-4 of the JAX loop's (f32, Adam; the
  JAX loop is the example's few lines restated with ``repro.*``);
- ``continuous_batching``: every stream token for token;
- ``serve_pipeline``: the first 4 decode steps' logits within 1e-4;
- ``count_params`` equal to the JAX package's on ``train_e2e``'s default
  (~100M, shapes only: ``jax.eval_shape`` and the meta device) and
  ``--tiny`` configs.

Each example's config is the JAX example's, field for field."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_examples import load  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.synthetic import lm_batches as jlm_batches  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jmake_debug_mesh  # noqa: E402
from repro.launch.mesh import mesh_context  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.modules import count_params as jcount_params  # noqa: E402
from repro.pipeline.pipeline_step import make_serve_step as jserve  # noqa: E402
from repro.pipeline.pipeline_step import make_train_step as jtrain  # noqa: E402
from repro.pipeline.sharding import param_shardings  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.modules import count_params  # noqa: E402

ATOL = 1e-4
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 host devices (tests/conftest.py)")


def _jax_params(mesh, cfg):
    """The JAX example's init on ``mesh`` (sharded), and as numpy."""
    with mesh_context(mesh):
        params = jax.jit(lambda k: JM.init_params(k, cfg),
                         out_shardings=param_shardings(mesh, cfg))(KEY)
    return params, jax.tree.map(np.asarray, params)


def _jax_losses(cfg, tc, batch, seq, steps, branching=8):
    """The JAX example's training loop, its first ``steps`` losses, and
    the initial params as numpy."""
    mesh = jmake_debug_mesh(data=2, stage=2, tensor=2)
    params, np_params = _jax_params(mesh, cfg)
    with mesh_context(mesh):
        train_step, _ = jtrain(mesh, cfg, tc)
        state = train_step.init_state(params)
        jstep = jax.jit(train_step)
        ds = JSyntheticLM(vocab_size=cfg.vocab_size, branching=branching)
        losses = []
        for x, y in jlm_batches(ds, batch, seq, steps):
            state, m = jstep(state, {"tokens": jnp.asarray(x),
                                     "labels": jnp.asarray(y)})
            losses.append(float(m["loss"]))
    return losses, np_params


def _same_config(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def test_quickstart_losses_match_jax():
    ex = load("quickstart", port=True)
    cfg = jax_config("qwen2-1.5b").reduced(
        pipeline_stages=2, tensor_parallel=2, num_layers=4, vocab_size=256,
        aggregate_every=4, stash_depth=2)
    _same_config(ex.config(), cfg)
    tc = JTrainConfig(learning_rate=0.02, optimizer="adam", microbatches=2,
                      weight_decay=0.0)
    assert dataclasses.asdict(ex.train_config()) == dataclasses.asdict(tc)
    want, np_params = _jax_losses(cfg, tc, batch=8, seq=32, steps=3)
    got = ex.train(ex.config(), M.params_from_numpy(np_params), "cpu",
                   steps=3, log=lambda *a: None)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_train_e2e_tiny_losses_match_jax():
    ex = load("train_e2e", port=True)
    cfg = jax_config("qwen2-1.5b").reduced(
        pipeline_stages=2, tensor_parallel=2, num_layers=4, vocab_size=512)
    _same_config(ex.config(tiny=True), cfg)
    tc = JTrainConfig(learning_rate=3e-4, optimizer="adam", microbatches=2,
                      weight_decay=0.0)
    assert dataclasses.asdict(ex.train_config()) == dataclasses.asdict(tc)
    # --tiny: B=8, S=min(256, 64)
    want, np_params = _jax_losses(cfg, tc, batch=8, seq=64, steps=3,
                                  branching=16)
    got = ex.train(ex.config(tiny=True), M.params_from_numpy(np_params),
                   "cpu", 8, 64, 3, log=lambda *a: None)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _jax_e2e_default():
    """examples/train_e2e.py's default config, restated."""
    return jax_config("qwen2-1.5b").with_overrides(
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=2,
        head_dim=64, d_ff=2048, vocab_size=32_000,
        pipeline_stages=2, tensor_parallel=2, layers_per_stage=0,
        slot_layout=(), dtype="float32",
        aggregate_every=8, stash_depth=2)


@pytest.mark.parametrize("tiny", [False, True])
def test_count_params_matches_jax(tiny):
    ex = load("train_e2e", port=True)
    cfg = ex.config(tiny)
    jcfg = (jax_config("qwen2-1.5b").reduced(
        pipeline_stages=2, tensor_parallel=2, num_layers=4, vocab_size=512)
        if tiny else _jax_e2e_default())
    _same_config(cfg, jcfg)
    want = jcount_params(jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                                        KEY))
    got = count_params(M.init_params(0, cfg, device="meta"))
    assert got == want
    if tiny:        # and on a real init, tensors on the CPU
        assert count_params(M.init_params(0, cfg, device="cpu")) == want


def test_continuous_batching_streams_match_jax():
    ex = load("continuous_batching", port=True)
    cfg = jax_config("qwen2-1.5b").reduced(num_layers=2, vocab_size=128)
    _same_config(ex.config(), cfg)
    params = JM.init_params(KEY, cfg)
    eng = JServingEngine(cfg, params, max_slots=2, cache_len=48)
    uids = [eng.submit(p, max_new_tokens=8) for p in ex.PROMPTS]
    want, steps = {}, 0
    while len(want) < len(uids) and steps < 200:
        for r in eng.step():
            want[r.uid] = r.generated
        steps += 1
    got, got_steps = ex.serve(ex.config(),
                              M.params_from_numpy(
                                  jax.tree.map(np.asarray, params)),
                              "cpu", log=lambda *a: None)
    assert got == want and got_steps == steps
    assert len(got) == 4 and all(len(t) == 8 for t in got.values())


def test_serve_pipeline_logits_match_jax():
    ex = load("serve_pipeline", port=True)
    cfg = jax_config("zamba2-7b").reduced(pipeline_stages=2,
                                          tensor_parallel=1, num_layers=4)
    _same_config(ex.config(), cfg)
    steps = 4
    mesh = jmake_debug_mesh(data=2, stage=2, tensor=2)
    params, np_params = _jax_params(mesh, cfg)
    want = []
    with mesh_context(mesh):
        caches = JM.init_caches(cfg, batch=ex.BATCH,
                                cache_len=ex.CACHE_LEN)
        serve = jax.jit(jserve(mesh, cfg))
        tok = jnp.zeros((ex.BATCH, 1), jnp.int32)
        for pos in range(steps):
            logits, caches = serve(params, tok, caches, jnp.int32(pos))
            want.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
    got = []
    streams, _ = ex.decode(ex.config(), M.params_from_numpy(np_params),
                           torch.device("cpu"), steps=steps, logits_out=got)
    assert len(got) == steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)
    assert [s[:steps] for s in streams] == [
        [int(np.argmax(w[b, -1])) for w in want] for b in range(ex.BATCH)]
