"""The port's re-packing of stacked parameters (``repro_torch.pipeline.
repack``) and its partition specs (``repro_torch.pipeline.sharding``)
against the JAX package's, on the CPU.

Plans are integer tables and a re-pack only moves values, so both are
held exactly: plans equal, re-packed leaves bit for bit. The model's
function after a re-pack is held as the JAX package's own test holds it
(2e-5, ``tests/test_repack.py:58``), on the port's sequential forward.
Specs are plain tuples in the port; the JAX package's ``PartitionSpec``
is a tuple too, so they are compared as tuples.
"""
import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import both, cfgs, draw  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.pipeline import repack as jrp  # noqa: E402
from repro.pipeline import sharding as jsh  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline import repack as rp  # noqa: E402
from repro_torch.pipeline import sharding as sh  # noqa: E402


def _random_assignment(rng, L, S, Lps):
    """Contiguous split of L layers into S parts each in [0, Lps]."""
    while True:
        cuts = sorted(rng.choice(range(L + 1), size=S - 1, replace=True))
        counts = np.diff([0] + list(cuts) + [L])
        if counts.max() <= Lps:
            return [int(c) for c in counts]


SMALL = dict(pipeline_stages=4, num_layers=8, layers_per_stage=3,
             tensor_parallel=1)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000))
def test_plans_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jcfg, cfg = cfgs("qwen2-1.5b", **SMALL)
    a_old = _random_assignment(rng, 8, 4, 3)
    a_new = _random_assignment(rng, 8, 4, 3)
    want = jrp.make_repack_plan(jcfg, a_old, a_new)
    got = rp.make_repack_plan(cfg, a_old, a_new)
    assert np.array_equal(got.src, want.src)
    assert got.moved_layers == want.moved_layers and got.stages == 4
    assert rp.redistribution_bytes(cfg, got, 1e6) == \
        jrp.redistribution_bytes(jcfg, want, 1e6)
    for layer in range(8):
        assert rp.slot_of(a_new, layer) == jrp.slot_of(a_new, layer)
    lost = int(rng.integers(0, 4))
    assert rp.recover_assignment_after_stage_loss(cfg, a_old, lost) == \
        jrp.recover_assignment_after_stage_loss(jcfg, a_old, lost)


@pytest.fixture(scope="module")
def stacked():
    jcfg, cfg = cfgs("qwen2-1.5b", **SMALL)
    np_p = draw(lambda k: JM.init_params(k, jcfg))
    jp, p = both(np_p)
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("a_new", [[3, 3, 1, 1], [0, 3, 3, 2], [1, 1, 3, 3]])
def test_repack_blocks_equal_jax_bit_for_bit(stacked, a_new):
    jcfg, cfg, jp, p = stacked
    a_old = M.default_assignment(cfg)
    before = [t.clone() for t in tree.leaves(p["blocks"])]
    want = jrp.repack_blocks(jp["blocks"], jrp.make_repack_plan(
        jcfg, a_old, a_new), jcfg)
    got = rp.repack_blocks(p["blocks"], rp.make_repack_plan(
        cfg, a_old, a_new), cfg)
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(p["blocks"]), before))


def _logits(p, cfg, toks, assignment):
    return M.sequential_lm_forward(p, cfg, toks, assignment=assignment)[0]


def test_repack_preserves_model_function(stacked):
    _, cfg, _, p = stacked
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    a_old = M.default_assignment(cfg)                    # [2, 2, 2, 2]
    a_new = [3, 3, 1, 1]
    plan = rp.make_repack_plan(cfg, a_old, a_new)
    p2 = dict(p, blocks=rp.repack_blocks(p["blocks"], plan, cfg))
    np.testing.assert_allclose(_logits(p2, cfg, toks, a_new).numpy(),
                               _logits(p, cfg, toks, a_old).numpy(),
                               atol=2e-5)
    assert plan.moved_layers > 0


def test_repack_after_stage_loss_preserves_model():
    """Stage 2 dies: its layers re-pack onto survivors; the logits stay
    (tests/test_repack.py:63-82)."""
    jcfg, cfg = cfgs("llama3-8b", **SMALL)
    _, p = both(draw(lambda k: JM.init_params(k, jcfg)))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)))
    a_old = M.default_assignment(cfg)
    a_new = rp.recover_assignment_after_stage_loss(cfg, a_old, lost_stage=2)
    assert a_new == jrp.recover_assignment_after_stage_loss(jcfg, a_old, 2)
    assert a_new[2] == 0 and sum(a_new) == 8
    plan = rp.make_repack_plan(cfg, a_old, a_new)
    p2 = dict(p, blocks=rp.repack_blocks(p["blocks"], plan, cfg))
    np.testing.assert_allclose(_logits(p2, cfg, toks, a_new).numpy(),
                               _logits(p, cfg, toks, a_old).numpy(),
                               atol=2e-5)
    full = cfgs("llama3-8b", **dict(SMALL, layers_per_stage=2))[1]
    with pytest.raises(ValueError, match="slot budget"):
        rp.recover_assignment_after_stage_loss(full, [2, 2, 2, 2], 1)


@pytest.mark.parametrize("caps", [[1.0, 1.0, 1.0, 8.0], [4.0, 1.0, 1.0, 1.0],
                                  [1.0, 2.0, 3.0, 4.0]])
def test_repartition_from_profile_equals_jax(caps):
    jcfg, cfg = cfgs("qwen2-1.5b", **SMALL)
    args = (np.ones(8), np.ones(8) * 1e3, np.asarray(caps),
            np.asarray([1e9] * 3))
    got = rp.repartition_from_profile(cfg, *args)
    assert got == jrp.repartition_from_profile(jcfg, *args)
    assert sum(got) == 8 and max(got) <= 3


def test_heterogeneous_layout_rejected():
    _, cfg = cfgs("zamba2-7b", pipeline_stages=2, num_layers=4)
    assert not rp.uniform_layout(cfg)
    with pytest.raises(ValueError, match="heterogeneous"):
        rp.make_repack_plan(cfg, [2, 2], [3, 1])
    _, cfg = cfgs("qwen2-1.5b", **SMALL)
    with pytest.raises(ValueError):
        rp.make_repack_plan(cfg, [2, 2, 2, 2], [4, 2, 1, 1])


def _as_tuples(spec_tree, is_jax):
    if is_jax:
        return [tuple(l) for l in jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jsh.P))]
    return [tuple(l) for l in tree.leaves(spec_tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax_and_mirror_the_init_trees(arch):
    """model_param_specs: the JAX package's entries, and one spec of the
    leaf's rank for every leaf of the port's init tree; cache_specs
    likewise over init_caches. Run at tensor_parallel 1 and 2 (GQA kv
    weights replicated when num_kv_heads < tensor_parallel)."""
    for tp in (1, 2):
        jcfg, cfg = cfgs(arch, pipeline_stages=2, tensor_parallel=tp)
        spec = sh.model_param_specs(cfg)
        assert _as_tuples(spec, False) == _as_tuples(
            jsh.model_param_specs(jcfg), True)
        p = M.init_params(0, cfg, device="cpu")
        leaves, paths = tree.flatten(p)
        specs, spaths = tree.flatten(spec)
        assert spaths == paths
        assert all(isinstance(s, sh.P) and len(s) == l.ndim
                   for s, l in zip(specs, leaves))
        layout = (cfg.decoder_slot_layout if cfg.family == "audio"
                  else cfg.slot_layout)
        for batch_axes in (("data",), None):
            for t in layout:
                assert _as_tuples(sh.cache_specs(t, cfg, batch_axes),
                                  False) == _as_tuples(
                    jsh.cache_specs(t, jcfg, batch_axes), True)
        caches = M.init_caches(cfg, batch=2, cache_len=4, layout=layout,
                               device="cpu")
        for t, c in zip(layout, caches):
            cl, cp = tree.flatten(c)
            sl, sp = tree.flatten(sh.cache_specs(t, cfg, ("data",)))
            assert sp == cp
            assert all(len(s) == l.ndim for s, l in zip(sl, cl))


def test_data_axes():
    from repro_torch.launch.mesh import make_local_mesh
    for names in (("data", "stage", "tensor"),
                  ("pod", "data", "extra", "stage", "tensor")):
        mesh = make_local_mesh((1,) * len(names), names, device="cpu")
        jmesh = jax.make_mesh((1,) * len(names), names)
        assert sh.data_axes(mesh) == jsh.data_axes(jmesh)
