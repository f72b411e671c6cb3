"""The per-rank layout of the port's engine on ranks, on the CPU:
``pipeline/sharding.py`` (``param_shardings``, ``shard_params``,
``gather_params`` and their cache counterparts) against the JAX package's
``NamedSharding`` on the 8-host-device debug mesh of
``tests/conftest.py``, and ``launch/mesh.rank_coords`` against the order
in which ``jax.make_mesh`` lays out devices.

Every architecture runs reduced at stage 2 x tensor 2, with the GQA case
where kv weights stay replicated over tensor (``num_kv_heads <
tensor_parallel``) checked on its own.
"""
import itertools
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_parity import cfgs  # noqa: E402
from repro.launch.mesh import axis_types_kwarg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.pipeline import sharding as jsh  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_local_mesh, rank_coords)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.pipeline import sharding as sh  # noqa: E402

NAMES = ("data", "stage", "tensor")
SHAPE = (2, 2, 2)


def jax_mesh(shape=SHAPE):
    if jax.device_count() < math.prod(shape):
        pytest.skip("needs 8 host devices")
    return jax.make_mesh(shape, NAMES, **axis_types_kwarg(3))


def _cfgs(arch, **kw):
    return cfgs(arch, pipeline_stages=2, tensor_parallel=2, **kw)


def _jax_shapes(jcfg):
    return [tuple(a.shape) for a in jax.tree.leaves(
        jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                       jax.random.PRNGKey(0)))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shard_shapes_match_named_sharding(arch):
    jcfg, cfg = _cfgs(arch)
    mesh = jax_mesh()
    want = [s.shard_shape(shape) for s, shape in zip(
        jax.tree.leaves(jsh.param_shardings(mesh, jcfg)), _jax_shapes(jcfg))]
    ours = tree.leaves(sh.param_shardings(make_debug_mesh(*SHAPE,
                                                          device="cpu"), cfg))
    assert [s.shard_shape(shape) for s, shape in
            zip(ours, _jax_shapes(jcfg))] == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_then_gather_is_the_whole_tree(arch):
    """Every rank's shards have the shard shapes, and put together they are
    the whole tree bit for bit (a rank's shards are copies: writing one
    leaves the whole tree as it was)."""
    _, cfg = _cfgs(arch)
    mesh = make_debug_mesh(*SHAPE, device="cpu")
    p = M.init_params(0, cfg, device="cpu")
    parts = [sh.shard_params(p, mesh, cfg, rank=r) for r in range(8)]
    shardings = tree.leaves(sh.param_shardings(mesh, cfg))
    for part in parts:
        assert [tuple(a.shape) for a in tree.leaves(part)] == [
            s.shard_shape(a.shape) for s, a in zip(shardings,
                                                   tree.leaves(p))]
    before = [a.clone() for a in tree.leaves(p)]
    tree.leaves(parts[0])[0].add_(1.0)
    parts[0] = sh.shard_params(p, mesh, cfg, rank=0)
    back = sh.gather_params(parts, mesh, cfg)
    for a, b, c in zip(tree.leaves(back), tree.leaves(p), before):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_replicated_kv_weights_and_caches():
    """qwen2-1.5b with one kv head at tensor 2: wk, wv and the kv caches
    stay whole on every tensor shard (``sharding.py:51-66``), as
    ``NamedSharding`` says; caches split over stage and data."""
    jcfg, cfg = _cfgs("qwen2-1.5b", num_kv_heads=1)
    mesh = jax_mesh()
    lmesh = make_debug_mesh(*SHAPE, device="cpu")
    ours = sh.param_shardings(lmesh, cfg)["blocks"][0]["attn"]
    wk = ours["wk"]["w"]
    assert wk.spec == sh.P("stage", None, None)
    assert wk.replicated_over() == ("data", "tensor")
    jc = JM.init_caches(jcfg, batch=4, cache_len=8)
    c = M.init_caches(cfg, batch=4, cache_len=8, device="cpu")
    jspecs = [jsh.cache_specs(t, jcfg, jsh.data_axes(mesh))
              for t in jcfg.slot_layout]
    want = [jax.sharding.NamedSharding(mesh, s).shard_shape(a.shape)
            for s, a in zip(jax.tree.leaves(
                jspecs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec)),
                jax.tree.leaves(jc))]
    ours = [s.shard_shape(a.shape) for s, a in zip(
        tree.leaves(sh.cache_shardings(lmesh, cfg)), tree.leaves(c))]
    assert ours == want
    parts = [sh.shard_caches(c, lmesh, cfg, rank=r) for r in range(8)]
    back = sh.gather_caches(parts, lmesh, cfg)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(back), tree.leaves(c)))


def test_rank_coords_follow_jax_device_order():
    """Rank r sits where ``jax.make_mesh`` puts device r, for the debug
    mesh and a four-axis train-style mesh."""
    for shape, names in ((SHAPE, NAMES),
                         ((2, 2, 2, 1), ("data", "extra", "stage",
                                         "tensor"))):
        mesh = jax.make_mesh(shape, names, **axis_types_kwarg(len(names)))
        for r in range(math.prod(shape)):
            c = rank_coords(names, shape, r)
            assert mesh.devices[tuple(c[a] for a in names)].id == r


def test_sharding_slices_tile_each_leaf():
    """The ranks' slices of a leaf split over (stage, tensor) on one dim
    tile it in the JAX package's row-major axis order, each slice held by
    the two data ranks."""
    s = sh.Sharding(NAMES, SHAPE, sh.P(("stage", "tensor"), None))
    seen = {}
    for r in range(8):
        c = rank_coords(NAMES, SHAPE, r)
        sl = s.slices((16, 3), c)[0]
        assert sl.start == (c["stage"] * 2 + c["tensor"]) * 4
        seen.setdefault(sl.start, set()).add(c["data"])
    assert sorted(seen) == [0, 4, 8, 12]
    assert all(v == {0, 1} for v in seen.values())
    assert s.replicated_over() == ("data",)
    with pytest.raises(ValueError, match="split"):
        s.shard_shape((6, 3))


def test_folded_meshes_without_a_process_group():
    """With no process group up, the debug and train meshes are today's
    folded ``LocalMesh``."""
    assert type(make_debug_mesh(1, 2, 1, device="cpu")).__name__ == \
        "LocalMesh"
    m = make_local_mesh((2, 2), ("data", "stage"), device="cpu")
    assert not hasattr(m, "rank")
    assert list(itertools.islice(rank_coords(("a", "b"), (2, 3), 5).values(),
                                 2)) == [1, 2]
