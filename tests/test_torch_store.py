"""The port's checkpoint store (``repro_torch.checkpoint.store``) against the
JAX package's, on the CPU: the same leaves in the same order with the same
raw bytes, so a checkpoint written by either package restores in the
other bit for bit; retention and ``restore_latest``."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (CheckpointStore, restore_pytree,  # noqa: E402,E501
                                    save_pytree)


def _np_tree():
    rng = np.random.default_rng(0)
    return {
        "blocks": [{"w": rng.standard_normal((2, 3, 4)).astype(np.float32),
                    "b": rng.standard_normal((2, 4)).astype(np.float32)}
                   for _ in range(2)],
        "embed": {"table": rng.standard_normal((5, 3)).astype(np.float32)},
        "step": np.asarray(7, np.int32),
        "half": rng.standard_normal((3, 2)).astype(ml_dtypes.bfloat16),
        "empty": np.zeros((0, 3), np.float32),
    }


def _torch_tree(np_tree):
    def one(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return tree.map(one, np_tree)


def _bits(t):
    if torch.is_tensor(t):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _jax_tree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def test_bin_files_are_byte_identical(tmp_path):
    np_tree = _np_tree()
    jstore.save_pytree(str(tmp_path / "jax"), _jax_tree(np_tree))
    save_pytree(str(tmp_path / "port"), _torch_tree(np_tree))
    jbin = (tmp_path / "jax.bin").read_bytes()
    assert jbin == (tmp_path / "port.bin").read_bytes()
    import json
    jm = json.loads((tmp_path / "jax.json").read_text())
    pm = json.loads((tmp_path / "port.json").read_text())
    assert jm["leaves"] == pm["leaves"] and jm["meta"] == pm["meta"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_tree_restores_in_the_other_package_bit_for_bit(tmp_path, writer):
    np_tree = dict(_np_tree())
    del np_tree["empty"]      # the JAX reader reads 1 item for a 0-size leaf
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jstore.save_pytree(path, _jax_tree(np_tree), {"step": 3})
        got = restore_pytree(path, _torch_tree(np_tree))
        want = np_tree
    else:
        save_pytree(path, _torch_tree(np_tree), {"step": 3})
        got = jstore.restore_pytree(path, _jax_tree(np_tree))
        want = np_tree
    gl = jax.tree.leaves(got) if writer == "port" else tree.leaves(got)
    for a, b in zip(gl, jax.tree.leaves(want)):
        assert str(np.asarray(b).dtype) in str(a.dtype)
        assert np.array_equal(_bits(a), _bits(b))


def test_restore_checks_structure_and_shapes_and_keeps_the_device(tmp_path):
    t = _torch_tree(_np_tree())
    path = str(tmp_path / "c")
    save_pytree(path, t)
    got = restore_pytree(path, t)
    for a, b in zip(tree.leaves(got), tree.leaves(t)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="structure"):
        restore_pytree(path, {"a": t["embed"]["table"]})
    bad = dict(t, step=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(path, bad)


def test_store_retention_and_restore_latest(tmp_path):
    cs = CheckpointStore(str(tmp_path), keep=2)
    like = {"w": torch.zeros(3), "n": torch.zeros((), dtype=torch.int32)}
    assert cs.restore_latest(like) == (None, -1)
    for step in (1, 2, 3):
        cs.save(step, {"w": torch.full((3,), float(step)),
                       "n": torch.tensor(step, dtype=torch.int32)},
                meta={"note": "x"})
    assert cs.steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000002.bin", "ckpt_00000002.json",
        "ckpt_00000003.bin", "ckpt_00000003.json"]
    got, step = cs.restore_latest(like)
    assert step == 3 and torch.equal(got["w"], torch.full((3,), 3.0))
    assert int(got["n"]) == 3
    jcs = jstore.CheckpointStore(str(tmp_path), keep=2)
    jgot, jstep = jcs.restore_latest({"w": np.zeros(3, np.float32),
                                      "n": np.zeros((), np.int32)})
    assert jstep == 3 and np.array_equal(np.asarray(jgot["w"]), [3, 3, 3])
