"""Helpers shared by the port's parity tests of the transformer stacks
(``tests/test_torch_{transformer,moe,xlstm,whisper,serving}.py``): numpy
weights in the JAX package's parameter layout, carried into both
packages, and the comparison."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import model as M

KEY = jax.random.PRNGKey(0)
# leaves whose JAX init values are kept: Mamba2's decays and step sizes,
# xLSTM's forget-gate biases (random ones leave the ranges the models run in)
OWN_LEAVES = ("A_log", "dt_bias", "'D'", "conv_b", "f_bias")


def cfgs(arch, **kw):
    """(the JAX package's reduced config, the port's), with ``kw``."""
    return jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def draw(init, seed=0, table_scale=None):
    """Numpy weights of the shapes ``init`` (a JAX init taking a key)
    makes: norm scales near 1, biases near 0, fan-in-scaled matrices; the
    ``OWN_LEAVES`` keep the JAX init's values. ``table_scale``: the
    embedding table's scale (default fan-in)."""
    rng = np.random.default_rng(seed)
    own = init(KEY)

    def one(path, s, v):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in OWN_LEAVES):
            return np.asarray(v)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        if "table" in name and table_scale is not None:
            scale = table_scale
        else:
            scale = 0.1 if len(s.shape) == 1 or "'b'" in name else \
                s.shape[-2] ** -0.5
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, jax.eval_shape(init, KEY),
                                            own)


def both(np_tree):
    """(the JAX package's params, the port's) from one numpy tree."""
    return jax.tree.map(jnp.asarray, np_tree), M.params_from_numpy(np_tree)


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
