"""Partition specs of the stacked pipeline parameters and caches.

The port of ``repro.pipeline.sharding``. Mesh axes: ("pod"?, "data",
"extra"?, "stage", "tensor"). A spec here is plain data, a tuple ``P`` of
the same entries as the JAX package's ``PartitionSpec``: per dimension of
a leaf, the mesh axis (or tuple of axes) it is split over, or None. The
specs mirror each block type's parameter tree exactly (tested against the
port's init trees). The leading axis of every stacked leaf is "stage";
tensor-parallel dims follow Megatron's conventions (column for
up/QKV/head-emitting weights, row for down/output projections); GQA kv
weights are replicated over tensor when num_kv_heads < tensor_parallel.

The folded engine reads none of them (it runs whole weights, see
``pipeline_step.py``). On ranks (``launch/mesh.RankMesh``) each rank holds
its shard of every leaf: ``param_shardings`` gives a ``Sharding`` per
leaf (what ``NamedSharding`` says of it: the shard's shape, the slice a
rank holds, the axes it is replicated over), ``shard_params`` /
``shard_caches`` cut a rank's shards out of a whole tree and
``gather_params`` / ``gather_caches`` put the ranks' shards together
again.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import rank_coords

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_STAGE = "stage"
AXIS_TENSOR = "tensor"
AXIS_EXTRA = "extra"
S, T = AXIS_STAGE, AXIS_TENSOR


class P(tuple):
    """A partition spec: ``P("stage", None, "tensor")``. Entries are
    normalised as ``PartitionSpec`` normalises them: a one-axis tuple
    becomes its axis, an empty one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None)
            if isinstance(e, tuple) else e for e in entries))


def data_axes(mesh) -> tuple:
    """The mesh axes the batch is split over: pod, data, extra."""
    return tuple(a for a in (AXIS_POD, AXIS_DATA, AXIS_EXTRA)
                 if a in mesh.axis_names)


def _dense_w(col: bool, bias: bool):
    d = {"w": P(S, None, T) if col else P(S, T, None)}
    if bias:
        d["b"] = P(S, T) if col else P(S, None)
    return d


def _norm(bias=False):
    d = {"scale": P(S, None)}
    if bias:
        d["bias"] = P(S, None)
    return d


def _attn(cfg: ModelConfig):
    kv_shard = cfg.num_kv_heads >= cfg.tensor_parallel
    kv = (lambda: {"w": P(S, None, T) if kv_shard else P(S, None, None),
                   **({"b": P(S, T) if kv_shard else P(S, None)}
                      if cfg.qkv_bias else {})})
    q = {"w": P(S, None, T), **({"b": P(S, T)} if cfg.qkv_bias else {})}
    return {"wq": q, "wk": kv(), "wv": kv(), "wo": {"w": P(S, T, None)}}


def _xattn(cfg: ModelConfig):
    kv_shard = cfg.num_kv_heads >= cfg.tensor_parallel
    kv = {"w": P(S, None, T) if kv_shard else P(S, None, None)}
    return {"wq": {"w": P(S, None, T)}, "wk": dict(kv), "wv": dict(kv),
            "wo": {"w": P(S, T, None)}}


def _mlp(gated=True):
    d = {"w_up": _dense_w(True, False), "w_down": _dense_w(False, False)}
    if gated:
        d["w_gate"] = _dense_w(True, False)
    return d


def _mamba():
    # tp unsupported inside the mamba mixer (tp=1 archs): stage-only
    return {"mixer": {
        "in_proj": {"w": P(S, None, None)},
        "conv_w": P(S, None, None), "conv_b": P(S, None),
        "A_log": P(S, None), "D": P(S, None), "dt_bias": P(S, None),
        "norm": {"scale": P(S, None)},
        "out_proj": {"w": P(S, None, None)},
    }, "ln": _norm()}


def block_specs(block_type: str, cfg: ModelConfig):
    """Spec tree mirroring BLOCKS[block_type].init(...) stacked over stage."""
    if block_type == "dense":
        return {"ln1": _norm(), "attn": _attn(cfg), "ln2": _norm(),
                "mlp": _mlp(True)}
    if block_type == "moe":
        return {"ln1": _norm(), "attn": _attn(cfg), "ln2": _norm(),
                "moe": {"router": {"w": P(S, None, None)},
                        "w1": P(S, T, None, None), "w3": P(S, T, None, None),
                        "w2": P(S, T, None, None)}}
    if block_type == "mamba":
        return _mamba()
    if block_type == "hybrid":
        return {"mamba": _mamba(), "ln_a": _norm(), "attn": _attn(cfg),
                "ln_m": _norm(), "mlp": _mlp(True)}
    if block_type == "mlstm":
        return {"ln": _norm(), "mixer": {
            "up_x": {"w": P(S, None, T)}, "up_z": {"w": P(S, None, T)},
            "conv_w": P(S, None, T), "conv_b": P(S, T),
            "wq": P(S, None, T, None), "wk": P(S, None, T, None),
            "wv": P(S, None, T, None), "wgate": P(S, None, T, None),
            "f_bias": P(S, T), "gn": {"scale": P(S, T, None)},
            "down": P(S, T, None, None)}}
    if block_type == "slstm":
        return {"ln": _norm(), "mixer": {
            "w": P(S, None, T, None), "b": P(S, T, None),
            "r": P(S, T, None, None), "f_bias": P(S, T, None),
            "gn": {"scale": P(S, T, None)},
            "up_u": {"w": P(S, None, T)}, "up_g": {"w": P(S, None, T)},
            "down": {"w": P(S, T, None)}}}
    if block_type == "enc":
        return {"ln1": _norm(True), "attn": _attn(cfg), "ln2": _norm(True),
                "mlp": _mlp(False)}
    if block_type == "dec":
        return {"ln1": _norm(True), "attn": _attn(cfg),
                "ln_x": _norm(True), "xattn": _xattn(cfg),
                "ln2": _norm(True), "mlp": _mlp(False)}
    raise KeyError(block_type)


def cache_specs(block_type: str, cfg: ModelConfig, batch_axes):
    """Spec tree mirroring BLOCKS[t].init_cache, stage-stacked. Leading axes
    of every leaf: [stage, batch, ...]. ``batch_axes``: mesh axes tuple the
    batch dim is sharded over, or None (replicated)."""
    B = batch_axes
    kv_shard = cfg.num_kv_heads >= cfg.tensor_parallel
    attn = {"k": P(S, B, None, T if kv_shard else None, None),
            "v": P(S, B, None, T if kv_shard else None, None)}
    if block_type in ("dense", "moe", "enc", "dec"):
        return {"attn": attn}
    mamba = {"conv": P(S, B, None, None), "ssm": P(S, B, None, None, None)}
    if block_type == "mamba":
        return {"mamba": mamba}
    if block_type == "hybrid":
        return {"mamba": mamba, "attn": attn}
    if block_type == "mlstm":
        return {"mlstm": {"C": P(S, B, T, None, None), "n": P(S, B, T, None),
                          "m": P(S, B, T), "conv": P(S, B, None, T)}}
    if block_type == "slstm":
        v = P(S, B, T, None)
        return {"slstm": {"c": v, "n": v, "h": v, "m": v}}
    raise KeyError(block_type)


def model_param_specs(cfg: ModelConfig):
    """Specs for the full init_params tree (embed/head sharded over the
    combined model axis; blocks stage-stacked)."""
    specs = {
        "embed": {"table": P((S, T), None)},
        "blocks": [block_specs(t, cfg) for t in cfg.slot_layout],
        "final_norm": _final_norm_spec(cfg),
        "head": {"w": P(None, (S, T))},
    }
    if cfg.family == "audio":
        specs["dec_blocks"] = [block_specs(t, cfg)
                               for t in cfg.decoder_slot_layout]
    return specs


def _final_norm_spec(cfg):
    d = {"scale": P(None)}
    if cfg.family == "audio":
        d["bias"] = P(None)
    return d


# ------------------------------ shardings --------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout over a mesh (``NamedSharding(mesh, spec)``): dim i
    is split over the axes of ``spec[i]``, in their row-major order."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    spec: P

    def _split(self, dim: int) -> tuple[str, ...]:
        return _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()

    def _ways(self, axes) -> int:
        sizes = dict(zip(self.axis_names, self.axis_sizes))
        return math.prod(sizes[a] for a in axes)

    def shard_shape(self, shape) -> tuple[int, ...]:
        out = []
        for i, n in enumerate(shape):
            k = self._ways(self._split(i))
            if n % k:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"{k} ways ({self.spec})")
            out.append(n // k)
        return tuple(out)

    def slices(self, shape, coords: dict) -> tuple[slice, ...]:
        """The slice of a whole leaf of ``shape`` that the rank at
        ``coords`` holds."""
        sizes = dict(zip(self.axis_names, self.axis_sizes))
        local = self.shard_shape(shape)
        out = []
        for i, n in enumerate(local):
            idx = 0
            for a in self._split(i):
                idx = idx * sizes[a] + coords[a]
            out.append(slice(idx * n, (idx + 1) * n))
        return tuple(out)

    def replicated_over(self) -> tuple[str, ...]:
        """The mesh axes no dim is split over: the ranks along them hold
        the same shard (and sum its gradient)."""
        named = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(a for a in self.axis_names if a not in named)


def _shardings(mesh, specs):
    names = tuple(mesh.axis_names)
    sizes = tuple(mesh.shape[a] for a in names)
    leaves, paths = tree.flatten(specs)
    return tree.unflatten(paths, [Sharding(names, sizes, sp)
                                  for sp in leaves])


def param_shardings(mesh, cfg: ModelConfig):
    """A ``Sharding`` per leaf of ``init_params``' tree on ``mesh`` (a
    ``LocalMesh`` or a ``RankMesh``: only its axes count)."""
    return _shardings(mesh, model_param_specs(cfg))


def cache_shardings(mesh, cfg: ModelConfig, layout=None,
                    data_sharded: bool = True):
    """A ``Sharding`` per leaf of ``init_caches``' tree on ``mesh``."""
    batch = data_axes(mesh) if data_sharded else None
    return _shardings(mesh, [cache_specs(t, cfg, batch)
                             for t in (layout or cfg.slot_layout)])


def _coords(mesh, rank):
    if rank is None:
        return mesh.coords
    return rank_coords(tuple(mesh.axis_names),
                       tuple(mesh.shape[a] for a in mesh.axis_names), rank)


def shard_tree(whole, shardings, mesh, rank=None):
    """The shards of ``whole`` that ``rank`` (default: the ``RankMesh``'s
    own) holds: new contiguous tensors, on the leaves' device."""
    coords = _coords(mesh, rank)
    return tree.map(lambda a, sh: a[sh.slices(a.shape, coords)].clone(),
                    whole, shardings)


def gather_tree(parts, shardings, mesh):
    """The whole tree from every rank's shards (``parts[r]``: global rank
    r's tree of shards, on one device)."""
    world = math.prod(mesh.shape.values())
    if len(parts) != world:
        raise ValueError(f"{len(parts)} shard trees for {world} ranks")
    sh_leaves, paths = tree.flatten(shardings)
    by_rank = [tree.leaves(p) for p in parts]
    out = []
    for i, sh in enumerate(sh_leaves):
        first = by_rank[0][i]
        mult = [sh._ways(sh._split(d)) for d in range(first.ndim)]
        whole = torch.empty([n * k for n, k in zip(first.shape, mult)],
                            dtype=first.dtype, device=first.device)
        for r in range(world):
            whole[sh.slices(whole.shape, _coords(mesh, r))] = \
                by_rank[r][i].to(whole.device)
        out.append(whole)
    return tree.unflatten(paths, out)


def shard_params(params, mesh, cfg: ModelConfig, rank=None):
    """``rank``'s shards of a whole ``init_params`` tree (made by the
    port, or carried across from the JAX package's weights)."""
    return shard_tree(params, param_shardings(mesh, cfg), mesh, rank)


def gather_params(parts, mesh, cfg: ModelConfig):
    """The inverse of ``shard_params``: ``parts[r]`` is rank r's shards."""
    return gather_tree(parts, param_shardings(mesh, cfg), mesh)


def shard_caches(caches, mesh, cfg: ModelConfig, layout=None,
                 data_sharded: bool = True, rank=None):
    """``rank``'s shards of whole ``init_caches`` caches: its stage, its
    batch rows and its kv heads."""
    return shard_tree(caches, cache_shardings(mesh, cfg, layout,
                                              data_sharded), mesh, rank)


def gather_caches(parts, mesh, cfg: ModelConfig, layout=None,
                  data_sharded: bool = True):
    return gather_tree(parts, cache_shardings(mesh, cfg, layout,
                                              data_sharded), mesh)
