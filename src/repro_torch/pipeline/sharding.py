"""Partition specs of the stacked pipeline parameters and caches.

The port of ``repro.pipeline.sharding``. Mesh axes: ("pod"?, "data",
"extra"?, "stage", "tensor"). A spec here is plain data, a tuple ``P`` of
the same entries as the JAX package's ``PartitionSpec``: per dimension of
a leaf, the mesh axis (or tuple of axes) it is split over, or None. The
one-device engine reads none of them (it folds every axis, see
``pipeline_step.py``); they record the layout a multi-device backend
shards by, and mirror each block type's parameter tree exactly (tested
against the port's init trees). The leading axis of every stacked leaf is
"stage"; tensor-parallel dims follow Megatron's conventions (column for
up/QKV/head-emitting weights, row for down/output projections); GQA kv
weights are replicated over tensor when num_kv_heads < tensor_parallel.

``param_shardings`` (``NamedSharding`` over a device mesh) has no meaning
on one device; it waits for the multi-GPU backend of ROADMAP Queue 1
item 12.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

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
