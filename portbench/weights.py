"""The benchmark's weights, drawn on the device from the seed.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference. They are laid out as the program's
parameter tree (``repro_torch.models.model.init_params``): block leaves
stacked over a leading stage axis, one dict a slot of a stage. That tree
is the format both sides read, as a checkpoint would be; the harness
holds it to the program's own layout (on the meta device) before a run.

Every weight matrix is drawn from one ``torch.Generator`` on the device in
a single call into one flat buffer; the leaves are views of it, scaled in
place: the embedding by 0.02, every product's weight by 1 / sqrt(fan in).
Norm scales are ones and biases zeros, as in the program's own init.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# (name, in-dimension key, out-dimension key) of the attention projections
_ATTN = (("wq", "d", "q"), ("wk", "d", "kv"), ("wv", "d", "kv"),
         ("wo", "q", "d"))


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run's ``--seed``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, tag])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def layout(c) -> dict:
    """The tree's spec: each leaf a tuple (shape, init), init one of
    ("draw", scale), "ones", "zeros"."""
    d, H, K, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], \
        c["head_dim"]
    S, L, V = c["pipeline_stages"], c["num_layers"], c["vocab_size"]
    if L % S:
        raise ValueError(f"{L} layers do not fill {S} stages evenly")
    Vp = -(-V // 128) * 128
    dims = {"d": d, "q": H * hd, "kv": K * hd}

    def draw(*shape):
        return (shape, ("draw", 1.0 / math.sqrt(shape[-2])))

    attn = {}
    for name, i, o in _ATTN:
        attn[name] = {"w": draw(S, dims[i], dims[o])}
        if c.get("qkv_bias") and name != "wo":
            attn[name]["b"] = ((S, dims[o]), "zeros")
    slot = {"ln1": {"scale": ((S, d), "ones")}, "attn": attn,
            "ln2": {"scale": ((S, d), "ones")}}
    if c.get("num_experts"):
        E, ff = c["num_experts"], c["d_ff"]
        slot["moe"] = {"router": {"w": draw(S, d, E)},
                       "w1": draw(S, E, d, ff), "w3": draw(S, E, d, ff),
                       "w2": draw(S, E, ff, d)}
    else:
        ff = c["d_ff"]
        slot["mlp"] = {"w_up": {"w": draw(S, d, ff)},
                       "w_down": {"w": draw(S, ff, d)},
                       "w_gate": {"w": draw(S, d, ff)}}
    return {"embed": {"table": ((Vp, d), ("draw", 0.02))},
            "blocks": [slot] * (L // S),
            "final_norm": {"scale": ((d,), "ones")},
            "head": {"w": draw(d, Vp)}}


def flatten(tree, prefix=()):
    """[(path, leaf)] of a tree of dicts and lists: dict keys sorted,
    list items in order (the program's order, ``repro_torch.tree``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k],
                                                           prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def unflatten(items):
    """The inverse of ``flatten``."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for k, nxt in zip(path[:-1], path[1:]):
            default = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = default
                node = node[k]
            else:
                node = node.setdefault(k, default)
        last = path[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = leaf
    return root


def is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _spec_items(spec, prefix=()):
    if is_spec(spec):
        return [(prefix, spec)]
    if isinstance(spec, dict):
        return [kv for k in sorted(spec)
                for kv in _spec_items(spec[k], prefix + (k,))]
    return [kv for i, v in enumerate(spec)
            for kv in _spec_items(v, prefix + (i,))]


def draw(c, seed: int, device) -> dict:
    """The weights of configuration ``c`` for ``--seed``, f32 on
    ``device``: the same seed gives the same tensors on a device type."""
    items = _spec_items(layout(c))
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 0))
    n = sum(math.prod(shape) for _, (shape, init) in items
            if isinstance(init, tuple))
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, at = [], 0
    for path, (shape, init) in items:
        if isinstance(init, tuple):
            size = math.prod(shape)
            leaf = flat[at:at + size].view(shape).mul_(init[1])
            at += size
        elif init == "ones":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            leaf = torch.zeros(shape, dtype=torch.float32, device=device)
        out.append((path, leaf))
    return unflatten(out)
