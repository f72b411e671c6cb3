"""SGD + momentum + weight decay — the paper's optimizer (§IV-B: momentum
0.9, weight decay 4e-5) as a leafwise update of dict trees. The fused
kernel (``kernels/fused_sgd``) implements the same update for flat
parameter buffers; ``StageExecutor(compiled=False)`` runs this one.
"""
from __future__ import annotations

import torch

from repro_torch import tree


def sgd_init(params):
    return {"momentum": tree.map(torch.zeros_like, params)}


def sgd_update(params, grads, state, *, lr, momentum=0.9, weight_decay=4e-5):
    """-> (new params, new state); builds new tensors, writes none."""
    def upd(p, g, m):
        g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
        m_new = momentum * m.to(torch.float32) + g
        p_new = p.to(torch.float32) - lr * m_new
        return p_new.to(p.dtype), m_new.to(m.dtype)

    leaves_p, paths = tree.flatten(params)
    outs = [upd(p, g, m) for p, g, m in zip(
        leaves_p, tree.leaves(grads), tree.leaves(state["momentum"]))]
    return (tree.unflatten(paths, [o[0] for o in outs]),
            {"momentum": tree.unflatten(paths, [o[1] for o in outs])})
