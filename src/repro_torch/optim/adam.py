"""AdamW (for the LM examples; the paper itself uses SGD), as a leafwise
update of dict trees: the port of ``repro.optim.adam``. The moments are
f32 whatever the params' dtype; ``count`` is a 0-d int32 tensor. ``lr``
may be a float or a 0-d tensor (a schedule's value)."""
from __future__ import annotations

import torch

from repro_torch import tree


def adam_init(params):
    z = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    leaves = tree.leaves(params)
    count = torch.zeros((), dtype=torch.int32,
                        device=leaves[0].device if leaves else "cpu")
    return {"m": z, "v": tree.map(torch.clone, z), "count": count}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.0, momentum=None):
    """-> (new params, new state); builds new tensors, writes none.
    ``momentum`` is accepted and ignored, as in the JAX package (the
    optimizers share one call signature)."""
    c = state["count"] + 1
    cf = c.to(torch.float32)
    bc1, bc2 = 1 - b1 ** cf, 1 - b2 ** cf

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mh = m_new / bc1
        vh = v_new / bc2
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m_new, v_new

    leaves_p, paths = tree.flatten(params)
    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves_p, tree.leaves(grads), tree.leaves(state["m"]),
        tree.leaves(state["v"]))]
    pick = [tree.unflatten(paths, [o[i] for o in outs]) for i in range(3)]
    return pick[0], {"m": pick[1], "v": pick[2], "count": c}
