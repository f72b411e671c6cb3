"""Plain PyTorch version of the expert layer's gather back and weighted
sum over the top-k: the expression ``models/moe.py`` ran before the
kernel pair of ``csrc/moe_combine.cu``. What the wrapper runs for tensors
on the CPU and on the meta device (shapes only), and the oracle the
kernels are held against on the card."""
from __future__ import annotations

import torch


def combine_reference(y, slot, w):
    """y: [rows, d] the experts' output rows; slot: [T, k] each route's
    row, ``rows`` (the trash row, a zero row here) for a route that adds
    nothing; w: [T, k] the routes' weights in y's dtype. Returns [T, d]:
    each token's sum of ``w * y[slot]`` over its routes, each product
    rounded to y's dtype before the sum."""
    T, k = slot.shape
    d = y.shape[1]
    yf = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    tok_y = yf[slot.reshape(-1)]                                  # [T*k, d]
    return (tok_y * w.reshape(-1)[:, None]).reshape(T, k, d).sum(dim=1)
