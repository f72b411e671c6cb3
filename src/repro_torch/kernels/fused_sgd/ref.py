"""Plain PyTorch version of the fused SGD update: the oracle the CUDA kernel
is held against on the card (bit for bit), and what the wrapper runs for
tensors on the CPU."""
from __future__ import annotations

import torch


def sgd_reference(p, g, m, *, lr, momentum=0.9, weight_decay=4e-5):
    """Textbook SGD + momentum + weight decay, one rounding per operation,
    in the order the kernel computes: g' = g + wd*p; m' = mu*m + g';
    p' = p - lr*m'. Returns new tensors (p', m')."""
    g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
    m_new = momentum * m.to(torch.float32) + g
    return (p.to(torch.float32) - lr * m_new).to(p.dtype), m_new.to(m.dtype)
