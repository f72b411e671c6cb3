"""LR schedules, the port of ``repro.optim.schedules``. The paper drops the
LR at epoch 130 of 300 (Fig. 4). Each schedule maps a step or epoch (an
int or a 0-d tensor) to a 0-d f32 tensor."""
from __future__ import annotations

import math

import torch


def step_decay(base_lr: float, boundaries=(130,), factor: float = 0.1):
    def lr(epoch):
        e = torch.as_tensor(epoch)
        k = sum((e >= b).to(torch.int32) for b in boundaries)
        return base_lr * torch.as_tensor(factor, dtype=torch.float32) ** k
    return lr


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, base_lr * cos)
    return lr
