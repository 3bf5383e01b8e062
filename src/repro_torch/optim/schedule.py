"""LR schedules (``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 200, total: int = 10000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio``: a scale in (0, 1]
    multiplying the base LR, as an fp32 tensor on ``step``'s device (a
    tensor step stays on its device: no host sync)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, warmup)
    progress = torch.clamp((step - warmup) / max(1.0, total - warmup),
                           0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                             * progress))
    return torch.where(step < warmup, warm, cos)
