"""The optimizer the port's trainers and entry points use in place of
`optax.adamw`."""

from __future__ import annotations

import torch

# optax.adamw's default weight decay; torch.optim.AdamW's default is 1e-2
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


def adamw(params, lr: float) -> torch.optim.AdamW:
    """`optax.adamw(lr)` in torch: b1 0.9, b2 0.999 and eps 1e-8 are both
    libraries' defaults; the weight decay is optax's 1e-4, decoupled as in
    optax (p -= lr * (adam update + wd * p))."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)
