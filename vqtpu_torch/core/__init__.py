"""Tensor helpers and input layouts (counterpart of vqtpu/core): the
submodules and the public names of the JAX package's core. The NNX
`ModeModule` (vqtpu/core/module.py) has no counterpart: `nn.Module.training`
and `train()`/`eval()` are its PyTorch form."""

from . import layout, metrics, sampling, ste, utils
from .layout import TokenLayout, to_tokens
from .metrics import (
    codebook_perplexity, codebook_utilization, ema_perplexity, ema_utilization, index_histogram,
    perplexity_from_histogram,
)
from .sampling import batched_sample_vectors, gumbel_sample, masked_sample_vectors, sample_vectors
from .ste import directional_reparam, floor_ste, frac_gradient, rotate_to, round_ste, straight_through
from .utils import cdist, cdist_sq, default, entropy, exists, l2norm, lens_to_mask, masked_mean, safe_div
