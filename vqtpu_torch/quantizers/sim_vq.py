"""SimVQ (counterpart of vqtpu/quantizers/sim_vq.py).

https://arxiv.org/abs/2411.02038: a frozen gaussian codebook (c, fd),
scaled by fd^-0.5, realized through a learnable transform (a bias-free
Linear(fd, dim) by default); only the transform trains. Selection and rows
run `kernels.train_fused.lookup_with_code_grad` on the implicit codebook:
on the card one launch of the selection kernel picks the codes and copies
their rows, and the backward sums the rows' gradients by code
(`code_sums`), from where they reach the transform. x takes no gradient
from the pick, as under the JAX package's stop-gradient.

In training the dual commitment loss and the rotation trick (or the
straight-through estimator) follow; eval returns the rows as they are and
a zero loss.

The implicit codebook and the selection run in f32 with autocast off
(`core.utils.autocast_off`): under a caller's bf16 autocast the transform's
product stays f32, as the JAX package forces its core to f32.

Row-sharded (`code_axis`, see `parallel.tp`): the frozen codebook's rows
shard over the axis inside a bound mesh, and the transform, row-wise, stays
replicated. Selection is `parallel.shard.sharded_nearest_code` on the
rank's implicit rows, and the rows come from their owners
(`sharded_gather_codes`, whose backward sums the rows' gradients by code
with `code_sums`). The transform's gradient on a rank is then its rows'
share: it is declared in `_code_partial_grad_submodules`, and the trainer
psums it over the axis.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..core.ste import rotate_to, straight_through
from ..core.utils import autocast_off, default, f32_core, resolve_device
from ..kernels.distance import gather_codes, nearest_code_xla
from ..kernels.train_fused import lookup_with_code_grad
from ..parallel.shard import sharded_gather_codes, sharded_nearest_code
from ..parallel.tp import check_code_rows


class SimVQ(nn.Module):
    # the frozen codebook (c, fd) shards over `code_axis` (parallel.tp); the
    # replicated transform sees only the rank's rows
    _code_sharded_leaves = {'frozen_codebook': 2}
    _code_partial_grad_submodules = ('code_transform',)

    def __init__(
        self,
        dim: int,
        codebook_size: int,
        codebook_transform: nn.Module | Callable | None = None,
        init_fn: Callable = lambda t: t,
        channel_first: bool = False,
        rotation_trick: bool = True,
        input_to_quantize_commit_loss_weight: float = 0.25,
        commitment_weight: float = 1.0,
        frozen_codebook_dim: int | None = None,
        use_pallas: bool = True,
        code_axis: str | None = None,
        *,
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device`: where the module lives; the CUDA card when None (raises
        if there is none), or 'cpu'. `rngs` must be None: the frozen codebook
        and the transform come from torch's global generator.
        `use_pallas=False` selects with the JAX package's XLA formulation
        (`nearest_code_xla`) in plain torch instead of the kernel."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        device = resolve_device(device)
        self.codebook_size = codebook_size
        self.code_axis = code_axis
        self.channel_first = channel_first

        frozen_codebook_dim = default(frozen_codebook_dim, dim)
        codebook = torch.randn(codebook_size, frozen_codebook_dim, device=device) * frozen_codebook_dim ** -0.5
        self.register_buffer('frozen_codebook', init_fn(codebook))
        if codebook_transform is None:
            codebook_transform = nn.Linear(frozen_codebook_dim, dim, bias=False, device=device)
        self.code_transform = codebook_transform

        self.rotation_trick = rotation_trick
        self.input_to_quantize_commit_loss_weight = input_to_quantize_commit_loss_weight
        self.commitment_weight = commitment_weight
        self.use_pallas = use_pallas

    @property
    def codebook(self) -> torch.Tensor:
        """The implicit codebook (c, dim): the transform of the frozen one,
        with autocast off."""
        with autocast_off(self.frozen_codebook.device):
            return self.code_transform(self.frozen_codebook)

    @property
    def codebook_dim(self) -> int:
        return self.frozen_codebook.shape[-1]

    def _code_parallel(self) -> bool:
        return self.code_axis is not None and check_code_rows(self, self.frozen_codebook.shape[0])

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """The transform of the gathered frozen rows."""
        if self._code_parallel():
            frozen = sharded_gather_codes(self.frozen_codebook, indices, self.code_axis)
        else:
            frozen = gather_codes(self.frozen_codebook, indices)
        with autocast_off(frozen.device):
            quantized = self.code_transform(frozen)
        if self.channel_first:
            quantized = quantized.movedim(-1, 1)
        return quantized

    @f32_core
    def lookup(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, dim) tokens -> (indices int32, rows of the implicit codebook
        that carry their gradient to the transform)."""
        implicit = self.codebook.float().contiguous()
        x = tokens.detach().float().contiguous()
        if self._code_parallel():
            indices = sharded_nearest_code(x, implicit, self.code_axis)
            return indices, sharded_gather_codes(implicit, indices, self.code_axis)
        if not self.use_pallas:
            indices = nearest_code_xla(x, implicit.detach())
            return indices, gather_codes(implicit, indices)
        return lookup_with_code_grad(x, implicit, 'euclidean')

    def forward(self, x: torch.Tensor):
        """x -> (quantized, indices int32, loss)."""
        if self.channel_first:
            x = x.movedim(1, -1)
        lead_shape, d = x.shape[:-1], x.shape[-1]
        x_tokens = x.reshape(-1, d)

        indices, quantized = self.lookup(x_tokens)
        if self.training:
            # the dual commitment loss: codebook -> input, and input ->
            # codebook weighted down
            commit_loss = (
                ((x_tokens.detach() - quantized) ** 2).mean()
                + ((x_tokens - quantized.detach()) ** 2).mean() * self.input_to_quantize_commit_loss_weight
            )
            if self.rotation_trick:
                quantized = rotate_to(x_tokens, quantized)
            else:
                quantized = straight_through(x_tokens, quantized)
        else:
            # eval: the estimators' forward value is the row itself
            commit_loss = torch.zeros((), device=quantized.device)

        quantized = quantized.reshape(*lead_shape, d)
        indices = indices.reshape(lead_shape)
        if self.channel_first:
            quantized = quantized.movedim(-1, 1)
        return quantized, indices, commit_loss * self.commitment_weight
