"""BinaryMapper (counterpart of vqtpu/quantizers/binary_mapper.py).

The Free Transformer's stochastic binary latents
(https://arxiv.org/abs/2510.17558): per-bit Bernoulli sampling with a
temperature, bits to an index by powers of two, a one-hot output with the
"soft G" straight-through gradient, a hinged KL-to-uniform auxiliary loss,
and exact log-probabilities of indices or one-hots. No kernel.

The bits are drawn from `self.generator` through `core.sampling.bernoulli`,
looked up at call time. As in the JAX package (and upstream), the module
samples in eval too unless `deterministic_on_eval=True`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import sampling
from ..core.sampling import attach_stream, one_hot_float
from ..core.utils import default, resolve_device

NAT = math.log(2)


def binary_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Sum over bits of H(sigmoid(logit)), in nats."""
    prob = torch.sigmoid(logits)
    return -(prob * F.logsigmoid(logits) + (1.0 - prob) * F.logsigmoid(-logits)).sum(-1)


class BinaryMapper(nn.Module):
    def __init__(
        self,
        bits: int = 1,
        kl_loss_threshold: float = NAT,
        deterministic_on_eval: bool = False,
        *,
        rngs=None,
        device: str | torch.device | None = None,
    ):
        """`device` as for VectorQuantize (the random stream's device); `rngs`
        must be None (`self.generator` is seeded from torch's global
        generator)."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        device = resolve_device(device)
        self.bits = bits
        self.num_codes = 2 ** bits
        self.kl_loss_threshold = kl_loss_threshold
        self.deterministic_on_eval = deterministic_on_eval
        self.generator = attach_stream(self, device)

    def _power_two(self, device) -> torch.Tensor:
        return 2 ** torch.arange(self.bits, device=device)

    def _codes_table(self, device) -> torch.Tensor:
        """(num_codes, bits) bool: code c has bit i set iff c & 2^i."""
        return (torch.arange(self.num_codes, device=device)[:, None] & self._power_two(device)) != 0

    def binary_entropy(self, logits: torch.Tensor) -> torch.Tensor:
        return binary_entropy(logits)

    def calc_aux_loss(self, logits: torch.Tensor, reduce_aux_kl_loss: bool = True) -> torch.Tensor:
        """The KL to the uniform code distribution, hinged at the threshold."""
        kl_div = self.bits * NAT - self.binary_entropy(logits)
        aux_kl_loss = F.relu(kl_div - self.kl_loss_threshold)
        return aux_kl_loss.mean() if reduce_aux_kl_loss else aux_kl_loss

    def log_prob(
        self,
        logits: torch.Tensor,
        *,
        indices: torch.Tensor | None = None,
        one_hot: torch.Tensor | None = None,
        sum_bits: bool = True,
    ) -> torch.Tensor:
        """The log-probability of codes under the per-bit Bernoullis."""
        if (indices is None) == (one_hot is None):
            raise ValueError('either indices or one_hot must be provided')
        if one_hot is not None:
            indices = one_hot.argmax(-1)
        sampled_bits = self._codes_table(logits.device)[indices.long()]
        log_probs = torch.where(sampled_bits, F.logsigmoid(logits), F.logsigmoid(-logits))
        return log_probs.sum(-1) if sum_bits else log_probs

    def forward(
        self,
        logits: torch.Tensor,
        temperature: float = 1.0,
        straight_through: bool | None = None,
        calc_aux_loss: bool | None = None,
        deterministic: bool | None = None,
        return_indices: bool = False,
        reduce_aux_kl_loss: bool = True,
    ):
        """(..., bits) logits -> (one-hot (..., 2^bits), aux loss), with the
        int indices in the middle when `return_indices`."""
        deterministic = default(deterministic, self.deterministic_on_eval and not self.training)
        straight_through = default(straight_through, self.training)
        calc_aux_loss = default(calc_aux_loss, self.training)
        if logits.shape[-1] != self.bits:
            raise ValueError(f'logits must have a last dimension of {self.bits}')

        prob_for_sample = torch.sigmoid(logits / temperature)
        if deterministic:
            sampled_bits = prob_for_sample > 0.5
        else:
            sampled_bits = sampling.bernoulli(self.generator, prob_for_sample.detach())
        indices = (self._power_two(logits.device) * sampled_bits.long()).sum(-1).to(torch.int32)
        one_hot = one_hot_float(indices, self.num_codes)

        aux_kl_loss = torch.zeros((), device=logits.device)
        if calc_aux_loss:
            aux_kl_loss = self.calc_aux_loss(logits, reduce_aux_kl_loss=reduce_aux_kl_loss)

        if straight_through:
            # soft G: the categorical distribution the per-bit Bernoullis imply
            # bf16 or fp16 log-sigmoids meet the f32 codes in f32, as JAX promotes them
            codes = self._codes_table(logits.device).float()
            log_p, log_q = F.logsigmoid(logits).float(), F.logsigmoid(-logits).float()
            soft_g = torch.exp(log_p @ codes.T + log_q @ (1.0 - codes).T)
            one_hot = one_hot + soft_g - soft_g.detach()

        if not return_indices:
            return one_hot, aux_kl_loss
        return one_hot, indices, aux_kl_loss
