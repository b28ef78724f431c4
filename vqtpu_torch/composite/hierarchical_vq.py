"""HierarchicalVQ (counterpart of vqtpu/composite/hierarchical_vq.py).

VAR-style multi-scale image quantization (https://arxiv.org/abs/2404.02905):
pool the residual to each scale, quantize it with one shared
VectorQuantize, upsample bilinearly and smooth with a residual 3x3
convolution (Phi), summing the reconstruction from coarse to fine.

The JAX package pools with two matrix products built from the adaptive
windows; here `F.adaptive_avg_pool2d` takes the same windows and sums them
in another order, so a scale's input matches to f32 rounding. The
upsample is `F.interpolate(mode='bilinear', align_corners=False)`, whose
half-pixel centers and edge clamping are those of `jax.image.resize(...,
'bilinear')` when it upsamples. On the card each scale is one launch of the
selection kernel in eval and of the fused train kernel in an EMA training
step ('on', or 'auto').
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.utils import exists, resolve_device
from ..quantizers.vq import VectorQuantize


class _Phi2D(nn.Module):
    """Residual 3x3-conv smoother over (b, c, h, w)."""

    def __init__(self, dim: int, resi_ratio: float, *, device=None):
        super().__init__()
        self.resi_ratio = float(abs(resi_ratio))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resi_ratio <= 1e-8:
            return x
        # a bf16 or fp16 input meets the f32 weights in f32, as JAX promotes it
        return (1.0 - self.resi_ratio) * x + self.resi_ratio * self.conv(x.to(self.conv.weight.dtype))


class HierarchicalVQ(nn.Module):
    def __init__(
        self,
        *,
        dim: int,
        codebook_size: int,
        scales: Sequence[int],
        decay: float = 0.99,
        commitment_weight: float = 1.0,
        rotation_trick: bool = False,
        kmeans_init: bool = True,
        kmeans_iters: int = 10,
        threshold_ema_dead_code: float = 2,
        stochastic_sample_codes: bool = False,
        sample_codebook_temp: float = 0.1,
        orthogonal_reg_weight: float = 0.0,
        orthogonal_reg_max_codes: int = 128,
        orthogonal_reg_active_codes_only: bool = False,
        quant_resi: float = 0.5,
        share_quant_resi: int = 1,
        accept_image_fmap: bool = False,
        rngs=None,
        device: str | torch.device | None = None,
        **vq_kwargs,
    ):
        """`device` as for VectorQuantize; `rngs` must be None. `vq_kwargs`
        go to the VectorQuantize (`train_fused` among them)."""
        super().__init__()
        if rngs is not None:
            raise TypeError('rngs is a flax RNG stream; seed torch with torch.manual_seed instead')
        if not accept_image_fmap:
            raise ValueError('HierarchicalVQ currently expects accept_image_fmap = True')
        scales = [int(s) for s in scales]
        if not scales or scales != sorted(scales) or any(s <= 0 for s in scales):
            raise ValueError(f'scales must be positive and ascending, got {scales}')
        device = resolve_device(device)
        self.dim = dim
        self.scales = tuple(scales)
        self.accept_image_fmap = True
        self.vq = VectorQuantize(
            dim=dim, codebook_size=codebook_size, decay=decay, commitment_weight=commitment_weight,
            rotation_trick=rotation_trick, kmeans_init=kmeans_init, kmeans_iters=kmeans_iters,
            threshold_ema_dead_code=threshold_ema_dead_code, stochastic_sample_codes=stochastic_sample_codes,
            sample_codebook_temp=sample_codebook_temp, orthogonal_reg_weight=orthogonal_reg_weight,
            orthogonal_reg_max_codes=orthogonal_reg_max_codes,
            orthogonal_reg_active_codes_only=orthogonal_reg_active_codes_only,
            accept_image_fmap=True, device=device, **vq_kwargs,
        )
        # `share_quant_resi` smoothers spread over the pyramid (1: one shared;
        # <= 0: one a scale), each scale taking the nearest by position
        num_phi = (
            1 if share_quant_resi == 1
            else len(self.scales) if share_quant_resi <= 0
            else min(len(self.scales), int(share_quant_resi))
        )
        self.phi_levels = nn.ModuleList([_Phi2D(dim, quant_resi, device=device) for _ in range(num_phi)])
        span = max(len(self.scales) - 1, 1)
        self._phi_of_scale = tuple(
            min(num_phi - 1, round((num_phi - 1) * i / span)) for i in range(len(self.scales)))

    def _upsample_to_full(self, q: torch.Tensor, full_hw: tuple[int, int], scale_index: int) -> torch.Tensor:
        if tuple(q.shape[-2:]) != tuple(full_hw):
            q = F.interpolate(q, size=full_hw, mode='bilinear', align_corners=False)
        return self.phi_levels[self._phi_of_scale[scale_index]](q)

    def forward(self, x: torch.Tensor, indices=None, sample_codebook_temp: float | None = None, **kwargs):
        """(b, dim, h, w) -> (reconstruction, per-scale indices (b, s, s),
        mean commitment loss over the scales)."""
        if indices is not None:
            raise ValueError('reconstruction-from-indices path not implemented in forward')
        if x.ndim != 4 or x.shape[1] != self.dim:
            raise ValueError(f'expected an image fmap (batch, {self.dim}, height, width), got {tuple(x.shape)}')
        height, width = x.shape[-2:]
        residual = x
        reconstruction = torch.zeros_like(x)
        all_indices, all_commit_losses = [], []
        vq_kwargs = {} if not exists(sample_codebook_temp) else {'sample_codebook_temp': sample_codebook_temp}
        for scale_index, scale in enumerate(self.scales):
            residual_down = residual
            if tuple(residual.shape[-2:]) != (scale, scale):
                residual_down = F.adaptive_avg_pool2d(residual, (scale, scale))
            quantized, scale_indices, commit_loss = self.vq(residual_down, **vq_kwargs)
            quantized = self._upsample_to_full(quantized, (height, width), scale_index)
            reconstruction = reconstruction + quantized
            residual = residual - quantized
            all_indices.append(scale_indices)
            all_commit_losses.append(commit_loss)
        return reconstruction, tuple(all_indices), torch.stack(all_commit_losses).mean()

    def get_output_from_indices(self, indices) -> torch.Tensor:
        if not isinstance(indices, (tuple, list)) or len(indices) != len(self.scales):
            raise ValueError(f'expected {len(self.scales)} per-scale indices')
        full_hw = (self.scales[-1], self.scales[-1])
        reconstructed = None
        for scale_index, scale_indices in enumerate(indices):
            q = self.vq.get_output_from_indices(scale_indices)
            q = self._upsample_to_full(q, full_hw, scale_index)
            reconstructed = q if reconstructed is None else reconstructed + q
        return reconstructed
