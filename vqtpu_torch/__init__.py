"""vqtpu_torch — the PyTorch/CUDA port of vqtpu.

The JAX package `vqtpu` is the reference; this package mirrors its layout
(core, kernels, codebook, quantizers, composite, models, utils) with torch
modules. Its hot path runs on hand-written CUDA kernels for Hopper:
nearest-code selection (kernels/csrc/nearest_code.cu), the fused training
step (kernels/csrc/train_fused.cu), the LFQ entropy sweeps
(kernels/csrc/lfq_entropy.cu) and the fused ResidualFSQ eval
(kernels/csrc/residual_fsq_fused.cu). Entry points run on the CUDA card
unless given `device='cpu'`. Ported so far: the eval forward and the EMA
training step of VectorQuantize with its distance-materializing features
(stochastic and gumbel straight-through codes, the cross-entropy and
diversity losses, `indices=`, `topk=`, `codebook_transform_fn=`),
ResidualVQ and GroupedResidualVQ (shared codebooks, quantize dropout, beam
search; each layer on the selection kernel in eval and the fused train
kernel in EMA training), LFQ with its entropy aux loss, ResidualLFQ and
GroupedResidualLFQ, FSQ, ResidualFSQ and GroupedResidualFSQ (eval and
training), and the flagship SimpleQuantizeAutoEncoder.
"""

from .composite.residual_fsq import GroupedResidualFSQ, ResidualFSQ
from .composite.residual_lfq import GroupedResidualLFQ, ResidualLFQ
from .composite.residual_vq import GroupedResidualVQ, ResidualVQ
from .quantizers.fsq import FSQ
from .quantizers.lfq import LFQ
from .quantizers.vq import LossBreakdown, VectorQuantize
from .models.autoencoder import SimpleQuantizeAutoEncoder
from .utils.weights import load_vqtpu_state

__all__ = [
    'VectorQuantize', 'LossBreakdown', 'ResidualVQ', 'GroupedResidualVQ', 'LFQ', 'ResidualLFQ', 'GroupedResidualLFQ',
    'FSQ', 'ResidualFSQ', 'GroupedResidualFSQ',
    'SimpleQuantizeAutoEncoder', 'load_vqtpu_state',
]
