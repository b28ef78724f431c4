"""vqtpu_torch — the PyTorch/CUDA port of vqtpu.

The JAX package `vqtpu` is the reference; this package mirrors its layout
(core, kernels, codebook, quantizers, models, utils) with torch modules.
Its hot path runs on hand-written CUDA kernels for Hopper: nearest-code
selection (kernels/csrc/nearest_code.cu) and the fused training step
(kernels/csrc/train_fused.cu). Entry points run on the CUDA card unless
given `device='cpu'`. Ported so far: the eval forward and the EMA
training step of VectorQuantize, and the flagship
SimpleQuantizeAutoEncoder.
"""

from .quantizers.vq import LossBreakdown, VectorQuantize
from .models.autoencoder import SimpleQuantizeAutoEncoder
from .utils.weights import load_vqtpu_state

__all__ = ['VectorQuantize', 'LossBreakdown', 'SimpleQuantizeAutoEncoder', 'load_vqtpu_state']
