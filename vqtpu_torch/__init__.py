"""vqtpu_torch — the PyTorch/CUDA port of vqtpu.

The JAX package `vqtpu` is the reference; this package mirrors its layout
(core, kernels, codebook, quantizers, models, utils) with torch modules.
Its hot path, nearest-code selection, runs on a hand-written CUDA kernel
for Hopper (kernels/csrc/nearest_code.cu). Entry points run on the CUDA
card unless given `device='cpu'`. This slice ports the eval forward of
VectorQuantize and of the flagship SimpleQuantizeAutoEncoder.
"""

from .quantizers.vq import LossBreakdown, VectorQuantize
from .models.autoencoder import SimpleQuantizeAutoEncoder
from .utils.weights import load_vqtpu_state

__all__ = ['VectorQuantize', 'LossBreakdown', 'SimpleQuantizeAutoEncoder', 'load_vqtpu_state']
