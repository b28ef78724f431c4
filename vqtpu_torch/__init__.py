"""vqtpu_torch — the PyTorch/CUDA port of vqtpu.

The JAX package `vqtpu` is the reference; this package mirrors its layout
(core, kernels, codebook, quantizers, composite, parallel, models, utils) with torch
modules. Its hot path runs on hand-written CUDA kernels for Hopper:
nearest-code selection (kernels/csrc/nearest_code.cu), the fused training
step (kernels/csrc/train_fused.cu), the LFQ entropy sweeps
(kernels/csrc/lfq_entropy.cu) and the fused ResidualFSQ eval
(kernels/csrc/residual_fsq_fused.cu). Entry points run on the CUDA card
unless given `device='cpu'`. Ported so far: the eval forward and the
training step of VectorQuantize, with an EMA or a learnable codebook (the
in-place codebook optimizer, the orthogonal regularization, DiVeQ,
sync_update_v, affine_param, stat_precision and the FVQ bridge
`models.MiniEncoder`; the learnable rows' gradient summed by code on the
card) and its distance-materializing features (stochastic and gumbel
straight-through codes, the cross-entropy and diversity losses,
`indices=`, `topk=`, `codebook_transform_fn=`), ResidualVQ and
GroupedResidualVQ (shared codebooks, quantize dropout, beam search, QINCo
and DiVeQ; each layer on the selection kernel in eval and the fused train
kernel in EMA training), LFQ with its entropy aux loss, ResidualLFQ and
GroupedResidualLFQ, FSQ, ResidualFSQ and GroupedResidualFSQ (eval and
training), the flagship SimpleQuantizeAutoEncoder, and the rest of the
JAX package's quantizers: SimVQ and ResidualSimVQ (selection and rows on
the selection kernel, the transform's gradient through the per-code sums),
RandomProjectionQuantizer (the selection kernel over all heads),
HierarchicalVQ (one VectorQuantize across scales), FSP, LatentQuantize,
BinaryMapper and Sequential, with the codebook metrics. Data parallelism
runs over torch.distributed (`parallel`: collectives named by mesh axis,
the data-parallel trainer; the quantizers' `sync_axis`), and so do
row-sharded codebooks (the codebook-bearing modules' `code_axis`,
`parallel.TensorParallelTrainer`, `parallel.tp_apply`) and group-parallel
Grouped composites (`parallel.group_parallel_forward`); `utils` holds
checkpointing, the import of upstream checkpoints and profiling, and
`entry` the repo's entry points (`entry()`, `dryrun_multichip(n)`).
"""

from .composite.hierarchical_vq import HierarchicalVQ
from .composite.residual_fsq import GroupedResidualFSQ, ResidualFSQ
from .composite.residual_lfq import GroupedResidualLFQ, ResidualLFQ
from .composite.residual_sim_vq import ResidualSimVQ
from .composite.residual_vq import GroupedResidualVQ, ResidualVQ
from .composite.sequential import Sequential
from .core.metrics import codebook_perplexity, codebook_utilization, ema_perplexity, ema_utilization
from .quantizers.binary_mapper import BinaryMapper
from .quantizers.fsp import FSP
from .quantizers.fsq import FSQ
from .quantizers.latent import LatentQuantize
from .quantizers.lfq import LFQ
from .quantizers.rpq import RandomProjectionQuantizer
from .quantizers.sim_vq import SimVQ
from .quantizers.vq import LossBreakdown, VectorQuantize
from .models.autoencoder import SimpleQuantizeAutoEncoder
from .utils.weights import load_vqtpu_state

__all__ = [
    'VectorQuantize', 'LossBreakdown', 'ResidualVQ', 'GroupedResidualVQ', 'RandomProjectionQuantizer',
    'FSQ', 'FSP', 'LFQ', 'ResidualLFQ', 'GroupedResidualLFQ', 'ResidualFSQ', 'GroupedResidualFSQ',
    'LatentQuantize', 'SimVQ', 'ResidualSimVQ', 'BinaryMapper', 'HierarchicalVQ', 'Sequential',
    'codebook_perplexity', 'codebook_utilization', 'ema_perplexity', 'ema_utilization',
    'SimpleQuantizeAutoEncoder', 'load_vqtpu_state',
]
