"""Sequential (counterpart of vqtpu/composite/sequential.py).

A chain of modules holding exactly one quantizer: forward kwargs go to the
quantizer, and its outputs after the first (indices, losses) come back
beside the chain's output. Whatever kernel the quantizer runs, the chain
runs.
"""

from __future__ import annotations

from torch import nn

from ..quantizers.fsp import FSP
from ..quantizers.fsq import FSQ
from ..quantizers.latent import LatentQuantize
from ..quantizers.lfq import LFQ
from ..quantizers.rpq import RandomProjectionQuantizer
from ..quantizers.sim_vq import SimVQ
from ..quantizers.vq import VectorQuantize
from .hierarchical_vq import HierarchicalVQ
from .residual_fsq import GroupedResidualFSQ, ResidualFSQ
from .residual_lfq import GroupedResidualLFQ, ResidualLFQ
from .residual_sim_vq import ResidualSimVQ
from .residual_vq import GroupedResidualVQ, ResidualVQ

QUANTIZE_KLASSES = (
    VectorQuantize,
    ResidualVQ,
    GroupedResidualVQ,
    RandomProjectionQuantizer,
    FSQ,
    LFQ,
    SimVQ,
    ResidualSimVQ,
    ResidualLFQ,
    GroupedResidualLFQ,
    ResidualFSQ,
    GroupedResidualFSQ,
    FSP,
    LatentQuantize,
    HierarchicalVQ,
)


class Sequential(nn.Module):
    def __init__(self, *fns: nn.Module):
        super().__init__()
        if sum(isinstance(fn, QUANTIZE_KLASSES) for fn in fns) != 1:
            raise ValueError('this special Sequential must contain exactly one quantizer')
        self.fns = nn.ModuleList(fns)

    def forward(self, x, **kwargs):
        rest = ()
        for fn in self.fns:
            if not isinstance(fn, QUANTIZE_KLASSES):
                x = fn(x)
                continue
            x, *rest = fn(x, **kwargs)
        return (x, *rest)
