"""Quantizer layers."""

from .binary_mapper import BinaryMapper
from .fsp import FSP, VectorNorm, build_cdf_act
from .fsq import FSQ
from .latent import LatentQuantize
from .lfq import LFQ, CosineSimLinear
from .rpq import RandomProjectionQuantizer
from .sim_vq import SimVQ
from .vq import LossBreakdown, VectorQuantize
