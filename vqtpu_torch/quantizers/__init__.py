"""Quantizer layers."""

from .fsq import FSQ
from .lfq import LFQ, CosineSimLinear
from .vq import LossBreakdown, VectorQuantize
