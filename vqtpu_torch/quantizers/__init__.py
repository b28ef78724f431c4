"""Quantizer layers."""

from .lfq import LFQ
from .vq import LossBreakdown, VectorQuantize
