"""Quantizer layers."""

from .vq import LossBreakdown, VectorQuantize
