"""Composite quantizers: residual stacks of the port's quantizers."""

from .residual_fsq import GroupedResidualFSQ, ResidualFSQ
from .residual_lfq import GroupedResidualLFQ, ResidualLFQ
from .residual_vq import GroupedResidualVQ, ResidualVQ
