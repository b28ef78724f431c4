"""Composite quantizers: residual stacks of the port's quantizers, the
multi-scale HierarchicalVQ and Sequential."""

from .hierarchical_vq import HierarchicalVQ
from .residual_fsq import GroupedResidualFSQ, ResidualFSQ
from .residual_lfq import GroupedResidualLFQ, ResidualLFQ
from .residual_sim_vq import ResidualSimVQ
from .residual_vq import MLP, GroupedResidualVQ, ResidualVQ
from .sequential import QUANTIZE_KLASSES, Sequential
