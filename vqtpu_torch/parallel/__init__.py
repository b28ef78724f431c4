"""Data parallelism over torch.distributed (counterpart of vqtpu/parallel):
collectives named by mesh axis, meshes of process groups, the
data-parallel trainer and multi-process set-up. The row-sharded codebooks
of tensor parallelism (`code_axis`: sharded_vq, tp, the sharded_* helpers
of shard, group) are not ported yet."""

from . import collectives
from .collectives import all_gather, axis_size, pmean, psum
from .multihost import global_batch, init_multihost, is_multiprocess
from .shard import DataParallelTrainer, Mesh, eval_step_fn, make_mesh
