"""Parallelism over torch.distributed (counterpart of vqtpu/parallel):
collectives named by mesh axis, meshes of process groups, the
data-parallel trainer, multi-process set-up (and `run_ranks`, a job of one
process a rank started from one process), row-sharded codebooks
(`code_axis`: the sharded_* helpers of shard, the sharded_vq engine, tp's
trainer and tp_apply) and group-parallel Grouped composites (group)."""

from . import collectives
from .collectives import all_gather, axis_size, pmean, psum
from .group import group_parallel_forward, group_parallel_output_from_indices
from .multihost import global_batch, init_multihost, is_multiprocess, run_ranks
from .shard import (
    DataParallelTrainer, Mesh, eval_step_fn, local_onehot_from_global, make_mesh, sharded_gather_codes,
    sharded_nearest_code, sharded_quantize_lookup_bf16, slice_local_cols,
)
from .sharded_vq import ShardedCodebookState, init_sharded_codebook, sharded_ema_update, sharded_quantize
from .tp import (
    TensorParallelTrainer, codebook_pspecs, find_code_partial_grad_paths, find_sharded_codebooks,
    gather_codebooks, gathered_state_dict, psum_partial_grads, shard_codebooks, tp_apply,
)
