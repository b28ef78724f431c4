"""Hot-path kernels: nearest-code selection, code lookup, the fused
training step, the LFQ entropy sweeps and the fused ResidualFSQ eval."""

from .distance import (
    gather_codes,
    nearest_code,
    nearest_code_plain,
    nearest_code_xla,
    quantize_lookup,
)
from .lfq_entropy import lfq_entropy_stats
from .residual_fsq_fused import fused_residual_fsq_eval, fused_residual_fsq_eval_plain
from .train_fused import (
    code_statistics_plain,
    fused_train_quantize,
    fused_train_quantize_plain,
)
