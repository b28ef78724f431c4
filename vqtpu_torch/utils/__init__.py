"""Weight transfer from the JAX package and from upstream checkpoints,
checkpointing, and profiling (counterpart of vqtpu/utils)."""

from .checkpoint import DERIVED_STATE_DOC, load_state_dict, restore_checkpoint, save_checkpoint, state_dict
from .profiling import annotate, timeit_chained, trace
from .torch_import import import_torch_state
from .weights import load_vqtpu_state
