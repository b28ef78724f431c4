"""Weight transfer from the JAX package."""

from .weights import load_vqtpu_state
