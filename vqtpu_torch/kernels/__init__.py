"""Hot-path kernels: nearest-code selection and code lookup."""

from .distance import (
    gather_codes,
    nearest_code,
    nearest_code_plain,
    nearest_code_xla,
    quantize_lookup,
)
