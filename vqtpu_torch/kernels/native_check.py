"""Independent native (C) oracle for nearest-code selection (counterpart of
vqtpu/kernels/native_check.py), used to hold the selection kernel (K1,
csrc/nearest_code.cu) to a float64 reference on the card's picks.

`nearest_code_ref` runs native/vqcheck.c: the direct |x - e|^2 (or x.e for
cosine) accumulated in double, first index on ties: no squared expansion,
no torch and no code shared with the kernel it checks. The library is
built by `models.native_build.compile_lib` into `build/vqtpu_torch/native/`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..models import native_build

_SRC = os.path.join(native_build.NATIVE_SRC_DIR, 'vqcheck.c')
_OUT = os.path.join(native_build.OUT_DIR, 'libvqcheck.so')

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = native_build.compile_lib(_SRC, _OUT)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.vq_nearest_ref_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vq_nearest_ref_f32.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the oracle's library builds and loads here."""
    return _load() is not None


def _host_f32(a) -> np.ndarray:
    if hasattr(a, 'detach'):                 # a torch tensor: copied to the host
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, np.float32)


def nearest_code_ref(x, embed, metric: str = 'euclidean') -> np.ndarray:
    """(n, d) tokens, (c, d) codes -> (n,) int32 nearest-code indices from
    the float64 oracle: argmin of |x - e|^2 ('euclidean') or argmax of x.e
    ('cosine', on the inputs as given), first index on ties.

    Takes numpy arrays (cast to float32). A torch tensor is taken only by
    its `.cpu().numpy()` copy on the host. Raises RuntimeError when the
    library cannot be built."""
    if metric not in ('euclidean', 'cosine'):
        raise ValueError(f"metric must be 'euclidean' or 'cosine', got {metric!r}")
    lib = _load()
    if lib is None:
        raise RuntimeError('native vqcheck unavailable')
    x, embed = _host_f32(x), _host_f32(embed)
    n, d = x.shape
    c = embed.shape[0]
    if embed.shape[1] != d:
        raise ValueError(f'x is (n, {d}) but embed is {embed.shape}')
    out = np.empty((n,), np.int32)
    lib.vq_nearest_ref_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        embed.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, d, 1 if metric == 'cosine' else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
