"""Build and load the native data runtime (native/vqdata.c) through ctypes
(counterpart of vqtpu/models/native_build.py).

The C sources are the repository's own `native/*.c`, compiled unchanged
with the system C compiler at first use into `build/vqtpu_torch/native/`
(never into `native/build/`, which is the JAX package's). `load()` returns
None when no compiler or no source is there; the callers decide whether
that is an error.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SRC_DIR = os.path.join(REPO_ROOT, 'native')
OUT_DIR = os.path.join(REPO_ROOT, 'build', 'vqtpu_torch', 'native')
_SRC = os.path.join(NATIVE_SRC_DIR, 'vqdata.c')
_OUT = os.path.join(OUT_DIR, 'libvqdata.so')


def compile_lib(src: str, out: str) -> str | None:
    """Compile one C source into a shared library; cached while `out` is
    newer than `src`. The library is written to a temporary name and moved
    into place, so a process that loads `out` never sees half a file.
    Returns `out`, or None when the source or every compiler is missing."""
    if not os.path.exists(src):
        return None
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=os.path.dirname(out))
    os.close(fd)
    try:
        for cc in ('cc', 'gcc', 'clang'):
            try:
                subprocess.run([cc, '-O3', '-shared', '-fPIC', '-o', tmp, src],
                               check=True, capture_output=True, timeout=120)
            except (FileNotFoundError, subprocess.SubprocessError):
                continue
            os.replace(tmp, out)
            return out
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_lib = None


def load() -> ctypes.CDLL | None:
    """The loaded vqdata library with typed signatures, or None if it cannot
    be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    path = compile_lib(_SRC, _OUT)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.vq_idx_open.argtypes = [ctypes.c_char_p]
    lib.vq_idx_open.restype = ctypes.c_void_p
    lib.vq_idx_close.argtypes = [ctypes.c_void_p]
    lib.vq_idx_close.restype = None
    for fn in ('vq_idx_count', 'vq_idx_rows', 'vq_idx_cols'):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int64
    lib.vq_idx_gather_f32.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vq_idx_gather_f32.restype = ctypes.c_int
    _lib = lib
    return _lib
