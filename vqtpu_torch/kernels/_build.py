"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on first use into a shared library with a
plain C interface, `build/vqtpu_torch/<name>-<hash>.so` at the repo root.
The hash covers every file under `csrc/` and the nvcc flags, so a changed
source is rebuilt and an unchanged one is loaded as it is. The compiler's
`-Xptxas -v` report (registers, shared memory, spills) is kept beside the
library as `<name>-<hash>.log`.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'vqtpu_torch'

NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
    '-Xptxas', '-v',
)

_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which('nvcc')
    if found:
        return found
    candidate = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        'nvcc not found (looked on PATH and in $CUDA_HOME/bin, '
        '/usr/local/cuda/bin); the CUDA kernels cannot be built'
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names: list[str]) -> None:
    """Compile the named sources that are not built yet, all nvcc processes
    started together, and wait for every one of them."""
    started = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in started:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f'{name}: nvcc exited {proc.returncode}\n{out}')
            continue
        lib.with_suffix('.log').write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failures))


def build_log(name: str) -> str:
    """The compiler's report for the built library of `name`."""
    return library_path(name).with_suffix('.log').read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libraries[name] = lib
    return lib
