"""Multi-process execution (counterpart of vqtpu/parallel/multihost.py).

One process a rank: each calls `init_multihost` once, which initializes
the default `torch.distributed` process group, then builds one mesh over
every rank (`parallel.shard.make_mesh`) and trains as on one process. The
collectives run over NCCL between cards, or over gloo, which also takes
CUDA tensors (staged through the host): the way to run several ranks on
one card, since NCCL refuses two ranks on one device.

`run_ranks` starts such a job from one process: it runs a function in
`world` fresh interpreters, one a rank, and returns what each returned.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.utils import resolve_device


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    *,
    backend: str | None = None,
    timeout: timedelta = timedelta(minutes=10),
) -> None:
    """Initialize the default process group of a multi-process job.

    `coordinator_address`: 'host:port' of rank 0 (a `tcp://` rendezvous),
    or a URL with its scheme (`tcp://...`, `file://...`); None reads the
    rendezvous from the environment (`env://`: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK, as torchrun sets them). `local_device_ids`: the
    CUDA cards of this process; the first becomes its current device.
    `backend`: 'nccl' or 'gloo'; None takes NCCL when CUDA is available and
    gloo otherwise."""
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    if local_device_ids is not None:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kwargs = {}
    if num_processes is not None:
        kwargs['world_size'] = num_processes
    if process_id is not None:
        kwargs['rank'] = process_id
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_batch(mesh, spec, full_array, device: str | torch.device | None = None) -> torch.Tensor:
    """This rank's block of a host-level batch that every rank holds whole
    (made, say, from a shared seed): `spec` names, per leading dim, the mesh
    axis it is split over or None (`('data',)`: dim 0 over 'data'), as a
    JAX PartitionSpec does. Each split dim must divide evenly. The block
    lands on `device` (the CUDA card when None; raises without one, unless
    `full_array` is already a tensor on the card)."""
    if isinstance(full_array, np.ndarray):
        full_array = torch.from_numpy(full_array)
    block = full_array
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size, index = mesh.size(axis), mesh.index(axis)
        if block.shape[dim] % size:
            raise ValueError(f'dim {dim} of {tuple(full_array.shape)} does not split over {size} ranks')
        step = block.shape[dim] // size
        block = block.narrow(dim, index * step, step)
    if device is None and block.device.type == 'cuda':
        return block.contiguous()
    return block.to(resolve_device(device)).contiguous()


# -- one process a rank, started from one process --------------------------------

# what a rank's interpreter runs; not `-m`, so that no module is run twice
_RANK_MAIN = 'from vqtpu_torch.parallel.multihost import _rank_main; _rank_main()'


def _import_root(module_name: str, path: str) -> str:
    """The sys.path entry from which the module `module_name`, whose file
    is `path`, imports."""
    path = Path(path).resolve()
    return str(path.parents[module_name.count('.') + (path.name == '__init__.py')])


def rank_devices(world: int, backend: str, device=None) -> list[str]:
    """The device of each rank: 'cpu' for every rank on the CPU; on the
    card, NCCL puts rank r on card r (it refuses two ranks on one card, so
    `world` may not exceed the cards there are), and gloo rank r on card
    r modulo the cards, so that several ranks may share one."""
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    device = resolve_device(device)
    if device.type == 'cpu':
        if backend == 'nccl':
            raise ValueError("NCCL runs on CUDA cards only: pass backend='gloo' for ranks on the CPU")
        return ['cpu'] * world
    cards = torch.cuda.device_count()
    if backend == 'nccl' and world > cards:
        raise ValueError(f'NCCL puts one rank on each card: {world} ranks need {world} cards, '
                         f"this machine has {cards} (backend='gloo' lets ranks share a card)")
    return [f'cuda:{r % cards}' for r in range(world)]


def run_ranks(target, world: int, *, backend: str = 'nccl', device=None, axes=('data',), shape=None,
              kwargs: dict | None = None, timeout: float = 900.0) -> list:
    """[target(rank, world, mesh, device=<the rank's device>, **kwargs) for
    every rank]: each rank a fresh Python process (a subprocess, so that
    nothing of the caller's main module runs again) that joins a `backend`
    process group of `world` ranks through a rendezvous file, builds the
    mesh of `axes` in `shape` (`make_mesh`; one 'data' axis over every rank
    by default) and calls `target`, a function at the top level of a module.
    A target in the script that runs as the main program is imported from
    the script's file (not as `__main__`, so the script needs a main guard,
    as with multiprocessing's spawn); any other by its module's name.
    Devices as `rank_devices` gives them; `kwargs` and the results travel
    by pickle. Raises RuntimeError, with each failed rank's traceback and
    output, if a rank fails or does not finish within `timeout` seconds;
    when one rank fails, the others are stopped 60 s later at the latest."""
    devices = rank_devices(world, backend, device)
    main = sys.modules[target.__module__]
    # a function of a module run by `python -m` is importable under the module's name
    module = getattr(getattr(main, '__spec__', None), 'name', None) or target.__module__
    name = target.__qualname__
    if '<' in name or not getattr(main, '__file__', None):
        raise ValueError(f'{name} is not importable by a rank: define it at the top level of a module')
    script = str(Path(main.__file__).resolve()) if module == '__main__' else None
    roots = [_import_root(__name__, __file__), _import_root(module, main.__file__)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        dict.fromkeys([*roots, *filter(None, os.environ.get('PYTHONPATH', '').split(os.pathsep))])))
    work = Path(tempfile.mkdtemp(prefix='vqtpu_ranks_'))
    try:
        with open(work / 'spec.pkl', 'wb') as f:
            pickle.dump(dict(module=module, script=script, name=name, world=world, backend=backend,
                             devices=devices, axes=tuple(axes), shape=shape, timeout=timeout), f)
        with open(work / 'kwargs.pkl', 'wb') as f:
            pickle.dump(kwargs or {}, f)
        procs = []
        for r in range(world):
            with open(work / f'rank{r}.log', 'wb') as log:
                procs.append(subprocess.Popen([sys.executable, '-c', _RANK_MAIN, str(work), str(r)], env=env,
                                              stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + 60.0)
            time.sleep(0.1)
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            reports = []
            for r in failed:
                err = work / f'rank{r}.err'
                why = err.read_text() if err.exists() else ('did not finish' if r in hung else 'no traceback')
                log = (work / f'rank{r}.log').read_text(errors='replace')
                # a native abort prints its message before its stack's frames
                log = log if len(log) <= 8000 else f'{log[:4000]}\n[...]\n{log[-4000:]}'
                reports.append(f'rank {r} ({"hung" if r in hung else f"exit {procs[r].returncode}"}): '
                               f'{why}\n--- its output ---\n{log}')
            raise RuntimeError(f'{len(failed)} of {world} ranks of {module}.{name} failed '
                               f'(timeout {timeout} s):\n' + '\n'.join(reports))
        results = []
        for r in range(world):
            with open(work / f'rank{r}.pkl', 'rb') as f:
                results.append(pickle.load(f))      # written by this call's own ranks
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _rank_main() -> None:
    """A rank of `run_ranks`: argv is the work directory and the rank."""
    import importlib.util

    from .shard import make_mesh

    work, rank = Path(sys.argv[1]), int(sys.argv[2])
    try:
        with open(work / 'spec.pkl', 'rb') as f:
            spec = pickle.load(f)                   # written by the launching process
        if spec['script']:
            # the caller's main script, under the name multiprocessing's spawn gives it
            found = importlib.util.spec_from_file_location('__mp_main__', spec['script'])
            target = importlib.util.module_from_spec(found)
            sys.modules['__mp_main__'] = sys.modules['__main__'] = target
            found.loader.exec_module(target)
        else:
            target = importlib.import_module(spec['module'])
        for part in spec['name'].split('.'):
            target = getattr(target, part)
        with open(work / 'kwargs.pkl', 'rb') as f:
            kwargs = pickle.load(f)                 # written by the launching process
        device = spec['devices'][rank]
        init_multihost(f'file://{work}/rendezvous', spec['world'], rank,
                       [int(device.split(':')[1])] if device.startswith('cuda') else None,
                       backend=spec['backend'], timeout=timedelta(seconds=spec['timeout']))
        try:
            # every rank has joined before any may leave: a rank that left at
            # once would close the connections another is still making
            dist.barrier()
            result = target(rank, spec['world'], make_mesh(spec['axes'], spec['shape']), device=device, **kwargs)
        finally:
            dist.destroy_process_group()
        with open(work / f'rank{rank}.pkl', 'wb') as f:
            pickle.dump(result, f)
    except BaseException:
        (work / f'rank{rank}.err').write_text(traceback.format_exc())
        sys.exit(1)
