"""Tracing and timing helpers (counterpart of vqtpu/utils/profiling.py).

- `trace(logdir)`: a `torch.profiler` capture of the CPU and, when there
  is a card, the CUDA activity of the block, written into `logdir` as a
  Chrome trace (chrome://tracing, Perfetto);
- `annotate(name)`: a labelled range in that trace (`record_function`),
  and an NVTX range when there is a card;
- `timeit_chained(fn, *args, lo, hi)`: seconds per call of `fn(*args)`,
  the slope between `lo` and `hi` back-to-back calls, so that the fixed
  cost of starting and ending a timing cancels. On the card the calls are
  timed with CUDA events (the device's time, launches queued back to
  back); on the CPU with `time.perf_counter`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str | os.PathLike):
    """Profile the block; its Chrome trace is written to
    `logdir/trace.json`. Yields the `torch.profiler.profile` object."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(os.fspath(logdir), 'trace.json'))


@contextlib.contextmanager
def annotate(name: str):
    """Label the block in a profiler trace (and an NVTX range on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device('cpu')


def timeit_chained(fn: Callable, *args, lo: int = 2, hi: int = 18) -> float:
    """Seconds per call of `fn(*args)`: (time of `hi` calls - time of `lo`
    calls) / (hi - lo), each run back to back after a warm-up. The device is
    that of the first tensor argument: CUDA events there, the host clock
    on the CPU."""
    if not 0 < lo < hi:
        raise ValueError(f'need 0 < lo < hi, got lo={lo}, hi={hi}')
    cuda = _device_of(args).type == 'cuda'

    def run(calls: int) -> float:
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(calls):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        return time.perf_counter() - t0

    run(lo)                                   # warm-up
    return (run(hi) - run(lo)) / (hi - lo)
