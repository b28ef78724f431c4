"""Whole-step compilation: the port's counterpart of `jax.jit` and
`nnx.jit` around a step.

`compile_step(fn)` is `torch.compile(fn, fullgraph=True)`: one graph or an
error, never a silent fallback to eager pieces. Dynamo traces
`torch.autograd.grad` into that graph (its `trace_autograd_ops` setting,
on for the call), so a training step that takes its gradients with
`torch.autograd.grad` and applies them with `core.optim.adamw_update`
compiles whole, forward, backward and update, as JAX's jitted step does.
The hand-written kernels are `torch.ops.vqtpu` custom ops, opaque to the
compiler: the graph calls the kernel, and inductor fuses the glue around
it, as XLA fuses around a `pallas_call`.

An exception that the traced code raises (an unbound axis name's
NameError, say) propagates as its own type, as it does from a
`jax.jit`'s trace, not as Dynamo's refusal to compile it.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch


def compile_step(fn: Callable, *, backend: str = 'inductor', mode: str | None = None) -> Callable:
    """`fn` compiled whole (`fullgraph=True`) with `backend` and `mode`
    (`'reduce-overhead'` replays it as a CUDA graph). It compiles on the
    first call, and again when a guard fails (a new shape, say); a graph
    break raises."""
    compiled = torch.compile(fn, backend=backend, mode=mode, fullgraph=True)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch._dynamo.config.patch(trace_autograd_ops=True):
            try:
                return compiled(*args, **kwargs)
            except torch._dynamo.exc.Unsupported as e:
                raised = _raised_by_traced_code(e)
                if raised is None:
                    raise
                raise raised(str(e.__cause__)) from e

    return run


def _raised_by_traced_code(e: Exception) -> type | None:
    """The type of the exception the traced code raised, where that is why
    Dynamo refused a whole-graph compile (its `Observed...` exception is
    the cause), else None."""
    from torch._dynamo import exc

    for raised, observed in getattr(exc, 'observed_exception_map', {}).items():
        if type(e.__cause__) is observed:
            return raised
    return None
