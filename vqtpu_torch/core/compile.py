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
import itertools
import types
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


def cached_body(cache: dict, key, build: Callable, backend: str) -> Callable:
    """`cache[key]`: the function `build()` returns, compiled with `backend`
    (`compile_step`) on a miss. These are the compiled bodies of the
    distributed paths, kept as the JAX package keeps its jitted shard_maps,
    so that a loop compiles once; a FIFO of at most `MAX_BODIES`.

    Each body runs as a code object of its own. Dynamo keeps its graphs on
    the code object it traces, at most `recompile_limit` of them, and a
    fullgraph compile past that raises: with one code object for all
    keys, a process that met more than that many keys would fail where
    the eager path runs."""
    body = cache.get(key)
    if body is None:
        if len(cache) >= MAX_BODIES:
            cache.pop(next(iter(cache)))
        body = cache[key] = compile_step(_own_code(build()), backend=backend)
    return body


# the most compiled bodies a cache keeps (cached_body)
MAX_BODIES = 64
_BODY_NUMBERS = itertools.count()


def _own_code(fn: types.FunctionType) -> types.FunctionType:
    """`fn` as a new function whose code object is its own, named apart."""
    name = f'{fn.__name__}_{next(_BODY_NUMBERS)}'
    code = fn.__code__.replace(co_name=name, co_qualname=name)
    own = types.FunctionType(code, fn.__globals__, name, fn.__defaults__, fn.__closure__)
    own.__kwdefaults__ = fn.__kwdefaults__
    return own
