"""The example trainers' shared loop (counterpart of examples/common.py):
AdamW, an L1 reconstruction plus alpha times the aux loss, and a log line
with the active-code share and the perplexity; and the process group of
the distributed examples.

The step is one function of the batch: the forward, the loss, its
gradients (`torch.autograd.grad`) and the AdamW update
(`core.optim.adamw_update`). On the card it runs compiled whole
(`core.compile.compile_step`: one graph, or an error), as the JAX script's
`@nnx.jit` step does, for every example: their random draws come from
counter-based streams held as module state (`core.sampling`), kmeans init
is one op that returns at once once the codebook is initialized, and an
in-place codebook optimizer steps through its functional update
(`core.optim.optimizer_update`).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from ..core import metrics
from ..core.compile import compile_step
from ..core.optim import OPTAX_ADAMW_WEIGHT_DECAY, adamw, adamw_update, prepare_adamw_for_graph  # noqa: F401
from ..core.utils import resolve_device
from ..models import data as data_module
from ..parallel import init_multihost

def l1_reconstruction(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The examples' reconstruction loss: mean |clip(out, -1, 1) - x|."""
    return (out.clamp(-1, 1) - x).abs().mean()


def train_step(model: nn.Module, opt: torch.optim.AdamW, loss_from_outputs: Callable, alpha: float, *,
               compiled: bool = False, backend: str = 'inductor', mode: str | None = None):
    """One training step as a function of the batch: the forward,
    `loss_from_outputs(outputs, x, alpha) -> (total, rec, aux, indices)`,
    the gradients of the total with respect to `opt`'s parameters and
    their AdamW update (`adamw_update`; a parameter without a gradient is
    not moved, as `opt.step()` leaves one whose `.grad` is None); returns
    (rec, aux, indices), detached. `opt` is an AdamW (`adamw`). With
    `compiled`, the step is `compile_step` of the same function with
    `backend` and `mode` (`'reduce-overhead'`: CUDA graphs): one graph,
    compiled at the first call."""
    params = [p for group in opt.param_groups for p in group['params']]
    prepare_adamw_for_graph(opt)

    def step(x: torch.Tensor):
        total, rec, aux, indices = loss_from_outputs(model(x), x, alpha)
        adamw_update(opt, torch.autograd.grad(total, params, allow_unused=True))
        return rec.detach(), aux.detach(), indices
    return compile_step(step, backend=backend, mode=mode) if compiled else step


def train_loop(
    model: nn.Module,
    *,
    loss_from_outputs: Callable,
    codebook_size: int,
    train_iter: int = 1000,
    lr: float = 3e-4,
    alpha: float = 10.0,
    batch_size: int = 256,
    seed: int = 1234,
    log_every: int = 50,
    device=None,
    compiled: bool | None = None,
) -> nn.Module:
    """Train `model` for `train_iter` AdamW steps on `image_batches(batch_size,
    seed)` (moved to `device`, the card when None) and return it.
    `loss_from_outputs(outputs, x, alpha) -> (total_loss, rec_loss,
    aux_loss, indices)`. Prints a line every `log_every` steps and at the
    last: the rec and aux losses, the share of codes the batch used and
    its perplexity. `compiled`: run the step compiled whole (`train_step`);
    None compiles it on the card and runs it eagerly on the CPU."""
    device = resolve_device(device)
    model.train()
    if compiled is None:
        compiled = device.type == 'cuda'
    step = train_step(model, adamw(model.parameters(), lr), loss_from_outputs, alpha, compiled=compiled)
    data = data_module.image_batches(batch_size=batch_size, seed=seed)

    t0 = time.time()
    for it in range(train_iter):
        x = torch.from_numpy(next(data)).to(device)
        rec, aux, indices = step(x)

        if it % log_every == 0 or it == train_iter - 1:
            active = float(metrics.codebook_utilization(indices, codebook_size)) * 100
            pplx = float(metrics.codebook_perplexity(indices, codebook_size))
            print(
                f'iter {it:5d} | rec loss: {float(rec):.3f} | '
                f'aux loss: {float(aux):.3f} | active %: {active:.1f} | '
                f'perplexity: {pplx:.1f} | '
                f'{time.time() - t0:.1f}s',
                flush=True,
            )
    return model


def add_device_arg(parser) -> None:
    parser.add_argument('--device', default=None,
                        help="where to train: the CUDA card by default, or 'cpu'")


@contextmanager
def distributed_job(device=None):
    """The process group the distributed examples run in: the one this
    process already belongs to, or else one initialized from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over gloo,
    which takes CUDA tensors, so that several ranks may share one card;
    rank r uses card LOCAL_RANK modulo the cards there are. A group this
    context initialized is destroyed when it exits."""
    if dist.is_initialized():
        yield
        return
    cards = None
    if resolve_device(device).type == 'cuda':
        cards = [int(os.environ.get('LOCAL_RANK', 0)) % torch.cuda.device_count()]
    init_multihost(None, local_device_ids=cards, backend='gloo')
    try:
        yield
    finally:
        dist.destroy_process_group()
