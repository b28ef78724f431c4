"""The optimizer the port's trainers and entry points use in place of
`optax.adamw`, and the updates of `torch.optim`'s SGD, Adam and AdamW as
functions of given gradients, which `torch.compile` traces into the
step's graph (`Optimizer.step` breaks the graph on purpose)."""

from __future__ import annotations

import torch

# optax.adamw's default weight decay; torch.optim.AdamW's default is 1e-2
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


def adamw(params, lr: float) -> torch.optim.AdamW:
    """`optax.adamw(lr)` in torch: b1 0.9, b2 0.999 and eps 1e-8 are both
    libraries' defaults; the weight decay is optax's 1e-4, decoupled as in
    optax (p -= lr * (adam update + wd * p))."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)


def prepare_adamw_for_graph(opt: torch.optim.AdamW) -> None:
    """Ready `opt` for a step traced into one graph (`adamw_update` under
    `torch.compile`): each parameter's state made as `AdamW.step` first
    makes it (step 0, zero moments), before any trace, so that no trace
    creates state; on the card `capturable` set, which keeps the step count
    on the device (the update then reads no host scalar and a CUDA graph
    can replay it), and the state's tensors marked static for CUDA graphs."""
    for group in opt.param_groups:
        on_card = all(p.is_cuda for p in group['params'])
        if on_card:
            group['capturable'] = True
        for p in group['params']:
            state = opt.state[p]
            if not state:
                state['step'] = torch.zeros((), dtype=torch.float32, device=p.device if on_card else 'cpu')
                state['exp_avg'] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state['exp_avg_sq'] = torch.zeros_like(p, memory_format=torch.preserve_format)
            elif on_card and not state['step'].is_cuda:
                state['step'] = state['step'].to(p.device)
            if on_card:
                for t in state.values():
                    torch._dynamo.mark_static_address(t)


def adamw_update(opt: torch.optim.AdamW, grads, *, foreach: bool | None = None) -> None:
    """`opt.step()` with `grads` in place of the parameters' `.grad`: one
    gradient (or None) per parameter, in the order of `opt.param_groups`.
    It calls `torch.optim.adam.adam`, the update `AdamW.step` itself calls,
    on the optimizer's own state and settings, without the graph breaks
    that `Optimizer.step` places around itself, so that `torch.compile`
    takes a forward, its backward and this update as one graph (JAX's
    `nnx.jit` step). Call `prepare_adamw_for_graph(opt)` first. `foreach`,
    where given, overrides the groups' setting."""
    from torch.optim.adam import adam

    grads = list(grads)
    at = 0
    with torch.no_grad():
        for group in opt.param_groups:
            params, gs, exp_avgs, exp_avg_sqs, steps = [], [], [], [], []
            for p in group['params']:
                g = grads[at]
                at += 1
                if g is None:
                    continue
                state = opt.state[p]
                params.append(p)
                gs.append(g)
                exp_avgs.append(state['exp_avg'])
                exp_avg_sqs.append(state['exp_avg_sq'])
                steps.append(state['step'])
            if not params:
                continue
            beta1, beta2 = group['betas']
            adam(params, gs, exp_avgs, exp_avg_sqs, [], steps,
                 foreach=group['foreach'] if foreach is None else foreach, capturable=group['capturable'],
                 differentiable=group['differentiable'], fused=group['fused'], has_complex=False,
                 decoupled_weight_decay=group['decoupled_weight_decay'], amsgrad=group['amsgrad'],
                 beta1=beta1, beta2=beta2, lr=group['lr'], weight_decay=group['weight_decay'], eps=group['eps'],
                 maximize=group['maximize'])
    if at != len(grads):
        raise ValueError(f'{len(grads)} gradients for {at} parameters')


def sgd_update(opt: torch.optim.SGD, grads, *, foreach: bool | None = None) -> None:
    """`opt.step()` with `grads` in place of the parameters' `.grad` (one
    gradient or None per parameter, in the order of `opt.param_groups`):
    `torch.optim.sgd.sgd`, the update `SGD.step` calls, on the optimizer's
    own settings and momentum buffers, without `Optimizer.step`'s graph
    breaks; `foreach`, where given, overrides the groups' setting."""
    from torch.optim.sgd import sgd

    grads = list(grads)
    at = 0
    with torch.no_grad():
        for group in opt.param_groups:
            params, gs, buffers = [], [], []
            for p in group['params']:
                g = grads[at]
                at += 1
                if g is None:
                    continue
                params.append(p)
                gs.append(g)
                if group['momentum'] != 0:
                    buffers.append(opt.state[p].get('momentum_buffer'))
            if not params:
                continue
            sgd(params, gs, buffers, weight_decay=group['weight_decay'], momentum=group['momentum'],
                lr=group['lr'], dampening=group['dampening'], nesterov=group['nesterov'],
                maximize=group['maximize'], foreach=group['foreach'] if foreach is None else foreach,
                fused=group['fused'])
            if group['momentum'] != 0:
                for p, buffer in zip(params, buffers):
                    opt.state[p]['momentum_buffer'] = buffer
    if at != len(grads):
        raise ValueError(f'{len(grads)} gradients for {at} parameters')


def optimizer_update(opt: torch.optim.Optimizer, grads, *, foreach: bool | None = None) -> None:
    """`opt.step()` with `grads` in place of the parameters' `.grad`, which
    are left as they were: SGD by `sgd_update`, Adam and AdamW (without
    amsgrad) by `adamw_update` (their state made first, outside any trace),
    both of which `torch.compile` traces (`foreach` passed on); any other
    optimizer by its own `step()` on the gradients swapped into `.grad`
    (which breaks a compiled graph)."""
    grads = list(grads)
    if isinstance(opt, torch.optim.SGD):
        sgd_update(opt, grads, foreach=foreach)
        return
    if isinstance(opt, torch.optim.Adam) and not any(g['amsgrad'] for g in opt.param_groups):
        if not torch.compiler.is_compiling():
            prepare_adamw_for_graph(opt)
        adamw_update(opt, grads, foreach=foreach)
        return
    params = [p for group in opt.param_groups for p in group['params']]
    if len(params) != len(grads):
        raise ValueError(f'{len(grads)} gradients for {len(params)} parameters')
    outer = [p.grad for p in params]
    for p, g in zip(params, grads):
        p.grad = g
    try:
        opt.step()
    finally:
        for p, g in zip(params, outer):
            p.grad = g
