"""The port's entry points (counterpart of __graft_entry__.py).

entry(device=None) -> (fn, example_args): a forward of the flagship model
(a conv autoencoder with a VectorQuantize bottleneck) as a function of its
state, `fn(state, x) -> (recon, indices, commit_loss)`.

dryrun_multichip(n_devices, backend='nccl', device=None): one rank a
process (`parallel.run_ranks`), each running the JAX package's dryrun
sections in its order: a data-parallel training step of the autoencoder
whose EMA codebook must stay bit-identical on every rank, the
tensor-parallel selection and the row-sharded bf16 tier, a 2D (data x code)
EMA step of the sharded_vq engine, a VectorQuantize with 65,536 row-sharded
codes under TensorParallelTrainer, a data-parallel step of BASELINE config
5 (GroupedResidualVQ into SimVQ with rotation-trick gradients), a
code-sharded ResidualVQ step and group-parallel GroupedResidualVQ against
the serial loop. NCCL puts one rank on each card; gloo must be asked for,
and lets the ranks share one card or run on the CPU (`device='cpu'`). The
dryrun's models are built on the CPU and moved to the rank's device, and
its ranks compute in full f32, so a run on the card draws the same random
numbers as one on the CPU and can be held to it.

    python -c "from vqtpu_torch.entry import dryrun_multichip; dryrun_multichip(4, backend='gloo', device='cpu')"
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .composite.residual_vq import GroupedResidualVQ, ResidualVQ
from .core.optim import adamw
from .core.utils import resolve_device
from .kernels.distance import nearest_code, quantize_lookup
from .kernels.train_fused import code_sums, fused_train_quantize
from .models.autoencoder import SimpleQuantizeAutoEncoder
from .parallel import (
    DataParallelTrainer, TensorParallelTrainer, collectives, global_batch, group_parallel_forward,
    group_parallel_output_from_indices, init_sharded_codebook, make_mesh, run_ranks, sharded_ema_update,
    sharded_nearest_code, sharded_quantize, sharded_quantize_lookup_bf16,
)
from .quantizers.sim_vq import SimVQ
from .quantizers.vq import VectorQuantize

# __graft_entry__.py:18-32 and :45
FLAGSHIP_VQ = dict(dim=32, codebook_size=256, decay=0.8, commitment_weight=1.0)
ENTRY_INPUT = (8, 28, 28, 1)
# the torch seed of every model built here
SEED = 0
# the kernel wrappers whose launches a dryrun rank reports
KERNELS = dict(nearest_code=nearest_code, train_fused=fused_train_quantize, code_sums=code_sums)


def build_flagship(device=None) -> SimpleQuantizeAutoEncoder:
    """SimpleQuantizeAutoEncoder(VectorQuantize(dim=32, codebook_size=256,
    decay=0.8, commitment_weight=1.0), dim=32), its weights from torch seed
    SEED, on `device` (the card when None)."""
    device = resolve_device(device)
    torch.manual_seed(SEED)
    return SimpleQuantizeAutoEncoder(VectorQuantize(**FLAGSHIP_VQ, device=device), dim=32, device=device)


def entry(device=None):
    """(fn, (state, x)): `fn(state, x) -> (recon, indices, commit_loss)`,
    the flagship's training forward (the JAX model is in training mode too)
    as a pure function of its state; `state` is the model's state_dict (a
    copy) and `x` zeros of shape (8, 28, 28, 1), NHWC, both on `device`
    (the card when None, where the forward runs the fused train kernel
    once).

    As `nnx.merge(graphdef, state)` leaves the JAX state, the call runs on
    copies of the state's tensors (the EMA update writes into the copies;
    gradients flow to the originals). The forward draws nothing from the
    model's random streams (no kmeans init, no expiry, no stochastic
    codes), so `fn` leaves their states (`rng_state`) as they were and
    compiles whole, as `jax.jit(fn)` does:

        fn, (state, x) = entry()
        recon, indices, commit_loss = torch.compile(fn, fullgraph=True)(state, x)
    """
    device = resolve_device(device)
    model = build_flagship(device=device).train()

    def forward(state, x):
        recon, indices, commit_loss = torch.func.functional_call(
            model, {k: v.clone() for k, v in state.items()}, (x,))
        return recon, indices, commit_loss

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return forward, (state, torch.zeros(ENTRY_INPUT, device=device))


# -- the dryrun's models (__graft_entry__.py:177-193, 221-239, 267-279) ------------


def recon_plus_aux(model, batch):
    out, aux = model(batch)
    return ((out - batch) ** 2).mean() + aux


class TPModel(nn.Module):
    """Linear -> VectorQuantize(65,536 codes sharded over 'code', kmeans
    init, dead-code expiry) -> Linear."""

    def __init__(self, device=None):
        super().__init__()
        self.enc = nn.Linear(8, 32, device=device)
        self.vq = VectorQuantize(dim=32, codebook_size=65536, sync_axis='data', code_axis='code', kmeans_init=True,
                                 threshold_ema_dead_code=0.5, device=device)
        self.dec = nn.Linear(32, 8, device=device)

    def forward(self, x):
        q, _, commit = self.vq(self.enc(x))
        return self.dec(q), commit


class Config5Model(nn.Module):
    """BASELINE config 5: GroupedResidualVQ with EMA codebooks synced over
    'data', then SimVQ with rotation-trick gradients, between two Linears."""

    def __init__(self, device=None):
        super().__init__()
        self.enc = nn.Linear(8, 16, device=device)
        self.grvq = GroupedResidualVQ(dim=16, groups=2, num_quantizers=2, codebook_size=32, sync_axis='data',
                                      device=device)
        self.sim = SimVQ(dim=16, codebook_size=32, rotation_trick=True, device=device)
        self.dec = nn.Linear(16, 8, device=device)

    def forward(self, x):
        q, _, losses = self.grvq(self.enc(x))
        q2, _, sim_loss = self.sim(q)
        return self.dec(q2), losses.sum() + sim_loss


class TPRVQModel(nn.Module):
    """Linear -> ResidualVQ(2 layers of `codebook_size` codes sharded over
    'code', synced over 'data') -> Linear."""

    def __init__(self, codebook_size: int, device=None):
        super().__init__()
        self.enc = nn.Linear(8, 16, device=device)
        self.rvq = ResidualVQ(dim=16, num_quantizers=2, codebook_size=codebook_size, sync_axis='data',
                              code_axis='code', device=device)
        self.dec = nn.Linear(16, 8, device=device)

    def forward(self, x):
        q, _, losses = self.rvq(self.enc(x))
        return self.dec(q), losses.sum()


# -- the dryrun's sections, each run by every rank ----------------------------------


def built_on_cpu(build, device) -> nn.Module:
    """`build('cpu')` under torch seed SEED, moved to `device`: the same
    weights, and random streams that draw the same numbers, on every
    device."""
    torch.manual_seed(SEED)
    return build('cpu').to(device)


def held(module: nn.Module) -> dict:
    """What a training section leaves, on the CPU, to be held to another
    run's: `module`'s buffers (the codebooks and their statistics) and the
    gradients of its last step (the parameters after a first AdamW step
    carry little more than the gradients' signs)."""
    out = {k: v.detach().cpu() for k, v in module.named_buffers()}
    out.update({f'{k}.grad': p.grad.cpu() for k, p in module.named_parameters() if p.grad is not None})
    return out


def _normal(shape, seed: int, device) -> torch.Tensor:
    """N(0, 1) of `shape` from a CPU generator seeded `seed` (the same values
    on every device), on `device`."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)


def replicas_identical(t: torch.Tensor, mesh, axis: str) -> bool:
    """Whether every rank of this rank's `axis` group holds `t` bit for bit."""
    with mesh, torch.no_grad():
        stacked = collectives.all_gather(t.detach().contiguous()[None], axis)
    return all(torch.equal(stacked[0], s) for s in stacked[1:])


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dp_autoencoder_step(mesh, device) -> tuple[float, dict]:
    """One DataParallelTrainer step (AdamW 3e-4) of the autoencoder around
    VectorQuantize(dim=32, codebook_size=64, decay=0.8, sync_axis='data',
    threshold_ema_dead_code=2) on this rank's 2 of 2 x world zero images;
    the codebook must be bit-identical on every rank afterwards. The loss
    and the model's state after the step."""
    model = built_on_cpu(lambda dev: SimpleQuantizeAutoEncoder(
        VectorQuantize(dim=32, codebook_size=64, decay=0.8, sync_axis='data', threshold_ema_dead_code=2,
                       device=dev),
        dim=32, device=dev), device)

    def loss_fn(m, batch):
        recon, _, commit = m(batch)
        return (recon.clamp(-1, 1) - batch).abs().mean() + 10.0 * commit

    # eager, as the dryrun's other sections run
    trainer = DataParallelTrainer(model, adamw(model.parameters(), 3e-4), loss_fn, mesh, compiled=False)
    batch = global_batch(mesh, ('data',), torch.zeros(2 * mesh.size('data'), 28, 28, 1), device)
    loss = float(trainer.step(batch))
    _check(math.isfinite(loss), f'dp train loss {loss}')
    _check(replicas_identical(model.quantizer._codebook.embed, mesh, 'data'), 'codebook replicas diverged')
    return loss, held(model)


def tp_argmin_and_bf16(code_mesh, device) -> dict:
    """The row-sharded selection of 16 tokens against 8 codes a rank, equal
    to the unsharded selection, and the row-sharded bf16 tier, bit-identical
    to the unsharded tier; their indices and the tier's rows."""
    world, index = code_mesh.size('code'), code_mesh.index('code')
    x, embed = _normal((16, 32), 0, device), _normal((8 * world, 32), 1, device)
    shard = embed[8 * index:8 * (index + 1)].contiguous()
    with code_mesh:
        idx = sharded_nearest_code(x, shard, 'code')
        idx_tp, q_tp = sharded_quantize_lookup_bf16(x, shard, 'code')
    _check(idx.shape == (16,), f'sharded argmin shape {tuple(idx.shape)}')
    _check(torch.equal(idx, nearest_code(x, embed)), 'sharded argmin diverged from the unsharded selection')
    idx_ref, q_ref = quantize_lookup(x, embed, tier='bf16')
    _check(torch.equal(idx_tp, idx_ref), 'sharded bf16 tier indices diverged from the unsharded tier')
    _check(torch.equal(q_tp, q_ref), 'sharded bf16 tier rows diverged from the unsharded tier')
    return dict(indices=idx.cpu(), bf16_indices=idx_tp.cpu(), bf16_rows=q_tp.cpu())


def sharded_ema_step(mesh2d, device) -> dict:
    """One sharded_quantize + sharded_ema_update step of the sharded_vq
    engine on the (data, code) mesh: 8 x world codes over 'code', 4 x world
    tokens over 'data'; the indices, rows and the rank's codebook state."""
    world = math.prod(mesh2d.shape)
    c_local = 8 * world // mesh2d.size('code')
    row0 = mesh2d.index('code') * c_local
    state = init_sharded_codebook(_normal((8 * world, 32), 2, device)[row0:row0 + c_local].clone())
    xs = global_batch(mesh2d, ('data',), _normal((4 * world, 32), 3, device), device)
    with mesh2d:
        idx, q = sharded_quantize(xs, state.embed, 'code')
        state = sharded_ema_update(state, xs, idx, code_axis='code', data_axis='data', decay=0.9)
    _check(bool(torch.isfinite(q).all() and torch.isfinite(state.embed).all()), 'sharded EMA step is not finite')
    return dict(indices=idx.cpu(), rows=q.cpu(), embed=state.embed.cpu(), cluster_size=state.cluster_size.cpu(),
                embed_avg=state.embed_avg.cpu())


def tp_vq_steps(mesh2d, device) -> tuple[float, dict]:
    """Two TensorParallelTrainer steps (AdamW 3e-4) of TPModel on this
    rank's block of 4 x world x (4, 8) tokens; kmeans must have run. The
    second step's loss and the state after it (this rank's rows)."""
    world = math.prod(mesh2d.shape)
    model = built_on_cpu(TPModel, device)
    # eager, as the dryrun's other sections run
    trainer = TensorParallelTrainer(model, adamw(model.parameters(), 3e-4), recon_plus_aux, mesh2d, compiled=False)
    batch = global_batch(mesh2d, ('data',), _normal((4 * world, 4, 8), 4, device), device)
    trainer.step(batch)
    loss = float(trainer.step(batch))
    _check(math.isfinite(loss), f'code_axis VectorQuantize loss {loss}')
    _check(bool(model.vq._codebook.initted), 'kmeans did not initialize the sharded codebook')
    return loss, held(model)


def config5_step(model: Config5Model, mesh, batch: torch.Tensor) -> tuple[float, dict]:
    """One DataParallelTrainer step (AdamW 3e-4) of config 5 on this rank's
    `batch`; each group's first codebook must be bit-identical on every
    rank afterwards. The loss and the model's state after the step."""
    trainer = DataParallelTrainer(model, adamw(model.parameters(), 3e-4), recon_plus_aux, mesh, compiled=False)
    loss = float(trainer.step(batch))
    _check(math.isfinite(loss), f'config-5 loss {loss}')
    for g, rvq in enumerate(model.grvq.rvqs):
        _check(replicas_identical(rvq.layers[0]._codebook.embed, mesh, 'data'),
               f'group-{g} codebook replicas diverged')
    return loss, held(model)


def rvq_tp_step(model: TPRVQModel, mesh2d, batch: torch.Tensor) -> tuple[float, dict]:
    """One TensorParallelTrainer step (AdamW 3e-4) of the code-sharded
    ResidualVQ on this rank's `batch` (sharding the model's codebooks). The
    loss and the state after the step (this rank's rows)."""
    trainer = TensorParallelTrainer(model, adamw(model.parameters(), 3e-4), recon_plus_aux, mesh2d, compiled=False)
    loss = float(trainer.step(batch))
    _check(math.isfinite(loss), f'code-sharded ResidualVQ loss {loss}')
    return loss, held(model)


def group_parallel_sections(gp_mesh, world: int, device) -> dict:
    """GroupedResidualVQ(dim=16, groups=g, num_quantizers=2, codebook_size=32)
    in training, g = 2 for an even world and 1 for an odd one: the groups
    over 'group' (each data row of the mesh runs JAX's g-device group mesh
    on the whole input) give the serial loop's indices, and the parallel
    decode is finite; for an even world, the same with the batch over
    'data' and the codebooks synced over it. The indices and the decode."""
    g = gp_mesh.size('group')
    serial, par, par2 = (built_on_cpu(lambda dev: GroupedResidualVQ(
        dim=16, groups=g, num_quantizers=2, codebook_size=32, sync_axis=sync, device=dev), device).train()
        for sync in (None, None, 'data'))
    x = _normal((4, 8, 16), 7, device)
    # eager, as the dryrun's other sections run
    with torch.no_grad():
        _, ind_s, _ = serial(x)
        _, ind_p, _ = group_parallel_forward(par, x, gp_mesh, compiled=False)
        _check(torch.equal(ind_s, ind_p), 'group-parallel indices diverged from the serial loop')
        dec = group_parallel_output_from_indices(par, ind_p, gp_mesh, compiled=False)
        _check(bool(torch.isfinite(dec).all()), 'group-parallel decode is not finite')
        if world % 2 == 0:
            _, ind2, _ = group_parallel_forward(par2, global_batch(gp_mesh, ('data',), x, device), gp_mesh,
                                                data_axis='data', compiled=False)
            with gp_mesh:
                ind2 = collectives.all_gather(ind2.contiguous(), 'data', concat_axis=1)
            _check(torch.equal(ind2, ind_s), '2D data x group indices diverged from the serial loop')
    return dict(indices=ind_p.cpu(), decoded=dec.cpu())


def dryrun_rank(rank: int, world: int, mesh, device: str) -> dict:
    """One rank of dryrun_multichip on the ('data',) mesh of every rank:
    the sections in the JAX package's order (those that need an even world
    are skipped for an odd one, as there), the rank's losses, what each
    section left (`held`: states, indices, rows, on the CPU) and its
    launches of each kernel wrapper per section."""
    device = torch.device(device)
    if device.type == 'cuda':
        # full f32, as on the CPU (cuDNN's convolutions default to TF32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    even = world % 2 == 0
    for f in KERNELS.values():
        f.launches = 0
    launches, losses, outputs = {}, {}, {}

    def done(section, out):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        outputs[section] = out
        launches[section] = {k: f.launches for k, f in KERNELS.items()}
        for f in KERNELS.values():
            f.launches = 0

    losses['dp_loss'], out = dp_autoencoder_step(mesh, device)
    done('dp_autoencoder', out)
    done('tp_argmin_bf16', tp_argmin_and_bf16(make_mesh(('code',)), device))
    mesh2d = make_mesh(('data', 'code'), (2, world // 2)) if even else None
    losses['tp_loss'] = losses['rvq_tp_loss'] = None
    if even:
        done('sharded_ema_2d', sharded_ema_step(mesh2d, device))
        losses['tp_loss'], out = tp_vq_steps(mesh2d, device)
        done('tp_vq_65536', out)
    c5 = built_on_cpu(Config5Model, device)
    batch = global_batch(mesh, ('data',), _normal((2 * world, 4, 8), 5, device), device)
    losses['config5_loss'], out = config5_step(c5, mesh, batch)
    done('config5', out)
    if even:
        rvq = built_on_cpu(lambda dev: TPRVQModel(16 * world, dev), device)
        batch = global_batch(mesh2d, ('data',), _normal((4 * world, 4, 8), 6, device), device)
        losses['rvq_tp_loss'], out = rvq_tp_step(rvq, mesh2d, batch)
        done('rvq_tp', out)
    g = 2 if even else 1
    done('group_parallel', group_parallel_sections(make_mesh(('data', 'group'), (world // g, g)), world, device))
    return dict(rank=rank, device=str(device), losses=losses, held=outputs, launches=launches)


def dryrun_multichip(n_devices: int, backend: str = 'nccl', device=None) -> dict:
    """Run the dryrun on `n_devices` ranks, one process each
    (`parallel.run_ranks`): over NCCL one rank a card (`n_devices` at most
    the cards there are), over gloo ranks that share the cards or, with
    `device='cpu'`, run on the CPU. Prints the JAX package's summary line
    and returns the losses (the rank-mean each trainer returns, so every
    rank's), the sections skipped for an odd `n_devices` (None losses),
    and, per rank, what each section left and its kernel launches. Raises
    if any rank fails or does not finish within run_ranks' timeout."""
    device = resolve_device(device)
    if device.type == 'cuda':
        from .kernels import _build
        _build.build(['nearest_code', 'train_fused'])    # once, before the ranks load them
    ranks = run_ranks(dryrun_rank, n_devices, backend=backend, device=device)
    losses = ranks[0]['losses']
    for r in ranks[1:]:
        _check(r['losses'] == losses, f"rank {r['rank']} reports other losses: {r['losses']} vs {losses}")
    skipped = [] if n_devices % 2 == 0 else ['sharded_ema_2d', 'tp_vq_65536', 'rvq_tp', 'group_parallel_2d']
    tp_msg = f"{losses['tp_loss']:.4f}" if losses['tp_loss'] is not None else 'skipped (odd n)'
    rvq_msg = f"{losses['rvq_tp_loss']:.4f}" if losses['rvq_tp_loss'] is not None else 'skipped (odd n)'
    summary = (
        f"dryrun_multichip({n_devices}) ok: dp train loss={losses['dp_loss']:.4f} "
        f'(codebook bit-identical on {n_devices} replicas), tp argmin ok, '
        f'2d data x code EMA step ok, '
        f'code_axis VectorQuantize end-to-end loss={tp_msg}, '
        f"config-5 GroupedResidualVQ+SimVQ dp loss={losses['config5_loss']:.4f} "
        f'(group codebooks bit-identical), '
        f'code-sharded ResidualVQ loss={rvq_msg}, '
        f'group-axis GroupedResidualVQ indices == serial'
    )
    print(summary, flush=True)
    return dict(losses, n_devices=n_devices, backend=backend, skipped=skipped, summary=summary,
                devices=[r['device'] for r in ranks], held=[r['held'] for r in ranks],
                launches=[r['launches'] for r in ranks])


if __name__ == '__main__':
    fn, args = entry()
    out = torch.compile(fn, fullgraph=True)(*args)
    print('entry ok:', [tuple(t.shape) for t in out])
    dryrun_multichip(min(8, torch.cuda.device_count()))
