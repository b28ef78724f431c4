"""Spawned gloo worlds for the port's data-parallel tests, and the bodies
their ranks run. Imports torch and vqtpu_torch only: each rank is a fresh
`spawn` process, which would otherwise pay for importing JAX.

`run_world(body, tmp_path, **kwargs)` starts `world` processes, each of
which joins a gloo process group through a rendezvous file in `tmp_path`
(never a fixed port: the suite runs in several worker processes at once),
builds the mesh `('data',)`, calls `body(rank, world, mesh, **kwargs)` and
pickles what it returns. Every join has a timeout, so a hung rank fails
the test instead of holding the suite. Results are numpy arrays.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT_S = 120


def run_world(body, tmp_path, world: int = 2, timeout: float = JOIN_TIMEOUT_S, **kwargs) -> list:
    """[body's result on rank r for r in range(world)]."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=_rank_main, args=(body, r, world, str(tmp_path), kwargs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f'ranks {hung} did not finish within {timeout} s'
    errors = [(tmp_path / f'rank{r}.err').read_text() for r, p in enumerate(procs) if p.exitcode != 0]
    assert not errors, '\n'.join(errors)
    results = []
    for r in range(world):
        with open(tmp_path / f'rank{r}.pkl', 'rb') as f:
            results.append(pickle.load(f))      # written by this test's own ranks
    return results


def _rank_main(body, rank, world, tmp, kwargs):
    import torch.distributed as dist

    from vqtpu_torch.parallel import init_multihost, make_mesh

    try:
        torch.set_num_threads(1)
        init_multihost(f'file://{tmp}/rendezvous', world, rank, backend='gloo', timeout=timedelta(seconds=60))
        try:
            out = body(rank, world, make_mesh(('data',)), **kwargs)
        finally:
            dist.destroy_process_group()
        with open(Path(tmp) / f'rank{rank}.pkl', 'wb') as f:
            pickle.dump(out, f)
    except BaseException:
        (Path(tmp) / f'rank{rank}.err').write_text(f'rank {rank}:\n{traceback.format_exc()}')
        sys.exit(1)


def shard(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank `rank`'s block of `a` along dim 0."""
    step = a.shape[0] // world
    return a[rank * step:(rank + 1) * step]


def np_tree(t):
    """Tensors (in dicts, lists and tuples) -> numpy arrays."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(np_tree(v) for v in t)
    return t


# -- injected draws -------------------------------------------------------------


def inject_rows(tables: dict):
    """Replace the port's row draws (kmeans' candidates, the pool's pick,
    dead-code expiry's candidates) by rows taken from `tables['now']`, a
    dict {number of rows drawn from: indices}: the same indices for every
    head, wherever the draw comes from. Returns the function that undoes
    it."""
    import vqtpu_torch.codebook.codebook as tcodebook
    import vqtpu_torch.codebook.kmeans as tkmeans

    def rows(n):
        return torch.from_numpy(tables['now'][n])

    saved = (tkmeans.sample_means, tkmeans.masked_sample_vectors, tcodebook.masked_sample_vectors)
    tkmeans.sample_means = lambda gen, s, mask, num: s[:, rows(s.shape[1])]
    tkmeans.masked_sample_vectors = tcodebook.masked_sample_vectors = lambda gen, s, mask, num: s[rows(s.shape[0])]

    def undo():
        tkmeans.sample_means, tkmeans.masked_sample_vectors, tcodebook.masked_sample_vectors = saved
    return undo


def vq_state(vq) -> dict:
    cb = vq._codebook
    return {k: getattr(cb, k).detach().clone() for k in ('embed', 'embed_avg', 'cluster_size')}


def vq_steps(vq, xs, gs, step_tables, mesh=None):
    """Training steps of a VectorQuantize on (x, g) pairs, the draws of step
    s taken from `step_tables[s]` (`inject_rows`): each the forward, then
    the backward of sum(q * g) + loss. Per step: the codebook the selection
    used, q, indices, loss, x.grad and the state after it."""
    import vqtpu_torch.codebook.codebook as tcodebook

    init = tcodebook.Codebook.init_embed_
    used = {}

    def recording_init(self, flatten, mask=None):
        init(self, flatten, mask)
        used['embed'] = self.embed.detach().clone()
    tcodebook.Codebook.init_embed_ = recording_init
    tables = {}
    undo = inject_rows(tables)
    out = []
    try:
        for s, (x, g) in enumerate(zip(xs, gs)):
            tables['now'] = step_tables[s]
            used['embed'] = vq._codebook.embed.detach().clone()
            tx = torch.from_numpy(x).requires_grad_()
            if mesh is None:
                q, idx, loss = vq(tx)
            else:
                with mesh:
                    q, idx, loss = vq(tx)
            ((q * torch.from_numpy(g)).sum() + loss).backward()
            out.append(dict(embed_used=used['embed'], q=q, idx=idx, loss=loss, x_grad=tx.grad, **vq_state(vq)))
    finally:
        undo()
        tcodebook.Codebook.init_embed_ = init
    return np_tree(out)


# -- rank bodies ----------------------------------------------------------------


def vq_dp_body(rank, world, mesh, *, kwargs, state, xs, gs, step_tables):
    """VectorQuantize(sync_axis='data') from the JAX state, steps on this
    rank's shards."""
    import vqtpu_torch
    from vqtpu_torch import load_vqtpu_state

    vq = vqtpu_torch.VectorQuantize(**kwargs, sync_axis='data', device='cpu').train()
    load_vqtpu_state(vq, state)
    xs = [shard(x, rank, world) for x in xs]
    gs = [shard(g, rank, world) for g in gs]
    return vq_steps(vq, xs, gs, step_tables, mesh)


def lfq_dp_body(rank, world, mesh, *, kwargs, state, x, inv_temps):
    """One LFQ(sync_axis='data') training forward on this rank's shard per
    inverse temperature: the aux loss, its gradient with respect to x and
    the indices."""
    import vqtpu_torch
    from vqtpu_torch import load_vqtpu_state

    lfq = vqtpu_torch.LFQ(**kwargs, sync_axis='data', device='cpu').train()
    load_vqtpu_state(lfq, state)
    out = []
    for inv_temp in inv_temps:
        tx = torch.from_numpy(shard(x, rank, world)).requires_grad_()
        with mesh:
            _, idx, aux = lfq(tx, inv_temperature=inv_temp)
            aux.backward()
        out.append(np_tree(dict(aux=aux, x_grad=tx.grad, idx=idx)))
    return out


def fsp_dp_body(rank, world, mesh, *, kwargs, state, x):
    """FSP(sync_axis='data') forward on this rank's shard: the moment loss,
    the moments and the gradient of the loss with respect to x."""
    import vqtpu_torch
    from vqtpu_torch import load_vqtpu_state

    fsp = vqtpu_torch.FSP(**kwargs, sync_axis='data', device='cpu').train()
    load_vqtpu_state(fsp, state)
    tx = torch.from_numpy(shard(x, rank, world)).requires_grad_()
    with mesh:
        _, _, loss, info = fsp(tx)
        loss.backward()
    return np_tree(dict(loss=loss, x_grad=tx.grad, **info['norm_info']))


class DPModel(torch.nn.Module):
    """Linear -> VectorQuantize(sync_axis) -> Linear, the model of the JAX
    package's data-parallel trainer test."""

    def __init__(self, sync_axis='data', **vq_kwargs):
        import vqtpu_torch
        super().__init__()
        self.enc = torch.nn.Linear(8, 16)
        self.vq = vqtpu_torch.VectorQuantize(dim=16, codebook_size=32, sync_axis=sync_axis, device='cpu',
                                             **vq_kwargs)
        self.dec = torch.nn.Linear(16, 8)

    def forward(self, x):
        q, _, commit = self.vq(self.enc(x))
        return self.dec(q), commit


def dp_model_loss(model, batch):
    out, commit = model(batch)
    return ((out - batch) ** 2).mean() + commit


def trainer_body(rank, world, mesh, *, x, steps, seed=0, vq_kwargs=None):
    """DataParallelTrainer over DPModel with Adam(1e-2) on this rank's
    shard: the losses, the parameters and the codebook state at the end,
    and whether `eval_step_fn` gives the model's eval outputs."""
    from vqtpu_torch.parallel import DataParallelTrainer, eval_step_fn, global_batch, is_multiprocess

    torch.manual_seed(seed)
    model = DPModel(**(vq_kwargs or {}))
    trainer = DataParallelTrainer(model, torch.optim.Adam(model.parameters(), lr=1e-2), dp_model_loss, mesh)
    local = global_batch(mesh, ('data',), x, device='cpu')
    losses = [trainer.step(local) for _ in range(steps)]
    model.eval()
    out, _ = eval_step_fn(model, mesh)(local)
    with torch.no_grad():
        eval_matches = bool(torch.equal(out, model(local)[0]))
    return np_tree(dict(losses=torch.stack(losses), params=dict(model.named_parameters()),
                        eval_matches=eval_matches, multiprocess=is_multiprocess(), **vq_state(model.vq)))


def collectives_body(rank, world, mesh):
    """The gradient contracts of the collectives: each rank's gradient of a
    loss built from its own and the gathered or summed values."""
    from vqtpu_torch.parallel import collectives as c

    w = torch.arange(world * 2, dtype=torch.float32) + 1.0
    mine = slice(rank * 2, rank * 2 + 2)
    out = {}
    with mesh:
        x = torch.full((1, 2), float(rank + 1), requires_grad=True)
        # all_gather_exact: a replicated loss of the gathered value; each
        # rank's block takes its own slice of w, unscaled
        (c.all_gather_exact(x, 'data').reshape(-1) * w).sum().backward()
        out['all_gather_exact'] = x.grad
        # all_gather: the transpose sums the cotangent first (psum_scatter)
        x = torch.full((1, 2), float(rank + 1), requires_grad=True)
        (c.all_gather(x, 'data').reshape(-1) * w).sum().backward()
        out['all_gather'] = x.grad
        out['all_gather_value'] = c.all_gather(x.detach(), 'data')
        out['all_gather_stacked'] = c.all_gather(x.detach(), 'data', tiled=False, concat_axis=1)
        # psum: the forward sums, the backward sums the cotangent
        v = torch.full((2,), float(rank + 1), requires_grad=True)
        s = c.psum(v, 'data')
        out['psum_value'] = s.detach()
        (s * w[mine]).sum().backward()
        out['psum'] = v.grad
        # psum_exact: the backward is the identity
        v = torch.full((2,), float(rank + 1), requires_grad=True)
        (c.psum_exact(v, 'data') * w[mine]).sum().backward()
        out['psum_exact'] = v.grad
        # psum_in_bwd: a replicated operand, each rank using its own slice
        v = torch.zeros(world * 2, requires_grad=True)
        (c.psum_in_bwd(v, 'data')[mine] * w[mine]).sum().backward()
        out['psum_in_bwd'] = v.grad
        # pmean: psum / world both ways
        v = torch.full((2,), float(rank + 1), requires_grad=True)
        m = c.pmean(v, 'data')
        out['pmean_value'] = m.detach()
        (m * w[mine]).sum().backward()
        out['pmean'] = v.grad
        out['axis_size'] = c.axis_size('data')
        out['axis_index'] = c.axis_index('data')
        out['bound'] = c.axis_is_bound('data')
    out['bound_after'] = c.axis_is_bound('data')
    return np_tree(out)


def composites_body(rank, world, mesh, *, x, x_img):
    """One training step of each composite with sync_axis='data' on this
    rank's shard, from the same seed on every rank: the inner quantizers'
    sync_axis and their EMA state after the step."""
    import vqtpu_torch as vt

    builders = {
        'ResidualVQ': lambda: vt.ResidualVQ(dim=16, num_quantizers=2, codebook_size=16, sync_axis='data',
                                            device='cpu'),
        'GroupedResidualVQ': lambda: vt.GroupedResidualVQ(dim=16, groups=2, num_quantizers=2, codebook_size=16,
                                                          sync_axis='data', device='cpu'),
        'ResidualLFQ': lambda: vt.ResidualLFQ(dim=16, codebook_size=16, num_quantizers=2, sync_axis='data',
                                              device='cpu'),
        'GroupedResidualLFQ': lambda: vt.GroupedResidualLFQ(dim=16, groups=2, codebook_size=16, num_quantizers=2,
                                                            sync_axis='data', device='cpu'),
        'HierarchicalVQ': lambda: vt.HierarchicalVQ(dim=16, codebook_size=16, scales=(1, 2, 4), accept_image_fmap=True,
                                                    sync_axis='data', device='cpu'),
    }
    out = {}
    for name, build in builders.items():
        torch.manual_seed(0)
        model = build().train()
        inner = [m for m in model.modules() if isinstance(m, (vt.VectorQuantize, vt.LFQ))]
        xin = x_img if name == 'HierarchicalVQ' else x
        tx = torch.from_numpy(shard(xin, rank, world)).requires_grad_()
        with mesh:
            q, _, loss = model(tx)[:3]
            (q.sum() + loss.sum()).backward()
        codebooks = [m._codebook for m in model.modules() if isinstance(m, vt.VectorQuantize)]
        out[name] = dict(
            sync_axes=[m.sync_axis for m in inner],
            codebooks=[dict(embed=cb.embed, embed_avg=cb.embed_avg, cluster_size=cb.cluster_size)
                       for cb in codebooks],
            x_grad=tx.grad,
        )
    return np_tree(out)


def affine_inplace_body(rank, world, mesh, *, x, kwargs_list):
    """A training step of VectorQuantize per kwarg set, from the same seed
    on every rank, on this rank's shard: the codebook's state after it."""
    import vqtpu_torch

    out = []
    for kwargs in kwargs_list:
        torch.manual_seed(0)
        vq = vqtpu_torch.VectorQuantize(**kwargs, sync_axis='data', device='cpu').train()
        tx = torch.from_numpy(shard(x, rank, world))
        with mesh:
            vq(tx)
        out.append(np_tree({k: v for k, v in vq._codebook.state_dict().items()}))
    return out


def vq_dp_card_body(rank, world, mesh, *, steps, shape=(16, 256, 64), codes=128):
    """dp_vq_train at a small size on the card (tests/test_torch_cuda.py):
    VectorQuantize(sync_axis='data', train_fused='on') with kmeans init and
    expiry on this rank's half of a batch made on the card; per step this
    rank's K4 launches, whether the ranks' codebooks are bit-identical, and
    on rank 0 whether one process over the whole batch from the same state
    picks the same indices and cluster sizes."""
    import vqtpu_torch
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import collectives, global_batch

    torch.cuda.set_device(0)
    kwargs = dict(dim=shape[-1], codebook_size=codes, decay=0.8, train_fused='on', kmeans_init=True,
                  threshold_ema_dead_code=2, device='cuda')
    torch.manual_seed(0)
    vq = vqtpu_torch.VectorQuantize(**kwargs, sync_axis='data').train()
    out = []
    for s in range(steps):
        full = torch.randn(shape, generator=torch.Generator('cuda').manual_seed(s), device='cuda')
        before = {k: v.clone() for k, v in vq.state_dict().items()}
        fused_train_quantize.launches = 0
        with mesh:
            _, idx, _ = vq(global_batch(mesh, ('data',), full))
        torch.cuda.synchronize()
        step = dict(launches=fused_train_quantize.launches)
        with mesh:
            states = {k: collectives.all_gather(v[None], 'data') for k, v in vq_state(vq).items()}
            idx = collectives.all_gather(idx, 'data')
        step['identical'] = all(bool(torch.equal(v[0], v[1])) for v in states.values())
        if rank == 0 and s > 0:                  # step 0's kmeans draws from the pool
            one = vqtpu_torch.VectorQuantize(**kwargs).train()
            one.load_state_dict(before)
            _, one_idx, _ = one(full)
            step['one_process_indices'] = bool(torch.equal(idx, one_idx))
            step['one_process_cluster_size'] = bool(torch.equal(states['cluster_size'][0],
                                                                one._codebook.cluster_size))
        out.append(step)
    return out
