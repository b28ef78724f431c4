"""Gloo worlds on the CPU for the port's distributed tests, and the bodies
their ranks run. Imports torch and vqtpu_torch only: each rank is a fresh
interpreter, which would otherwise pay for importing JAX.

`run_world(body, **kwargs)` runs `body(rank, world, mesh, **kwargs)` on
`world` gloo ranks through vqtpu_torch.parallel.run_ranks (the mesh `axes`
of `shape`; `('data',)` over every rank by default), each rank on one
thread, and returns what each rank returned. Every join has a timeout, so
a hung rank fails the test instead of holding the suite. Results are numpy
arrays.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from vqtpu_torch.parallel import run_ranks

JOIN_TIMEOUT_S = 120


def run_world(body, world: int = 2, timeout: float = JOIN_TIMEOUT_S, axes=('data',), shape=None, **kwargs) -> list:
    """[body's result on rank r for r in range(world)]."""
    return run_ranks(_one_thread, world, backend='gloo', device='cpu', axes=axes, shape=shape, timeout=timeout,
                     kwargs=dict(body=body, body_kwargs=kwargs))


def _one_thread(rank, world, mesh, device, body, body_kwargs):
    torch.set_num_threads(1)
    return body(rank, world, mesh, **body_kwargs)


def shard(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank `rank`'s block of `a` along dim 0."""
    step = a.shape[0] // world
    return a[rank * step:(rank + 1) * step]


def np_tree(t):
    """Tensors (in dicts, lists and tuples) -> numpy arrays."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:       # numpy has no bfloat16; its values are exact in f32
            t = t.float()
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
    tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')

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


# -- row-sharded (tensor-parallel) codebooks ---------------------------------------


def inject_index_draws(tables: dict):
    """Replace the port's index draws (`masked_sample_indices`, which the
    unsharded row draws and the sharded windows both take) by
    `tables['now'][(n, num)]`: the same global index vector wherever the
    draw comes from. Returns the function that undoes it."""
    tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')
    import vqtpu_torch.core.sampling as tsampling

    def draw(generator, n, mask, num, device=None):
        return torch.from_numpy(tables['now'][(n, num)]).to(device)

    saved = (tsampling.masked_sample_indices, tkmeans.masked_sample_indices)
    tsampling.masked_sample_indices = tkmeans.masked_sample_indices = draw

    def undo():
        tsampling.masked_sample_indices, tkmeans.masked_sample_indices = saved
    return undo


def _build(case):
    """The module of a case: vqtpu_torch.<cls>(**kwargs) on the CPU from
    torch seed `seed`, loaded from a JAX state when the case has one."""
    import vqtpu_torch
    from vqtpu_torch import load_vqtpu_state

    torch.manual_seed(case.get('seed', 0))
    module = getattr(vqtpu_torch, case['cls'])(**case['kwargs'], device='cpu')
    if case.get('state') is not None:
        load_vqtpu_state(module, case['state'])
    return module.train(case.get('train', True))


def _forward(module, x, call):
    out = module(x, **call)
    return out if isinstance(out, tuple) else (out,)


def run_case(case, mesh=None, rank=0, data_world=1, data_index=0):
    """The steps of a case (each the forward on x, then with `gs` the
    backward of sum(q * g) + the loss's sum): per step its outputs, x.grad
    and, on one process, the first codebook's rows the selection used (after
    kmeans init where it ran); with `decode`, that method of the module on
    the step's indices (inside the mesh); at the end the full state, the
    parameters' gradients (a row shard's gathered over its axis, partial
    gradients psum'd) and, for a sharded run, whether every sharded leaf
    held its rank's rows. With a mesh the module's codebooks are sharded for
    the steps and gathered back after them, and the tokens are this data
    rank's block."""
    from contextlib import nullcontext

    import vqtpu_torch.codebook.codebook as tcodebook
    from vqtpu_torch.parallel import collectives
    from vqtpu_torch.parallel import tp as ttp

    module = _build(case)
    bound = nullcontext() if mesh is None else mesh
    codebooks = [m for m in module.modules() if isinstance(m, tcodebook.Codebook)]
    used = {}
    for cb in codebooks[:1]:
        init = cb.init_embed_

        def recording_init(flatten, mask=None, cb=cb, init=init):
            init(flatten, mask)
            used['embed'] = cb.embed.detach().clone()
        cb.init_embed_ = recording_init
    tables = {}
    undo = inject_index_draws(tables) if case.get('index_tables') else None
    sharded_rows = None
    steps = []
    try:
        if mesh is not None:
            ttp.shard_codebooks(module, mesh)
            sharded_rows = all(t.shape[dim] == m.codebook_size // mesh.size(m.code_axis)
                               for m, _, t, dim in ttp._leaves(module))
        for s, x in enumerate(case['xs']):
            if undo is not None:
                tables['now'] = case['index_tables'][s]
            x = shard(x, data_index, data_world)
            tx = torch.from_numpy(x).requires_grad_(case.get('gs') is not None)
            module.zero_grad(set_to_none=True)
            if codebooks and mesh is None:
                used['embed'] = codebooks[0].embed.detach().clone()
            with bound:
                out = _forward(module, tx, case.get('call', {}))
                if case.get('gs') is not None:
                    g = torch.from_numpy(shard(case['gs'][s], data_index, data_world))
                    total = (out[0] * g).sum() + sum(o.sum() for o in out[2:] if o.is_floating_point())
                    total.backward()
                decoded = None
                if case.get('decode'):
                    with torch.no_grad():
                        decoded = getattr(module, case['decode'])(out[1])
            steps.append(np_tree(dict(out=list(out), x_grad=tx.grad, decoded=decoded,
                                      embed_used=used.get('embed') if mesh is None else None)))
        grads = {}
        specs, axes = ttp.codebook_pspecs(module), ttp.codebook_axes(module)
        if mesh is not None and case.get('gs') is not None:
            with mesh:
                ttp.psum_partial_grads(module)
        for name, p in module.named_parameters():
            if p.grad is None:
                continue
            g = p.grad.detach()
            if mesh is not None and name in specs:
                with mesh:
                    g = collectives.all_gather_exact(g.contiguous(), axes[name], concat_axis=g.ndim - specs[name])
            grads[name] = g
        if mesh is not None:
            ttp.gather_codebooks(module, mesh)
    finally:
        if undo is not None:
            undo()
    return dict(steps=steps, state=np_tree(dict(module.state_dict())), grads=np_tree(grads),
                sharded_rows=sharded_rows)


def tp_cases_body(rank, world, mesh, *, cases):
    """Every case on this rank with the codebooks sharded over 'code' (and
    the tokens over 'data' when the mesh has it)."""
    data_world = mesh.size('data') if 'data' in mesh.axis_names else 1
    data_index = mesh.index('data') if 'data' in mesh.axis_names else 0
    return [run_case(case, mesh, rank, data_world, data_index) for case in cases]


class AEModel(torch.nn.Module):
    """Linear -> VectorQuantize(dim=32, codebook_size=256, **vq_kwargs) ->
    Linear, the model of the JAX package's tensor-parallel trainer tests."""

    def __init__(self, **vq_kwargs):
        import vqtpu_torch
        super().__init__()
        self.enc = torch.nn.Linear(8, 32)
        self.vq = vqtpu_torch.VectorQuantize(dim=32, codebook_size=256, device='cpu', **vq_kwargs)
        self.dec = torch.nn.Linear(32, 8)

    def forward(self, x):
        q, idx, commit = self.vq(self.enc(x))
        return self.dec(q), idx, commit


def ae_loss(model, batch):
    out, _, commit = model(batch)
    return ((out - batch) ** 2).mean() + commit


def _trainer(mesh, seed, optimizer=None, **vq_kwargs):
    from vqtpu_torch.parallel import TensorParallelTrainer
    torch.manual_seed(seed)
    model = AEModel(sync_axis='data', code_axis='code', **vq_kwargs)
    opt = (optimizer or (lambda p: torch.optim.Adam(p, lr=1e-2)))(model.parameters())
    return model, TensorParallelTrainer(model, opt, ae_loss, mesh)


def _engine_inputs(steps=20, n=64, c=32, d=16):
    """20 steps of n tokens around 8 centres, and the initial codebook."""
    g = np.random.default_rng(5)
    centres = g.standard_normal((8, d)).astype(np.float32) * 3
    xs = [(centres[g.integers(0, 8, n)] + 0.1 * g.standard_normal((n, d))).astype(np.float32) for _ in range(steps)]
    return xs, g.standard_normal((c, d)).astype(np.float32)


ENGINE_INPUTS = _engine_inputs()


def engine_run(mesh, data_world, data_index):
    """The sharded_vq engine over ENGINE_INPUTS on this rank: per step its
    global indices and the mean squared quantization error over the data
    axis; the state gathered over 'code' at the end."""
    from vqtpu_torch.parallel import collectives, init_sharded_codebook, sharded_ema_update, sharded_quantize
    xs, embed0 = ENGINE_INPUTS
    c_local = embed0.shape[0] // mesh.size('code')
    row0 = mesh.index('code') * c_local
    state = init_sharded_codebook(torch.from_numpy(embed0[row0:row0 + c_local]).clone())
    idxs, errors = [], []
    with mesh:
        for x in xs:
            xl = torch.from_numpy(shard(x, data_index, data_world))
            idx, q = sharded_quantize(xl, state.embed, 'code')
            state = sharded_ema_update(state, xl, idx, code_axis='code', data_axis='data', decay=0.9)
            idxs.append(idx)
            errors.append(float(collectives.pmean(((q - xl) ** 2).mean(), 'data')))
        full = {k: collectives.all_gather_exact(getattr(state, k).contiguous(), 'code')
                for k in ('embed', 'embed_avg', 'cluster_size')}
    return np_tree(dict(idx=idxs, errors=errors, state=full))


def tp_trainer_body(rank, world, mesh, *, xs, ckpt_dir, cases):
    """On a ('data', 'code') mesh: the cases (run_case, tokens over 'data');
    TensorParallelTrainer with kmeans init and expiry (losses, whether the
    data replicas of a code shard hold identical rows, the rows per rank);
    with a learnable codebook (losses, whether the rows moved, whether the
    optimizer's state holds the rank's rows); a checkpoint at step 3 of 5
    resumed by a fresh model (both trajectories); tp_apply's eval forward
    and decode on a model at rest."""
    from vqtpu_torch.parallel import collectives, gather_codebooks, global_batch, tp_apply
    from vqtpu_torch.utils import restore_checkpoint, save_checkpoint

    data_world, data_index = mesh.size('data'), mesh.index('data')
    out = dict(cases=[run_case(case, mesh, rank, data_world, data_index) for case in cases],
               engine=engine_run(mesh, data_world, data_index))

    def replicated(model):
        cb = model.vq._codebook
        with mesh:
            return all(bool(torch.equal(*collectives.all_gather(t.detach()[None], 'data')))
                       for t in (cb.embed, cb.embed_avg, cb.cluster_size))

    local = [global_batch(mesh, ('data',), x, device='cpu') for x in xs]
    model, trainer = _trainer(mesh, 0, kmeans_init=True, threshold_ema_dead_code=0.5)
    out['converge'] = dict(losses=[float(trainer.step(local[i % len(local)])) for i in range(15)],
                           replicated=replicated(model), rows=model.vq._codebook.embed.shape[-2],
                           initted=bool(model.vq._codebook.initted))

    model, trainer = _trainer(mesh, 0, learnable_codebook=True, ema_update=False)
    with mesh:
        before = collectives.all_gather_exact(model.vq._codebook.embed.detach().clone(), 'code', concat_axis=1)
    losses = [float(trainer.step(local[i % len(local)])) for i in range(10)]
    gather_codebooks(model, mesh)
    moments = [s for s in trainer.optimizer.state.values() if 'exp_avg' in s]
    out['learnable'] = dict(losses=losses, moved=not torch.equal(before, model.vq._codebook.embed),
                            moment_rows=sorted({tuple(s['exp_avg'].shape) for s in moments}))

    # a checkpoint of the sharded model at step 3, resumed by a fresh model:
    # SGD keeps no state, so the two trajectories must agree bit for bit
    def sgd(p):
        return torch.optim.SGD(p, lr=1e-2)
    model_a, trainer_a = _trainer(mesh, 0, sgd, kmeans_init=True, threshold_ema_dead_code=0.5)
    traj_a = [float(trainer_a.step(x)) for x in local[:3]]
    path = f'{ckpt_dir}/tp.pt'
    save_checkpoint(path, model_a, mesh=mesh)
    # a checkpoint persists no generator (as in the JAX package): B takes
    # A's expiry generator as it stood at the checkpoint
    generator = model_a.vq._codebook.generator.get_state()
    traj_a += [float(trainer_a.step(x)) for x in local[3:5]]
    torch.manual_seed(1)
    model_b = AEModel(sync_axis='data', code_axis='code', kmeans_init=True, threshold_ema_dead_code=0.5)
    restore_checkpoint(path, model_b)
    model_b.vq._codebook.generator.set_state(generator)
    from vqtpu_torch.parallel import TensorParallelTrainer
    trainer_b = TensorParallelTrainer(model_b, sgd(model_b.parameters()), ae_loss, mesh)
    traj_b = [float(trainer_b.step(x)) for x in local[3:5]]
    gather_codebooks(model_a, mesh)
    gather_codebooks(model_b, mesh)
    out['resume'] = dict(a=traj_a, b=traj_b, checkpoint_rows=torch.load(path)['vq._codebook.embed'].shape[-2],
                         state_equal=all(bool(torch.equal(v, model_b.state_dict()[k]))
                                         for k, v in model_a.state_dict().items()))

    torch.manual_seed(2)
    model = AEModel(sync_axis='data', code_axis='code').eval()

    def forward(m, z):
        q, idx, _ = m.vq(z)
        return q, idx, m.vq.get_output_from_indices(idx)

    with torch.no_grad():
        z = model.enc(local[0])
        q, idx, dec = tp_apply(model, mesh, forward, z)
        q1, idx1, _ = model.vq(z)
    out['decode'] = dict(round_trip=bool(torch.equal(q, dec)), equal_unsharded=bool(torch.equal(q, q1)
                                                                                    and torch.equal(idx, idx1)),
                         at_rest=model.vq._codebook.embed.shape[-2])
    return np_tree(out)


def unsharded_in_mesh_body(rank, world, mesh, *, cls, kwargs, x):
    """A code_axis module at rest (its leaves unsharded) run inside a mesh
    that binds the axis: the error it raises, or None."""
    import vqtpu_torch
    torch.manual_seed(0)
    module = getattr(vqtpu_torch, cls)(**kwargs, device='cpu')
    try:
        with mesh:
            module(torch.from_numpy(x))
    except ValueError as err:
        return str(err)
    return None


def code_axis_at_rest_raises_in_mesh(cls, **kwargs) -> list:
    """unsharded_in_mesh_body on two ('code',) ranks: each rank's message."""
    x = np.random.default_rng(0).standard_normal((2, 4, kwargs['dim']), dtype=np.float32)
    return run_world(unsharded_in_mesh_body, axes=('code',), cls=cls, kwargs=kwargs, x=x)


# -- group-parallel Grouped composites ----------------------------------------------


def gp_body(rank, world, mesh, *, cases):
    """Each case: twins of a Grouped composite from one torch seed (loaded
    from a JAX state when the case has one), the parallel one run through
    group_parallel_forward over `mesh_axes` (this world's ('group',) mesh
    of 4, or a ('data', 'group') (2, 2) mesh made here), the serial one
    called on the same (this data rank's) input; per step both outputs, and
    at the end both states, the parallel decode (group_parallel_output_from_indices)
    and the serial one."""
    import vqtpu_torch
    from vqtpu_torch import load_vqtpu_state
    from vqtpu_torch.parallel import group_parallel_forward, group_parallel_output_from_indices, make_mesh

    mesh_2d = make_mesh(('data', 'group'), (2, 2))
    out = []
    for case in cases:
        m = mesh if case.get('mesh') == 'group' else mesh_2d
        data_axis = case.get('data_axis')
        dw = m.size('data') if data_axis else 1
        di = m.index('data') if data_axis else 0
        twins = []
        for kwargs in (case['par_kwargs'], case['ser_kwargs']):
            torch.manual_seed(case.get('seed', 0))
            module = getattr(vqtpu_torch, case['cls'])(**kwargs, device='cpu')
            if case.get('state') is not None:
                load_vqtpu_state(module, case['state'])
            twins.append(module.train(case.get('train', True)))
        par, ser = twins
        steps = []
        for x in case['xs']:
            xl = torch.from_numpy(shard(x, di, dw))
            call = dict(case.get('call', {}))
            if 'mask' in case:
                call['mask'] = torch.from_numpy(shard(case['mask'], di, dw))
            if 'indices' in case:
                call['indices'] = tuple(torch.from_numpy(shard(i, di, dw)) for i in case['indices'])
            with torch.no_grad():
                got = group_parallel_forward(par, xl, m, group_axis='group', data_axis=data_axis, **call)
                want = ser(torch.from_numpy(x) if data_axis else xl, **call)
            steps.append(np_tree(dict(par=got, ser=want)))
        decoded = None
        if case.get('decode'):
            with torch.no_grad():
                idx = steps[-1]['par'][1]
                decoded = np_tree(dict(
                    par=group_parallel_output_from_indices(par, torch.from_numpy(idx), m, group_axis='group'),
                    ser=ser.get_output_from_indices(torch.from_numpy(idx))))
        out.append(dict(steps=steps, decoded=decoded, par_state=np_tree(dict(par.state_dict())),
                        ser_state=np_tree(dict(ser.state_dict()))))
    return out


def _state_copy(module) -> dict:
    """The module's state_dict as numpy copies (a view would follow the
    module's later in-place writes)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def gp_compile_case(mesh_1d, mesh_2d, case):
    """One case of tests/test_torch_gp_compile.py: three twins of a Grouped
    composite from one torch seed (loaded from a JAX state when the case has
    one): group_parallel_forward compiled (a recording aot_eager backend),
    the same eagerly, and the serial module, each called on each step's
    input (this data rank's block with `data_axis`; the serial one on the
    whole batch then; not on a step without `update_state`), each step
    with `update_state` as `case['update']` says (default True); with `gs`, the backward of sum(q * g) + the losses'
    sum into x. Per step each twin's outputs, x.grad and state after it, and
    the graphs the compiled call captured; the state before the first step;
    the decodes (the compiled one twice); the number of cached bodies. The
    eager twin passes `compiled=None`, which runs eagerly on the CPU."""
    import vqtpu_torch
    from vqtpu_torch import load_vqtpu_state
    from vqtpu_torch.parallel import group as tgroup
    from vqtpu_torch.parallel import group_parallel_forward, group_parallel_output_from_indices

    torch._dynamo.reset()
    tgroup._GP_CACHE.clear()
    graphs = []
    backend = recording_backend(graphs)
    m = mesh_1d if case.get('mesh') == 'group' else mesh_2d
    data_axis = case.get('data_axis')
    dw = m.size('data') if data_axis else 1
    di = m.index('data') if data_axis else 0
    twins = []
    for kwargs in (case['par_kwargs'], case['par_kwargs'], case['ser_kwargs']):
        torch.manual_seed(case.get('seed', 0))
        module = getattr(vqtpu_torch, case['cls'])(**kwargs, device='cpu')
        if case.get('state') is not None:
            load_vqtpu_state(module, case['state'])
        twins.append(module.train(case.get('train', True)))
    comp, eager, ser = twins
    before = _state_copy(comp)
    steps = []
    for s, x in enumerate(case['xs']):
        call = dict(case.get('call', {}))
        if 'mask' in case:
            call['mask'] = torch.from_numpy(shard(case['mask'], di, dw))
        if 'indices' in case:
            call['indices'] = tuple(torch.from_numpy(shard(i, di, dw)) for i in case['indices'])
        update = case.get('update', [True] * len(case['xs']))[s]
        step = dict(graphs=[])
        for name, module in (('compiled', comp), ('eager', eager), ('ser', ser)):
            if name == 'ser' and not update:
                continue                    # the serial module always writes its state
            grad = case.get('gs') is not None
            xin = torch.from_numpy(x if name == 'ser' and data_axis else shard(x, di, dw)).requires_grad_(grad)
            n = len(graphs)
            with torch.set_grad_enabled(grad):
                if name == 'ser':
                    out = module(xin, **call)
                else:
                    out = group_parallel_forward(module, xin, m, group_axis='group', data_axis=data_axis,
                                                 update_state=update, backend=backend,
                                                 compiled=True if name == 'compiled' else None, **call)
            if grad:
                g = torch.from_numpy(case['gs'][s])
                (out[0] * g).sum().add(sum(o.sum() for o in out[2:] if o.is_floating_point())).backward()
            step[name] = np_tree(dict(out=out, x_grad=xin.grad, state=_state_copy(module)))
            step['graphs'] += [graph_ops(gm) for gm in graphs[n:]]
        steps.append(step)
    decoded = None
    if case.get('decode'):
        idx = torch.from_numpy(steps[-1]['compiled']['out'][1])
        with torch.no_grad():
            calls = [group_parallel_output_from_indices(comp, idx, m, group_axis='group', compiled=True,
                                                        backend=backend) for _ in range(2)]
            eager_decode = group_parallel_output_from_indices(eager, idx, m, group_axis='group')
            decoded = np_tree(dict(compiled=calls, eager=eager_decode, ser=ser.get_output_from_indices(idx)))
    out = dict(steps=steps, decoded=decoded, before=before, n_graphs=len(graphs), cached=len(tgroup._GP_CACHE))
    torch._dynamo.reset()
    return out


def gp_many_keys(mesh, kwargs, x):
    """More cache keys than Dynamo's `recompile_limit` in one process,
    without a reset: GroupedResidualFSQ(**kwargs) in eval on the ('group',)
    mesh, group_parallel_forward compiled with recompile_limit + 1 backends
    (each a recording aot_eager of its own, so each call is a key of its
    own), against its eager call. Per key whether the outputs equal, and
    the graphs each cached body holds."""
    import vqtpu_torch
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from vqtpu_torch.parallel import group as tgroup
    from vqtpu_torch.parallel import group_parallel_forward

    torch._dynamo.reset()
    tgroup._GP_CACHE.clear()
    torch.manual_seed(0)
    module = vqtpu_torch.GroupedResidualFSQ(**kwargs, device='cpu').eval()
    x = torch.from_numpy(x)
    with torch.no_grad():
        want = group_parallel_forward(module, x, mesh, group_axis='group')
        equal = []
        for _ in range(torch._dynamo.config.recompile_limit + 1):
            got = group_parallel_forward(module, x, mesh, group_axis='group', compiled=True,
                                         backend=recording_backend([]))
            equal.append(all(bool(torch.equal(a, b)) for a, b in zip(got, want)))
    graphs = [len(_debug_get_cache_entry_list(body.__wrapped__.__code__)) for body in tgroup._GP_CACHE.values()]
    torch._dynamo.reset()
    return dict(equal=equal, graphs=graphs)


def gp_compile_body(rank, world, mesh, *, cases, many_keys):
    """Every case of tests/test_torch_gp_compile.py (gp_compile_case) in one
    world of four ranks: on its ('group',) mesh of 4 or on a ('data',
    'group') (2, 2) mesh made here; then gp_many_keys(**many_keys)."""
    from vqtpu_torch.parallel import make_mesh

    mesh_2d = make_mesh(('data', 'group'), (2, 2))
    return [gp_compile_case(mesh, mesh_2d, case) for case in cases] + [gp_many_keys(mesh, **many_keys)]


def tp_eval_decode(m, z):
    """An eval forward and the decode of its indices, for tp_apply."""
    with torch.no_grad():
        q, idx, _ = m(z)
        return q, idx, m.get_output_from_indices(idx)


def tp_decode(m, idx):
    """The decode of `idx`, for tp_apply."""
    with torch.no_grad():
        return m.get_output_from_indices(idx)


def tp_train_forward(m, z):
    """A training forward without gradients (the EMA update), for tp_apply."""
    with torch.no_grad():
        return m(z)


def compiled_tp_apply(rank, world, mesh, *, state, xs):
    """tp_apply on this rank's block over 'data' of each global batch of
    `xs`, compiled (a recording aot_eager backend) and eagerly (`compiled=None`
    on the CPU), over twins
    of VectorQuantize(dim=32, codebook_size=256, sync_axis='data',
    code_axis='code') loaded from a JAX state at rest: the eval forward and
    decode on each batch (`eval`: both outputs, the graphs a call captured,
    the cached bodies); a mutating training forward on the first batch
    (`mutating`: both outputs and states after the call, gathered back); a
    non-mutating one (`restore`: its output and the state before and
    after); the decode with more keys than Dynamo's recompile_limit in one
    process (`many_keys`: each call equal to eager's, each body's
    graphs)."""
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from vqtpu_torch import VectorQuantize, load_vqtpu_state
    from vqtpu_torch.parallel import tp as ttp
    from vqtpu_torch.parallel import tp_apply

    torch._dynamo.reset()
    ttp._TP_APPLY_CACHE.clear()
    graphs = []
    backend = recording_backend(graphs)

    def build(train):
        torch.manual_seed(0)
        m = VectorQuantize(dim=32, codebook_size=256, sync_axis='data', code_axis='code', device='cpu')
        load_vqtpu_state(m, state)
        return m.train(train)

    local = [torch.from_numpy(shard(x, mesh.index('data'), mesh.size('data'))) for x in xs]
    mc, me = build(False), build(False)
    calls = []
    for z in local:
        n = len(graphs)
        got = tp_apply(mc, mesh, tp_eval_decode, z, compiled=True, backend=backend)
        calls.append(dict(compiled=got, eager=tp_apply(me, mesh, tp_eval_decode, z),
                          graphs=[graph_ops(gm) for gm in graphs[n:]]))
    out = dict(eval=dict(calls=calls, cached=len(ttp._TP_APPLY_CACHE), rows_at_rest=mc._codebook.embed.shape[-2]))
    mc, me = build(True), build(True)
    n = len(graphs)
    got = tp_apply(mc, mesh, tp_train_forward, local[0], mutates_state=True, compiled=True, backend=backend)
    out['mutating'] = dict(compiled=got, graphs=[graph_ops(gm) for gm in graphs[n:]],
                           eager=tp_apply(me, mesh, tp_train_forward, local[0], mutates_state=True),
                           state_compiled=dict(mc.state_dict()), state_eager=dict(me.state_dict()))
    mc = build(True)
    before = {k: v.clone() for k, v in mc.state_dict().items()}
    got = tp_apply(mc, mesh, tp_train_forward, local[0], compiled=True, backend=backend)
    out['restore'] = dict(out=got, before=before, after=dict(mc.state_dict()))
    # more keys than Dynamo's recompile_limit without a reset: the decode
    # with recompile_limit + 1 backends, each a key of its own
    mc, me = build(False), build(False)
    idx = out['eval']['calls'][0]['eager'][1]
    want = tp_apply(me, mesh, tp_decode, idx)
    ttp._TP_APPLY_CACHE.clear()
    equal = [bool(torch.equal(tp_apply(mc, mesh, tp_decode, idx, compiled=True, backend=recording_backend([])), want))
             for _ in range(torch._dynamo.config.recompile_limit + 1)]
    out['many_keys'] = dict(equal=equal, graphs=[len(_debug_get_cache_entry_list(body.__wrapped__.__code__))
                                                 for body in ttp._TP_APPLY_CACHE.values()])
    torch._dynamo.reset()
    return np_tree(out)


def tp_apply_card_body(rank, world, mesh, *, shape=(4, 256, 64), codes=1024):
    """tp_apply of a row-sharded VectorQuantize's eval forward and decode on
    the card, eagerly and compiled (its default there), and once more
    compiled on another batch: each call's K1 launches and outputs, whether
    the compiled calls equal the eager one and the unsharded eval, whether
    the module is as before, and the graphs Dynamo holds of the body."""
    from torch._dynamo.eval_frame import _debug_get_cache_entry_list
    from vqtpu_torch import VectorQuantize
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.parallel import tp as ttp
    from vqtpu_torch.parallel import tp_apply

    torch._dynamo.reset()
    ttp._TP_APPLY_CACHE.clear()
    torch.manual_seed(0)
    vq = VectorQuantize(dim=shape[-1], codebook_size=codes, code_axis='code', device='cuda').eval()
    x = torch.randn(shape, device='cuda')
    before = {k: v.clone() for k, v in vq.state_dict().items()}
    out, launches = {}, {}
    for mode, compiled, batch in (('eager', False, x), ('compiled', None, x), ('again', None, x + 1)):
        nearest_code.launches = 0
        out[mode] = tp_apply(vq, mesh, tp_eval_decode, batch, compiled=compiled)
        torch.cuda.synchronize()
        launches[mode] = nearest_code.launches
    with torch.no_grad():
        q1, idx1, _ = vq(x)
        q2, idx2, _ = vq(x + 1)
    frames = sum(len(_debug_get_cache_entry_list(body.__wrapped__.__code__)) for body in ttp._TP_APPLY_CACHE.values())
    return dict(launches=launches, frames=frames,
                compiled_equal=all(bool(torch.equal(a, b)) for a, b in zip(out['compiled'], out['eager'])),
                unsharded_equal=bool(torch.equal(out['compiled'][0], q1) and torch.equal(out['compiled'][1], idx1)
                                     and torch.equal(out['again'][0], q2) and torch.equal(out['again'][1], idx2)),
                decode_equal=bool(torch.equal(out['compiled'][2], out['compiled'][0])),
                unchanged=all(torch.equal(v, before[k]) for k, v in vq.state_dict().items()))


def gp_card_body(rank, world, mesh, *, shape=(4, 256, 64)):
    """group_parallel_forward on the card, compiled (its default there)
    against the eager call and the serial module, from one seed:
    GroupedResidualVQ(dim=64, groups=2, num_quantizers=2, codebook_size=128,
    train_fused='on') in eval, then a training call with update_state=False
    (F4), then an 'on' step; GroupedResidualFSQ(dim=8, groups=2) in eval;
    the decodes. Each call's launches of K1, K4 and K9, and the
    comparisons."""
    import vqtpu_torch
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.residual_fsq_fused import fused_residual_fsq_eval
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import group_parallel_forward, group_parallel_output_from_indices

    torch._dynamo.reset()

    def triplet(cls, **kw):
        mods = []
        for _ in range(3):
            torch.manual_seed(0)
            mods.append(getattr(vqtpu_torch, cls)(**kw, device='cuda'))
        return mods

    def run(fn, *args, **kwargs):
        nearest_code.launches = fused_train_quantize.launches = fused_residual_fsq_eval.launches = 0
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return result, (nearest_code.launches, fused_train_quantize.launches, fused_residual_fsq_eval.launches)

    def equal(a, b):
        return all(bool(torch.equal(u, v)) for u, v in zip(a, b))

    out = {}
    par, parc, ser = triplet('GroupedResidualVQ', dim=shape[-1], groups=2, num_quantizers=2, codebook_size=128,
                             train_fused='on')
    torch.manual_seed(1)
    x = torch.randn(shape, device='cuda')
    with torch.no_grad():
        for m in (par, parc, ser):
            m.eval()
        eager, out['vq_eval_launches'] = run(group_parallel_forward, par, x, mesh, compiled=False)
        got, out['vq_eval_compiled_launches'] = run(group_parallel_forward, parc, x, mesh)
        out['vq_eval_equal'] = equal(got[:2], eager[:2]) and equal(got[:2], ser(x)[:2])
        dec, _ = run(group_parallel_output_from_indices, parc, got[1], mesh)
        out['vq_decode_equal'] = bool(torch.equal(dec, got[0]))
    for m in (par, parc, ser):
        m.train()
    before = {k: v.clone() for k, v in parc.state_dict().items()}
    kept, out['vq_kept_launches'] = run(group_parallel_forward, parc, x, mesh, update_state=False)
    out['vq_kept_unchanged'] = all(torch.equal(v, before[k]) for k, v in parc.state_dict().items())
    eager, out['vq_train_launches'] = run(group_parallel_forward, par, x, mesh, compiled=False)
    got, out['vq_train_compiled_launches'] = run(group_parallel_forward, parc, x, mesh)
    qs, is_, ls = ser(x)
    out['vq_train_indices_equal'] = bool(torch.equal(got[1], eager[1]) and torch.equal(eager[1], is_))
    out['vq_kept_equals_step'] = equal(kept, got)
    out['vq_train_rows_rel_err'] = float((got[0] - eager[0]).abs().max() / eager[0].abs().max())
    out['vq_train_loss_rel_err'] = float((got[2] - eager[2]).abs().max() / eager[2].abs().max())
    sc, se = parc.state_dict(), par.state_dict()
    out['vq_train_state_rel_err'] = max(float((sc[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                                        for k, v in se.items() if v.is_floating_point())
    par, parc, ser = triplet('GroupedResidualFSQ', dim=8, groups=2, levels=[8, 5, 5, 5], num_quantizers=2)
    x = torch.randn(shape[0], shape[1], 8, device='cuda')
    with torch.no_grad():
        for m in (par, parc, ser):
            m.eval()
        eager, out['fsq_eval_launches'] = run(group_parallel_forward, par, x, mesh, compiled=False)
        got, out['fsq_eval_compiled_launches'] = run(group_parallel_forward, parc, x, mesh)
        out['fsq_eval_equal'] = equal(got, eager) and equal(got, ser(x))
        dec, _ = run(group_parallel_output_from_indices, parc, got[1], mesh)
        want = ser.get_output_from_indices(got[1])
        out['fsq_decode_rel_err'] = float((dec - want).abs().max() / want.abs().max())
    return out


def tp_card_body(rank, world, mesh, *, shape=(16, 256, 64), codes=1024):
    """tp_vq_train at a small size on the card (tests/test_torch_cuda.py):
    VectorQuantize(code_axis='code') with expiry, three steps sharded over
    'code' with this rank's K1 and code_sums launches per step, then the
    eval forward through tp_apply against the gathered module at rest;
    then TensorParallelTrainer's compiled step against its eager twin
    (tp_compiled_card_steps)."""
    import vqtpu_torch
    from vqtpu_torch.kernels.distance import nearest_code
    from vqtpu_torch.kernels.train_fused import code_sums
    from vqtpu_torch.parallel import gather_codebooks, shard_codebooks, tp_apply

    torch.cuda.set_device(0)
    torch.manual_seed(0)
    vq = vqtpu_torch.VectorQuantize(dim=shape[-1], codebook_size=codes, code_axis='code', threshold_ema_dead_code=2,
                                    device='cuda').train()
    shard_codebooks(vq, mesh)
    launches = []
    for s in range(3):
        x = torch.randn(shape, generator=torch.Generator('cuda').manual_seed(s), device='cuda')
        nearest_code.launches = code_sums.launches = 0
        with mesh, torch.no_grad():
            vq(x)
        torch.cuda.synchronize()
        launches.append(dict(nearest_code=nearest_code.launches, code_sums=code_sums.launches))
    gather_codebooks(vq, mesh)
    vq.eval()
    x = torch.randn(shape, generator=torch.Generator('cuda').manual_seed(9), device='cuda')
    with torch.no_grad():
        q, idx, _ = tp_apply(vq, mesh, lambda m, t: m(t), x)
        q1, idx1, _ = vq(x)
    return dict(launches=launches, eval_equal=bool(torch.equal(q, q1) and torch.equal(idx, idx1)),
                compiled_steps=tp_compiled_card_steps(mesh, shape, codes))


def tp_compiled_card_steps(mesh, shape, codes, steps=2):
    """TensorParallelTrainer (data_axis=None) over GainVQ(code_axis='code',
    kmeans init, expiry), SGD, its step compiled on the card (compiled=
    None) against an eager twin, each step from the twin's state (copied
    in place): per step the compiled step's K1 and code_sums launches on
    this rank, the float64 verdict on its indices against eager's (the
    whole codebook the selection used, gathered over 'code'), and the
    largest error of the loss, the gain and this rank's codebook rows
    against eager over the codes no flipped token touched."""
    from vqtpu_torch.kernels.distance import nearest_code, selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import code_sums
    from vqtpu_torch.parallel import TensorParallelTrainer, collectives

    torch._dynamo.reset()
    device = 'cuda'
    kw = dict(dim=shape[-1], codebook_size=codes, kmeans_init=True, threshold_ema_dead_code=2, code_axis='code')
    torch.manual_seed(0)
    eager, compiled = GainVQ(device, **kw).train(), GainVQ(device, **kw).train()
    compiled.load_state_dict(eager.state_dict())
    picked = {}

    def loss_fn(m, batch):
        q, idx, loss = m(batch)
        picked['idx'] = idx
        return loss + q.square().mean()

    te = TensorParallelTrainer(eager, torch.optim.SGD(eager.parameters(), lr=1e-3), loss_fn, mesh, None,
                               compiled=False)
    tc = TensorParallelTrainer(compiled, torch.optim.SGD(compiled.parameters(), lr=1e-3), loss_fn, mesh, None)
    cb = eager.vq._codebook
    c_local = cb.embed.shape[-2]
    row0 = mesh.index('code') * c_local
    init, used = cb.init_embed_, {}

    def init_and_record(flatten, mask=None):
        init(flatten, mask)
        used['embed'] = cb.embed[0].detach().clone()
    cb.init_embed_ = init_and_record
    out = []
    for s in range(steps):
        with torch.no_grad():
            for k, v in compiled.state_dict().items():
                v.copy_(eager.state_dict()[k])
        x = torch.randn(shape, generator=torch.Generator(device).manual_seed(s), device=device)
        used['embed'] = cb.embed[0].detach().clone()
        x_in = (x * eager.gain).detach().reshape(-1, shape[-1])
        loss_e = te.step(x)
        idx_e = picked['idx'].reshape(-1)
        nearest_code.launches = code_sums.launches = 0
        loss_c = tc.step(x)
        torch.cuda.synchronize()
        launches = dict(nearest_code=nearest_code.launches, code_sums=code_sums.launches)
        idx_c = picked['idx'].reshape(-1)
        with mesh:
            embed = collectives.all_gather_exact(used['embed'].contiguous(), 'code')
        ties = selection_disagreements(x_in, embed, selection_bias(embed, 'euclidean'), idx_c, idx_e)
        flipped = idx_c != idx_e
        touched = torch.cat([idx_c[flipped], idx_e[flipped]]).long() - row0
        keep = torch.ones(c_local, dtype=torch.bool, device=device)
        keep[touched[(touched >= 0) & (touched < c_local)]] = False
        errs = {'loss': (loss_c - loss_e).abs() / loss_e.abs(), 'gain': (compiled.gain - eager.gain).abs()}
        for k in ('embed', 'embed_avg', 'cluster_size'):
            a, b = getattr(compiled.vq._codebook, k)[:, keep], getattr(cb, k)[:, keep]
            errs[k] = (a - b).abs().max() / b.abs().max()
        out.append(dict(launches=launches, compiled=tc.compiled, ties=ties,
                        errors={k: float(v) for k, v in errs.items()}))
    torch._dynamo.reset()
    return out


def examples_body(rank, world, mesh, *, tp_kwargs, gp_kwargs):
    """vqtpu_torch.examples' two distributed examples on this world: the
    tensor-parallel trainer on `mesh` ('data', 'code'), then the
    group-parallel GroupedResidualVQ on a ('group',) mesh of every rank.
    The trainer's synthetic images are 512 here, not 8192, to keep it short."""
    import vqtpu_torch.models.data as tdata
    from vqtpu_torch.examples import group_parallel_grvq, tp_large_codebook
    from vqtpu_torch.parallel import make_mesh
    full = tdata._synthetic_images
    tdata._synthetic_images = lambda num=8192, size=28, seed=0: full(512, size, seed)
    tp = tp_large_codebook.run(mesh, device='cpu', **tp_kwargs)
    gp = group_parallel_grvq.run(make_mesh(('group',)), device='cpu', **gp_kwargs)
    return dict(tp=tp, gp=gp)


def gp_example_card_body(rank, world, mesh):
    """vqtpu_torch.examples.group_parallel_grvq on the card at small widths,
    as it runs there by default (its group-parallel calls compiled)."""
    from vqtpu_torch.examples import group_parallel_grvq
    return group_parallel_grvq.run(mesh, steps=2, groups=2, dim=16, num_quantizers=2, codes=32, tokens=256,
                                   device='cuda')


# -- the entry points' dryrun (vqtpu_torch.entry) and its launcher --------------------


def echo_body(rank, world, mesh, device):
    """A rank of vqtpu_torch.parallel.run_ranks that reports where it ran."""
    return dict(rank=rank, world=world, axes=mesh.axis_names, size=mesh.size('data'), device=device)


def failing_body(rank, world, mesh, device):
    """A rank body whose rank 1 raises."""
    if rank == 1:
        raise ValueError('rank 1 fails on purpose')
    return rank


def _codebooks(model) -> list:
    import vqtpu_torch.codebook.codebook as tcodebook
    return [np_tree(dict(embed=m.embed, embed_avg=m.embed_avg, cluster_size=m.cluster_size))
            for m in model.modules() if isinstance(m, tcodebook.Codebook)]


def entry_sections_body(rank, world, mesh, *, c5_state, c5_batch, rvq_state, rvq_batch):
    """vqtpu_torch.entry's config-5 DP step on this world's ('data',) mesh
    and its code-sharded ResidualVQ TP step on a (2, 2) ('data', 'code')
    mesh, each from a JAX state: the loss, every codebook and the whole
    state after the step (the ResidualVQ's gathered back to full rows)."""
    from vqtpu_torch import load_vqtpu_state
    from vqtpu_torch.entry import Config5Model, TPRVQModel, config5_step, rvq_tp_step
    from vqtpu_torch.parallel import gather_codebooks, make_mesh

    c5 = Config5Model('cpu')
    load_vqtpu_state(c5, c5_state)
    c5_loss, _ = config5_step(c5, mesh, torch.from_numpy(shard(c5_batch, rank, world)))
    mesh2d = make_mesh(('data', 'code'), (2, world // 2))
    rvq = TPRVQModel(16 * world, 'cpu')
    load_vqtpu_state(rvq, rvq_state)
    rvq_loss, _ = rvq_tp_step(rvq, mesh2d, torch.from_numpy(shard(rvq_batch, mesh2d.index('data'), 2)))
    gather_codebooks(rvq, mesh2d)
    return dict(c5_loss=c5_loss, c5_codebooks=_codebooks(c5), c5_state=np_tree(c5.state_dict()),
                rvq_loss=rvq_loss, rvq_codebooks=_codebooks(rvq), rvq_state=np_tree(rvq.state_dict()))


# -- the compiled data-parallel step (DataParallelTrainer(compiled=True)) -----------


def recording_backend(graphs: list):
    """aot_eager that keeps each captured graph (forward and backward) in
    `graphs`."""
    from torch._dynamo.backends.common import aot_autograd

    def record(gm, example_inputs):
        graphs.append(gm)
        return gm.forward
    return aot_autograd(fw_compiler=record, bw_compiler=record)


def graph_ops(gm) -> dict:
    """{'namespace::op': [shape of the first operand, per call]} of the
    collectives, the vqtpu ops and argmax in a captured graph."""
    out = {}
    for n in gm.graph.nodes:
        if n.op != 'call_function' or not isinstance(n.target, torch._ops.OpOverload):
            continue
        name = f'{n.target.namespace}::{n.target._opname}'
        if n.target.namespace in ('_c10d_functional', 'vqtpu') or name == 'aten::argmax':
            first = n.args[0] if n.args else None
            val = first.meta.get('val') if isinstance(first, torch.fx.Node) else None
            out.setdefault(name, []).append(tuple(val.shape) if isinstance(val, torch.Tensor) else None)
    return out


# the collectives of vqtpu_torch.parallel.collectives, each as a function of
# a (4,) tensor that returns a (4,) tensor
COLLECTIVE_CASES = ('psum', 'psum_exact', 'psum_in_bwd', 'pmean', 'all_gather', 'all_gather_by_sum',
                    'all_gather_exact', 'pmax', 'pmin', 'axis_size', 'axis_index', 'axis_is_bound')


def _collective_case(name):
    from vqtpu_torch.parallel import collectives as c
    return {
        'psum': lambda x: c.psum(x, 'data'),
        'psum_exact': lambda x: c.psum_exact(x, 'data'),
        'psum_in_bwd': lambda x: c.psum_in_bwd(x, 'data'),
        'pmean': lambda x: c.pmean(x, 'data'),
        # stacked on a new axis, then every rank's first half: each rank's
        # cotangent reaches the other rank's block too
        'all_gather': lambda x: c.all_gather(x.reshape(2, 2), 'data', tiled=False, concat_axis=1).reshape(-1)[:4],
        # the same gather as a psum of blocks among zeros (a compiled graph's
        # form over gloo on the card)
        'all_gather_by_sum': lambda x: c._AllGather.apply(x.reshape(2, 2), c.group('data'), 1, False, True,
                                                          True).reshape(-1)[:4],
        'all_gather_exact': lambda x: c.all_gather_exact(x, 'data')[2:6],
        'pmax': lambda x: c.pmax(x, 'data') * x,
        'pmin': lambda x: c.pmin(x, 'data') * x,
        'axis_size': lambda x: x * c.axis_size('data'),
        'axis_index': lambda x: x + c.axis_index('data'),
        'axis_is_bound': lambda x: x * (2.0 if c.axis_is_bound('data') else 3.0),
    }[name]


def compiled_collectives(rank, world, mesh):
    """Each collective eager and compiled (fullgraph) on this rank's (4,)
    input: the value and the gradient of a weighted sum in both, the
    collectives of the captured forward and backward graphs, and what an
    unbound axis raises, compiled."""
    from vqtpu_torch.core.compile import compile_step

    w = torch.arange(4, dtype=torch.float32) + 1.0
    out = {}
    for name in COLLECTIVE_CASES:
        fn = _collective_case(name)
        res = {}
        for mode in ('eager', 'compiled'):
            torch._dynamo.reset()
            graphs = []
            run = fn if mode == 'eager' else torch.compile(fn, backend=recording_backend(graphs), fullgraph=True)
            x = (torch.arange(4, dtype=torch.float32) + 1.0 + 10.0 * rank).requires_grad_()
            with mesh:
                y = run(x)
                (y * w).sum().backward()
            res[mode] = dict(value=y.detach(), grad=x.grad)
            if mode == 'compiled':
                res['graphs'] = [graph_ops(gm) for gm in graphs]
        torch._dynamo.reset()
        try:
            compile_step(fn, backend='aot_eager')(torch.ones(4))
            res['unbound'] = None
        except NameError as e:
            res['unbound'] = f'NameError: {e}'
        out[name] = np_tree(res)
    torch._dynamo.reset()
    return out


class GainVQ(torch.nn.Module):
    """A scalar gain before a VectorQuantize (chip_smoke.py's dp_vq_train
    model): the trainer's one parameter."""

    def __init__(self, device='cpu', **vq_kwargs):
        import vqtpu_torch
        super().__init__()
        self.gain = torch.nn.Parameter(torch.ones((), device=device))
        self.vq = vqtpu_torch.VectorQuantize(**vq_kwargs, device=device)

    def forward(self, x):
        return self.vq(x * self.gain)


def _state(model, opt) -> dict:
    out = {f'model.{k}': v.detach().clone() for k, v in model.state_dict().items()}
    for i, p in enumerate(p for g in opt.param_groups for p in g['params']):
        out.update({f'opt.{i}.{k}': v.detach().clone() for k, v in opt.state[p].items()})
    return out


def _twins(build, make_opt, loss_fn, mesh, backend, trainer=None):
    """A model compiled under `trainer(compiled=True)` (DataParallelTrainer
    by default) and its eager twin from the same state (the compiled one
    loaded from the twin at rest), each with its own optimizer."""
    from vqtpu_torch.parallel import DataParallelTrainer

    trainer = trainer or DataParallelTrainer
    eager = build()
    compiled = build()
    compiled.load_state_dict(eager.state_dict())
    opt_e, opt_c = make_opt(eager), make_opt(compiled)
    return (compiled, trainer(compiled, opt_c, loss_fn, mesh, compiled=True, backend=backend), opt_c,
            eager, trainer(eager, opt_e, loss_fn, mesh, compiled=False), opt_e)


def compiled_vq_steps(rank, world, mesh, *, kwargs, xs):
    """The compiled trainer over GainVQ(sync_axis='data', **kwargs) and its
    eager twin, Adam(1e-2), a step per global batch in `xs` on this rank's
    shard: per step both losses, indices and states (model and Adam), the
    quantizer's input and the codebook its selection used, and the graphs
    the compiled trainer captured in it."""
    torch._dynamo.reset()
    torch.manual_seed(0)
    graphs = []
    picked = {}

    def loss_fn(m, batch):
        q, idx, loss = m(batch)
        picked['idx'] = idx
        return loss + q.square().mean()

    mc, tc, oc, me, te, oe = _twins(lambda: GainVQ(**kwargs, sync_axis='data').train(),
                                    lambda m: torch.optim.Adam(m.parameters(), lr=1e-2), loss_fn, mesh,
                                    recording_backend(graphs))
    used = {}
    cb = me.vq._codebook
    init = cb.init_embed_

    def init_and_record(flatten, mask=None):
        init(flatten, mask)
        used['embed'] = cb.embed.detach().clone()
    cb.init_embed_ = init_and_record
    out = []
    for x in xs:
        local = torch.from_numpy(shard(x, rank, world))
        used['embed'] = cb.embed.detach().clone()
        x_in = (local * me.gain).detach()
        n_graphs = len(graphs)
        loss_c = tc.step(local)
        idx_c = picked['idx']
        loss_e = te.step(local)
        idx_e = picked['idx']
        out.append(np_tree(dict(loss=(loss_c, loss_e), idx=(idx_c, idx_e), x_in=x_in, embed_used=used['embed'],
                                compiled=_state(mc, oc), eager=_state(me, oe),
                                graphs=[graph_ops(gm) for gm in graphs[n_graphs:]])))
    out[-1]['n_params'] = sum(p.numel() for p in mc.parameters())
    torch._dynamo.reset()
    return out


def compiled_config5_step(rank, world, mesh, *, state, batch):
    """BASELINE config 5's DataParallelTrainer step (AdamW 3e-4,
    entry.recon_plus_aux) compiled, and eagerly, from a JAX state on this
    rank's shard of `batch`: both losses and states after the step, and the
    captured graphs."""
    from vqtpu_torch import load_vqtpu_state
    from vqtpu_torch.core.optim import adamw
    from vqtpu_torch.entry import Config5Model, recon_plus_aux

    torch._dynamo.reset()
    graphs = []

    def build():
        m = Config5Model('cpu')
        load_vqtpu_state(m, state)
        return m

    mc, tc, _, me, te, _ = _twins(build, lambda m: adamw(m.parameters(), 3e-4), recon_plus_aux, mesh,
                                  recording_backend(graphs))
    local = torch.from_numpy(shard(batch, rank, world))
    loss_c, loss_e = tc.step(local), te.step(local)
    torch._dynamo.reset()
    return np_tree(dict(loss=(loss_c, loss_e), compiled=mc.state_dict(), eager=me.state_dict(),
                        codebooks=_codebooks(mc), graphs=[graph_ops(gm) for gm in graphs]))


class LFQModel(torch.nn.Module):
    """Linear -> LFQ(sync_axis='data', entropy aux loss) on 8 dims."""

    def __init__(self, **lfq_kwargs):
        import vqtpu_torch
        super().__init__()
        self.enc = torch.nn.Linear(8, 8)
        self.lfq = vqtpu_torch.LFQ(dim=8, codebook_size=2 ** 8, spherical=True, entropy_loss_weight=0.1,
                                   sync_axis='data', device='cpu', **lfq_kwargs)

    def forward(self, x):
        return self.lfq(self.enc(x))


def compiled_lfq_step(rank, world, mesh, *, kwargs, x):
    """One DataParallelTrainer step of LFQModel(**kwargs) compiled and
    eagerly from the same seed, SGD(lr=0.5), on this rank's shard of `x`:
    both losses, indices and parameters after the step, the parameters
    before it, and the captured graphs."""
    torch._dynamo.reset()
    torch.manual_seed(0)
    graphs = []
    picked = {}

    def loss_fn(m, batch):
        q, idx, aux = m(batch)
        picked['idx'] = idx
        return aux + (q - batch).square().mean()

    mc, tc, _, me, te, _ = _twins(lambda: LFQModel(**kwargs).train(), lambda m: torch.optim.SGD(m.parameters(), 0.5),
                                  loss_fn, mesh, recording_backend(graphs))
    before = {k: p.detach().clone() for k, p in me.named_parameters()}
    local = torch.from_numpy(shard(x, rank, world))
    loss_c = tc.step(local)
    idx_c = picked['idx']
    loss_e = te.step(local)
    torch._dynamo.reset()
    return np_tree(dict(loss=(loss_c, loss_e), idx=(idx_c, picked['idx']), before=before,
                        compiled=dict(mc.named_parameters()), eager=dict(me.named_parameters()),
                        graphs=[graph_ops(gm) for gm in graphs]))


def compiled_eval(rank, world, mesh, *, x):
    """eval_step_fn of a trained-mode-free DPModel compiled and eagerly on
    this rank's shard of `x`: both outputs and the captured graphs."""
    from vqtpu_torch.parallel import eval_step_fn

    torch._dynamo.reset()
    torch.manual_seed(0)
    model = DPModel().eval()
    graphs = []
    local = torch.from_numpy(shard(x, rank, world))
    got = eval_step_fn(model, mesh, compiled=True, backend=recording_backend(graphs))(local)
    want = eval_step_fn(model, mesh, compiled=False)(local)
    torch._dynamo.reset()
    return np_tree(dict(compiled=got, eager=want, graphs=[graph_ops(gm) for gm in graphs]))


def dp_compile_body(rank, world, mesh, *, cases):
    """Every case of tests/test_torch_dp_compile.py in one world: {name:
    its body's result}; `cases` is {name: (body name, kwargs)}."""
    bodies = dict(collectives=compiled_collectives, vq=compiled_vq_steps, config5=compiled_config5_step,
                  lfq=compiled_lfq_step, eval=compiled_eval)
    return {name: bodies[body](rank, world, mesh, **kw) for name, (body, kw) in cases.items()}


def dp_compiled_card_body(rank, world, mesh, device, *, steps=2, shape=(16, 256, 64), codes=128):
    """The trainer's step compiled on the card (compiled=None) over
    GainVQ(sync_axis='data', train_fused='on', kmeans init, expiry), SGD,
    against an eager twin, each step from the twin's state (copied in
    place): per step the compiled step's K4 launches, the float64 verdict
    on its indices against eager's, and the largest error of the loss, the
    gain and the codebook against eager over the codes no flipped token
    touched."""
    from vqtpu_torch.kernels.distance import selection_bias, selection_disagreements
    from vqtpu_torch.kernels.train_fused import fused_train_quantize
    from vqtpu_torch.parallel import DataParallelTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(dim=shape[-1], codebook_size=codes, decay=0.8, train_fused='on', kmeans_init=True,
              threshold_ema_dead_code=2, sync_axis='data')
    torch.manual_seed(0)
    eager, compiled = GainVQ(device, **kw).train(), GainVQ(device, **kw).train()
    compiled.load_state_dict(eager.state_dict())
    picked = {}

    def loss_fn(m, batch):
        q, idx, loss = m(batch)
        picked['idx'] = idx
        return loss + q.square().mean()

    te = DataParallelTrainer(eager, torch.optim.SGD(eager.parameters(), lr=1e-3), loss_fn, mesh, compiled=False)
    tc = DataParallelTrainer(compiled, torch.optim.SGD(compiled.parameters(), lr=1e-3), loss_fn, mesh)
    cb = eager.vq._codebook
    init, used = cb.init_embed_, {}

    def init_and_record(flatten, mask=None):
        init(flatten, mask)
        used['embed'] = cb.embed[0].detach().clone()
    cb.init_embed_ = init_and_record
    out = []
    for s in range(steps):
        with torch.no_grad():
            for k, v in compiled.state_dict().items():
                v.copy_(eager.state_dict()[k])
        x = torch.randn(shape, generator=torch.Generator(device).manual_seed(s), device=device)
        used['embed'] = cb.embed[0].detach().clone()
        x_in = (x * eager.gain).detach().reshape(-1, shape[-1])
        loss_e = te.step(x)
        idx_e = picked['idx'].reshape(-1)
        fused_train_quantize.launches = 0
        loss_c = tc.step(x)
        torch.cuda.synchronize()
        launches = fused_train_quantize.launches
        idx_c = picked['idx'].reshape(-1)
        ties = selection_disagreements(x_in, used['embed'], selection_bias(used['embed'], 'euclidean'), idx_c, idx_e)
        flipped = idx_c != idx_e
        keep = torch.ones(codes, dtype=torch.bool, device=device)
        keep[torch.cat([idx_c[flipped], idx_e[flipped]]).long()] = False
        errs = {'loss': (loss_c - loss_e).abs() / loss_e.abs(), 'gain': (compiled.gain - eager.gain).abs()}
        for k in ('embed', 'embed_avg', 'cluster_size'):
            a, b = getattr(compiled.vq._codebook, k)[:, keep], getattr(cb, k)[:, keep]
            errs[k] = (a - b).abs().max() / b.abs().max()
        out.append(dict(launches=launches, compiled=tc.compiled, ties=ties,
                        errors={k: float(v) for k, v in errs.items()}))
    return out


# -- the compiled tensor-parallel step (TensorParallelTrainer(compiled=True)) -------


class SimVQModel(torch.nn.Module):
    """Linear -> SimVQ(dim=16, codebook_size=32, code_axis='code') ->
    Linear: the transform sees only the rank's rows of the frozen codebook,
    so its gradient is partial per code shard."""

    def __init__(self):
        import vqtpu_torch
        super().__init__()
        self.enc = torch.nn.Linear(8, 16)
        self.sim = vqtpu_torch.SimVQ(dim=16, codebook_size=32, code_axis='code', device='cpu')
        self.dec = torch.nn.Linear(16, 8)

    def forward(self, x):
        q, idx, commit = self.sim(self.enc(x))
        return self.dec(q), idx, commit


def compiled_tp_steps(rank, world, mesh, *, model, kwargs, opt, xs):
    """TensorParallelTrainer compiled (a recording aot_eager backend) and
    its eager twin from one seed over `model` ('ae': AEModel(sync_axis=
    'data', code_axis='code', **kwargs); 'simvq': SimVQModel) with `opt`
    ('sgd': SGD(1e-2); 'adam': Adam(1e-2)), a step per global batch in `xs`
    on this rank's block over 'data': per step both losses and indices,
    both states (the rank's rows; the optimizer's state), the quantizer's
    input and, for 'ae', the whole codebook its selection used (gathered
    over 'code'), the shapes of Adam's first moments, and the graphs
    captured in the step."""
    from vqtpu_torch.parallel import TensorParallelTrainer, collectives
    torch._dynamo.reset()
    torch.manual_seed(0)
    graphs, picked = [], {}

    def loss_fn(m, batch):
        out, idx, commit = m(batch)
        picked['idx'] = idx
        return ((out - batch) ** 2).mean() + commit

    build = dict(ae=lambda: AEModel(sync_axis='data', code_axis='code', **kwargs), simvq=SimVQModel)[model]
    make_opt = dict(sgd=lambda m: torch.optim.SGD(m.parameters(), lr=1e-2),
                    adam=lambda m: torch.optim.Adam(m.parameters(), lr=1e-2))[opt]
    mc, tc, oc, me, te, oe = _twins(build, make_opt, loss_fn, mesh, recording_backend(graphs),
                                    TensorParallelTrainer)
    used = {}
    if model == 'ae':
        cb = me.vq._codebook
        init = cb.init_embed_

        def init_and_record(flatten, mask=None):
            init(flatten, mask)
            used['embed'] = cb.embed.detach().clone()
        cb.init_embed_ = init_and_record
    out = []
    for x in xs:
        local = torch.from_numpy(shard(x, mesh.index('data'), mesh.size('data')))
        with torch.no_grad():
            x_in = me.enc(local)
        if model == 'ae':
            used['embed'] = cb.embed.detach().clone()
        n_graphs = len(graphs)
        loss_c = tc.step(local)
        idx_c = picked['idx']
        loss_e = te.step(local)
        idx_e = picked['idx']
        step = dict(loss=(loss_c, loss_e), idx=(idx_c, idx_e), x_in=x_in, compiled=_state(mc, oc),
                    eager=_state(me, oe), moment_shapes=sorted({tuple(s['exp_avg'].shape)
                                                                for s in oc.state.values() if 'exp_avg' in s}),
                    graphs=[graph_ops(gm) for gm in graphs[n_graphs:]])
        if model == 'ae':
            with mesh:
                step['embed_used'] = collectives.all_gather_exact(used['embed'].contiguous(), 'code', concat_axis=1)
        out.append(np_tree(step))
    out[-1]['n_params'] = sum(p.numel() for p in mc.parameters())
    out[-1]['n_partial'] = sum(p.numel() for p in mc.sim.code_transform.parameters()) if model == 'simvq' else 0
    torch._dynamo.reset()
    return out


def compiled_tp_rvq_step(rank, world, mesh, *, state, batch):
    """vqtpu_torch.entry's code-sharded ResidualVQ (TPRVQModel, AdamW
    3e-4, entry.recon_plus_aux): one TensorParallelTrainer step compiled,
    and eagerly, from a JAX state on this rank's block of `batch` over
    'data': both losses and states after the step (gathered back to full
    rows), and the captured graphs."""
    from vqtpu_torch import load_vqtpu_state
    from vqtpu_torch.core.optim import adamw
    from vqtpu_torch.entry import TPRVQModel, recon_plus_aux
    from vqtpu_torch.parallel import TensorParallelTrainer, gather_codebooks

    torch._dynamo.reset()
    graphs = []

    def build():
        m = TPRVQModel(16 * world, 'cpu')
        load_vqtpu_state(m, state)
        return m

    mc, tc, _, me, te, _ = _twins(build, lambda m: adamw(m.parameters(), 3e-4), recon_plus_aux, mesh,
                                  recording_backend(graphs), TensorParallelTrainer)
    local = torch.from_numpy(shard(batch, mesh.index('data'), mesh.size('data')))
    loss_c, loss_e = tc.step(local), te.step(local)
    gather_codebooks(mc, mesh)
    gather_codebooks(me, mesh)
    torch._dynamo.reset()
    return np_tree(dict(loss=(loss_c, loss_e), compiled=mc.state_dict(), eager=me.state_dict(),
                        codebooks=_codebooks(mc), graphs=[graph_ops(gm) for gm in graphs]))


def tp_compile_body(rank, world, mesh, *, cases):
    """Every case of tests/test_torch_tp_compile.py in one world: {name:
    its body's result}; `cases` is {name: (body name, kwargs)}."""
    bodies = dict(steps=compiled_tp_steps, rvq=compiled_tp_rvq_step, tp_apply=compiled_tp_apply)
    return {name: bodies[body](rank, world, mesh, **kw) for name, (body, kw) in cases.items()}
