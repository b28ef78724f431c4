"""Tensor-parallel large-codebook training example (counterpart of
examples/tp_large_codebook.py).

Trains a conv autoencoder whose VectorQuantize bottleneck has a codebook
too large to replicate (65,536 rows by default), row-sharded over a `code`
mesh axis while the batch splits over `data`: the whole 2D-mesh training
path (`code_axis`, kmeans init and dead-code expiry on sharded rows, the
EMA statistics summed over the mesh). Each rank is a process of a torchrun
job, joined over gloo, which takes CUDA tensors, so all ranks may share
one card:

    torchrun --nproc_per_node 8 -m vqtpu_torch.examples.tp_large_codebook            # 2 x 4 ranks
    torchrun --nproc_per_node 4 -m vqtpu_torch.examples.tp_large_codebook --data 1 --code 4 --device cpu

Every rank draws the same global batch from the same seed and trains on
its block of it (`parallel.global_batch`); at the end the ranks holding
the same code shard are checked to hold bit-identical parameters and
state. On the card the step is compiled whole (the trainer's default), as
the JAX script jits its shard_map'd step.
"""

import argparse
import time

import torch

from ..core import metrics
from ..core.utils import resolve_device
from ..models import SimpleQuantizeAutoEncoder
from ..models import data as data_module
from ..parallel import TensorParallelTrainer, collectives, global_batch, make_mesh
from ..quantizers.vq import VectorQuantize
from .common import adamw, add_device_arg, distributed_job, l1_reconstruction

MESH_AXES = ('data', 'code')


def data_replicas_identical(model, mesh) -> dict:
    """{state name: whether every rank of this rank's 'data' group holds it
    bit for bit alike} (each holds the same code shard)."""
    out = {}
    with mesh, torch.no_grad():
        for name, t in model.state_dict().items():
            t = t.to(torch.uint8) if t.dtype == torch.bool else t
            stacked = collectives.all_gather(t.contiguous()[None], 'data')
            out[name] = all(torch.equal(stacked[0], s) for s in stacked[1:])
    return out


def run(mesh, *, train_iter=200, lr=3e-4, dim=64, num_codes=65536, seed=0, alpha=10.0, batch_size=256,
        log_every=20, device=None) -> dict:
    """This rank's part of the training on `mesh` (axes 'data' and 'code').
    Returns the losses (mean over 'data'), the rows this rank holds, the
    EMA perplexity over all codes and the data-replica check."""
    device = resolve_device(device)
    code = mesh.size('code')
    if num_codes % code:
        raise ValueError(f'{num_codes} codes do not split over {code} code shards')
    torch.manual_seed(seed)                       # the same model on every rank
    model = SimpleQuantizeAutoEncoder(
        VectorQuantize(
            dim=dim, codebook_size=num_codes,
            sync_axis='data', code_axis='code',
            kmeans_init=True, threshold_ema_dead_code=0.25,
            device=device,
        ),
        dim=dim, device=device,
    )

    def loss_fn(m, x):
        out, indices, cmt = m(x)
        return l1_reconstruction(out, x) + alpha * cmt

    trainer = TensorParallelTrainer(model, adamw(model.parameters(), lr), loss_fn, mesh)
    data_iter = data_module.image_batches(batch_size=batch_size, seed=seed)
    rank0 = all(c == 0 for c in mesh.coords)
    rows = model.quantizer._codebook.embed.shape[-2]
    if rank0:
        print(f'mesh {dict(zip(mesh.axis_names, mesh.shape))} | codebook {num_codes} rows ({rows} per code-shard)',
              flush=True)
    losses = []
    t0 = time.time()
    for it in range(train_iter):
        x = global_batch(mesh, ('data',), next(data_iter), device)
        loss = trainer.step(x)
        losses.append(float(loss))
        if rank0 and (it % log_every == 0 or it == train_iter - 1):
            print(f'iter {it:5d} | loss {losses[-1]:.4f} | {time.time() - t0:.1f}s', flush=True)

    with mesh, torch.no_grad():
        cs = collectives.all_gather(model.quantizer._codebook.cluster_size.contiguous(), 'code', concat_axis=-1)
    pplx = float(metrics.ema_perplexity(cs)[0])
    replicas = data_replicas_identical(model, mesh)
    if rank0:
        print(f'done: EMA perplexity {pplx:.1f} over {num_codes} sharded codes', flush=True)
    if not all(replicas.values()):
        raise AssertionError(f'the data replicas of a code shard differ: {replicas}')
    return dict(coords=mesh.coords, losses=losses, rows_per_rank=rows, ema_perplexity=pplx,
                data_replicas_identical=replicas, compiled=trainer.compiled)


def main(train_iter=200, lr=3e-4, dim=64, num_codes=65536, seed=0,
         alpha=10.0, batch_size=256, data=2, code=4, device=None):
    """This rank's part of the training on a (data, code) mesh over the
    `data * code` ranks of the job (`common.distributed_job`); returns its
    `run` result."""
    with distributed_job(device):
        return run(make_mesh(MESH_AXES, (data, code)), train_iter=train_iter, lr=lr, dim=dim,
                   num_codes=num_codes, seed=seed, alpha=alpha, batch_size=batch_size, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=200)
    p.add_argument('--num_codes', type=int, default=65536)
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--data', type=int, default=2)
    p.add_argument('--code', type=int, default=4)
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, num_codes=a.num_codes, batch_size=a.batch_size,
         data=a.data, code=a.code, device=a.device)
