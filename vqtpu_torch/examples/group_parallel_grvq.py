"""Group-parallel GroupedResidualVQ: the groups split over a mesh axis
(counterpart of examples/group_parallel_grvq.py).

GroupedResidualVQ runs its feature-dim groups as a loop over independent
members. Over a 'group' mesh axis the groups run in parallel:
`group_parallel_forward` runs each group's member on its own rank with the
same semantics (the indices and outputs of the serial loop; the EMA
codebook state written back on every rank). On the card the members' part
runs as one compiled graph, cached across the steps, as the JAX script
jits its shard_map.

This example EMA-trains a GroupedResidualVQ on synthetic features with the
groups over all ranks, checks the first step against the serial loop on
the same rank (bit for bit eagerly; compiled, the indices bit for bit and
the output and the loss within 1e-6 relative), and round-trips the codes through the
sharded decode. Each rank is a process of a torchrun job,
joined over gloo (all may share one card):

    torchrun --nproc_per_node 4 -m vqtpu_torch.examples.group_parallel_grvq --steps 20
    torchrun --nproc_per_node 2 -m vqtpu_torch.examples.group_parallel_grvq --device cpu
"""

import argparse

import torch

from ..composite.residual_vq import GroupedResidualVQ
from ..core.utils import resolve_device
from ..parallel import group_parallel_forward, group_parallel_output_from_indices, make_mesh
from .common import add_device_arg, distributed_job


def run(mesh, *, steps=20, groups=4, dim=64, num_quantizers=4, codes=128, tokens=2048, seed=0,
        device=None, compiled: bool | None = None) -> dict:
    """This rank's part on a ('group',) mesh. Returns the step-0 check
    against the serial loop (each `*_equal` bit-equal eagerly, within 1e-6
    relative compiled; the indices always bit-equal) with its relative
    errors, the losses, the decode's round-trip error and whether the
    group-parallel calls ran compiled (`compiled`: None compiles on the
    card and runs eagerly on the CPU)."""
    device = resolve_device(device)
    compiled = device.type == 'cuda' if compiled is None else bool(compiled)
    rank0 = mesh.index('group') == 0
    if rank0:
        print(f'{groups} groups over a {mesh.size("group")}-rank group mesh ({device.type})', flush=True)

    kw = dict(dim=dim, groups=groups, num_quantizers=num_quantizers, codebook_size=codes, decay=0.9)
    torch.manual_seed(seed)
    gp = GroupedResidualVQ(**kw, device=device)
    torch.manual_seed(seed)
    serial = GroupedResidualVQ(**kw, device=device)
    gp.train(), serial.train()

    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((16, dim), generator=gen, device=device) * 2.0

    def batch(i):
        g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i + 1)
        pick = torch.randint(0, 16, (1, tokens), generator=g, device=device)
        noise = torch.randn((1, tokens, dim), generator=g, device=device)
        return centers[pick] + 0.1 * noise

    # first step: group-parallel == the serial loop
    x0 = batch(0)
    q_gp, ind_gp, loss_gp = group_parallel_forward(gp, x0, mesh, compiled=compiled)
    q_s, ind_s, loss_s = serial(x0)
    # eagerly bit for bit; compiled, the rotation trick's norms and the
    # mean may round an ulp apart from eager's: within 1e-6 relative
    limit = 1e-6 if compiled else 0.0
    output_rel_err = float((q_gp - q_s).abs().max() / q_s.abs().max())
    loss_rel_err = float((loss_gp - loss_s).abs().max() / loss_s.abs().max())
    step0 = dict(indices_equal=bool(torch.equal(ind_gp, ind_s)), output_equal=output_rel_err <= limit,
                 loss_equal=loss_rel_err <= limit)
    if not all(step0.values()):
        raise AssertionError(f'group-parallel step 0 diverged from the serial loop: {step0}')
    if rank0:
        print(f'step 0: indices, output and loss match the serial loop (output rel err {output_rel_err:.1e}, '
              f'loss {loss_rel_err:.1e}); commit loss {float(loss_gp.sum()):.4f}', flush=True)

    losses, recs = [float(loss_gp.sum())], []
    for i in range(1, steps):
        xi = batch(i)
        quantized, indices, step_losses = group_parallel_forward(gp, xi, mesh, compiled=compiled)
        losses.append(float(step_losses.sum()))
        recs.append(float((quantized - xi).abs().mean()))
        if rank0 and (i % 5 == 0 or i == steps - 1):
            print(f'step {i:3d}: commit {losses[-1]:.4f} | recon l1 {recs[-1]:.4f}', flush=True)

    # serving decode: each rank decodes its groups from its own codebooks
    gp.eval()
    x = batch(steps)
    with torch.no_grad():
        quantized, indices, _ = group_parallel_forward(gp, x, mesh, update_state=False, compiled=compiled)
        decoded = group_parallel_output_from_indices(gp, indices, mesh, compiled=compiled)
    err = float((decoded - quantized).abs().max())
    if rank0:
        print(f'sharded decode round-trip max err {err:.2e}', flush=True)
    if not err < 1e-5:
        raise AssertionError(f'sharded decode round trip: max err {err}')
    return dict(step0=step0, output_rel_err=output_rel_err, loss_rel_err=loss_rel_err, losses=losses, recon_l1=recs, decode_max_err=err,
                compiled=compiled)


def main(steps=20, groups=4, dim=64, num_quantizers=4, codes=128, tokens=2048, seed=0, device=None):
    """This rank's part on a ('group',) mesh over the ranks of the job
    (`common.distributed_job`; their number divides `groups`); returns its
    `run` result."""
    with distributed_job(device):
        return run(make_mesh(('group',)), steps=steps, groups=groups, dim=dim, num_quantizers=num_quantizers,
                   codes=codes, tokens=tokens, seed=seed, device=device)


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--groups', type=int, default=4)
    ap.add_argument('--dim', type=int, default=64)
    ap.add_argument('--quantizers', type=int, default=4)
    ap.add_argument('--codes', type=int, default=128)
    add_device_arg(ap)
    a = ap.parse_args()
    main(steps=a.steps, groups=a.groups, dim=a.dim, num_quantizers=a.quantizers, codes=a.codes,
         device=a.device)
