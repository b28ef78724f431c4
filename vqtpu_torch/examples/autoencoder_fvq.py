"""FVQ autoencoder example (counterpart of examples/autoencoder_fvq.py): the
codebook is realized through a small transformer bridge (vq_bridge) and
trained with an in-place SGD codebook optimizer (`optax.sgd(1e-3)` there,
`torch.optim.SGD(p, lr=1e-3)` here).

An EMA-free learnable codebook behind a bridge is prone to winner-take-all
collapse of its utilization on easy data, in the reference as in both
packages (PARITY_FVQ.json); `--diversity N` (e.g. 0.5) counteracts it.
Run: python -m vqtpu_torch.examples.autoencoder_fvq [--train_iter N] [--device cpu]
"""

import argparse

import torch

from ..core.utils import resolve_device
from ..models import MiniEncoder, SimpleQuantizeAutoEncoder
from ..quantizers.vq import VectorQuantize
from .common import add_device_arg, l1_reconstruction, train_loop


def loss_from_outputs(outputs, x, alpha):
    out, indices, cmt_loss = outputs
    rec = l1_reconstruction(out, x)
    return rec + alpha * cmt_loss, rec, cmt_loss, indices


def main(train_iter=1000, lr=3e-4, dim=32, num_codes=256, seed=1234,
         alpha=10.0, batch_size=256, diversity_weight=0.0, device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    # inner width 256 over codebook dim 32: the reference example's setting
    bridge = MiniEncoder(dim=256, input_dim=dim, depth=1, heads=4, device=device)
    # rotation_trick=False as in the reference FVQ config: with the rotation
    # trick the task gradients bypass the bridge and the codebook collapses
    quantizer = VectorQuantize(
        dim=dim, codebook_size=num_codes,
        vq_bridge=bridge, learnable_codebook=True, ema_update=False,
        rotation_trick=False,
        codebook_diversity_loss_weight=diversity_weight,
        in_place_codebook_optimizer=lambda p: torch.optim.SGD(p, lr=1e-3), device=device,
    )
    model = SimpleQuantizeAutoEncoder(quantizer, dim=dim, device=device)
    return train_loop(model, loss_from_outputs=loss_from_outputs,
                      codebook_size=num_codes, train_iter=train_iter, lr=lr,
                      alpha=alpha, batch_size=batch_size, seed=seed, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--diversity', type=float, default=0.0,
                   help='codebook diversity loss weight; 0 = reference-faithful '
                        '(collapses on easy data, PARITY_FVQ.json)')
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, batch_size=a.batch_size,
         diversity_weight=a.diversity, device=a.device)
