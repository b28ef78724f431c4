"""VQ autoencoder example (counterpart of examples/autoencoder.py). Run:
python -m vqtpu_torch.examples.autoencoder [--train_iter N] [--device cpu]"""

import argparse

import torch

from ..core.utils import resolve_device
from ..models import SimpleQuantizeAutoEncoder
from ..quantizers.vq import VectorQuantize
from .common import add_device_arg, l1_reconstruction, train_loop


def loss_from_outputs(outputs, x, alpha):
    out, indices, cmt_loss = outputs
    rec = l1_reconstruction(out, x)
    return rec + alpha * cmt_loss, rec, cmt_loss, indices


def main(train_iter=1000, lr=3e-4, dim=32, num_codes=256, seed=1234,
         rotation_trick=True, straight_through=False, directional_reparam=False,
         alpha=10.0, batch_size=256, train_fused='auto', device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    model = SimpleQuantizeAutoEncoder(
        VectorQuantize(
            dim=dim, codebook_size=num_codes,
            rotation_trick=rotation_trick,
            straight_through=straight_through,
            directional_reparam=directional_reparam,
            threshold_ema_dead_code=2 if directional_reparam else 0,
            train_fused=train_fused,
            device=device,
        ),
        dim=dim, device=device,
    )
    return train_loop(model, loss_from_outputs=loss_from_outputs,
                      codebook_size=num_codes, train_iter=train_iter, lr=lr,
                      alpha=alpha, batch_size=batch_size, seed=seed, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--dim', type=int, default=32)
    p.add_argument('--num_codes', type=int, default=256)
    p.add_argument('--seed', type=int, default=1234)
    p.add_argument('--straight_through', action='store_true')
    p.add_argument('--directional_reparam', action='store_true')
    p.add_argument('--train_fused', choices=('auto', 'on', 'off'), default='auto',
                   help='route the EMA training forward through the fused train kernel (K4)')
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, batch_size=a.batch_size,
         dim=a.dim, num_codes=a.num_codes, seed=a.seed,
         rotation_trick=not (a.straight_through or a.directional_reparam),
         straight_through=a.straight_through,
         directional_reparam=a.directional_reparam,
         train_fused=a.train_fused, device=a.device)
