"""LFQ autoencoder example (counterpart of examples/autoencoder_lfq.py;
codebook 256 = 2^8, entropy_loss_weight 0.02, diversity_gamma 1). Run:
python -m vqtpu_torch.examples.autoencoder_lfq [--train_iter N] [--device cpu]"""

import argparse

import torch

from ..core.utils import resolve_device
from ..models import SimpleQuantizeAutoEncoder
from ..quantizers.lfq import LFQ
from .common import add_device_arg, l1_reconstruction, train_loop


def loss_from_outputs(outputs, x, alpha):
    out, indices, entropy_aux_loss = outputs
    rec = l1_reconstruction(out, x)
    return rec + alpha * entropy_aux_loss, rec, entropy_aux_loss, indices


def main(train_iter=1000, lr=3e-4, dim=32, num_codes=256, seed=1234,
         entropy_loss_weight=0.02, diversity_gamma=1.0, alpha=10.0,
         batch_size=256, device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    quantizer = LFQ(
        dim=dim, codebook_size=num_codes,
        entropy_loss_weight=entropy_loss_weight,
        diversity_gamma=diversity_gamma, device=device,
    )
    model = SimpleQuantizeAutoEncoder(quantizer, dim=dim, device=device)
    return train_loop(model, loss_from_outputs=loss_from_outputs,
                      codebook_size=num_codes, train_iter=train_iter, lr=lr,
                      alpha=alpha, batch_size=batch_size, seed=seed, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--num_codes', type=int, default=256)
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, batch_size=a.batch_size,
         num_codes=a.num_codes, device=a.device)
