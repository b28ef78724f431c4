"""FSQ autoencoder example (counterpart of examples/autoencoder_fsq.py;
default levels [8, 6, 5]). Run:
python -m vqtpu_torch.examples.autoencoder_fsq [--train_iter N] [--device cpu]"""

import argparse
import math

import torch

from ..core.utils import resolve_device
from ..models import SimpleQuantizeAutoEncoder
from ..quantizers.fsq import FSQ
from .common import add_device_arg, l1_reconstruction, train_loop


def loss_from_outputs(outputs, x, alpha):
    out, indices = outputs
    rec = l1_reconstruction(out, x)
    return rec, rec, torch.zeros((), device=rec.device), indices


def main(train_iter=1000, lr=3e-4, dim=32, levels=(8, 6, 5), seed=1234,
         alpha=10.0, batch_size=256, device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    quantizer = FSQ(list(levels), dim=dim, device=device)
    model = SimpleQuantizeAutoEncoder(quantizer, dim=dim, device=device)
    return train_loop(model, loss_from_outputs=loss_from_outputs,
                      codebook_size=math.prod(levels), train_iter=train_iter,
                      lr=lr, alpha=alpha, batch_size=batch_size, seed=seed, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--levels', type=int, nargs='+', default=[8, 6, 5])
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, batch_size=a.batch_size,
         levels=tuple(a.levels), device=a.device)
