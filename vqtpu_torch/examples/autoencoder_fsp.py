"""FSP autoencoder example (counterpart of examples/autoencoder_fsp.py;
levels [8, 6, 5], tanh activation, quantize_rate 0.5, vector_norm
var_tanh). Run:
python -m vqtpu_torch.examples.autoencoder_fsp [--train_iter N] [--device cpu]"""

import argparse
import math

import torch

from ..core.utils import resolve_device
from ..models import SimpleQuantizeAutoEncoder
from ..quantizers.fsp import FSP
from .common import add_device_arg, l1_reconstruction, train_loop


def loss_from_outputs(outputs, x, alpha):
    out, indices, norm_loss, _info = outputs
    rec = l1_reconstruction(out, x)
    return rec + norm_loss, rec, norm_loss, indices


def main(train_iter=1000, lr=3e-4, dim=32, levels=(8, 6, 5), seed=1234,
         act_name='tanh', quantize_rate=0.5, vector_norm='var_tanh',
         alpha=10.0, batch_size=256, device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    quantizer = FSP(
        list(levels), dim=dim, act_name=act_name,
        quantize_rate=quantize_rate, vector_norm=vector_norm, device=device,
    )
    model = SimpleQuantizeAutoEncoder(quantizer, dim=dim, device=device)
    return train_loop(model, loss_from_outputs=loss_from_outputs,
                      codebook_size=math.prod(levels), train_iter=train_iter,
                      lr=lr, alpha=alpha, batch_size=batch_size, seed=seed, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=256)
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, batch_size=a.batch_size, device=a.device)
