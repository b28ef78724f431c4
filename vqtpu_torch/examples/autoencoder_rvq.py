"""ResidualVQ autoencoder, RQ-VAE / SoundStream style (counterpart of
examples/autoencoder_rvq.py: 8 quantizers, kmeans init, one shared
codebook, stochastic sampling). Run:
python -m vqtpu_torch.examples.autoencoder_rvq [--train_iter N] [--device cpu]"""

import argparse

import torch

from ..composite.residual_vq import ResidualVQ
from ..core.utils import resolve_device
from ..models import SimpleQuantizeAutoEncoder
from .common import add_device_arg, l1_reconstruction, train_loop


def loss_from_outputs(outputs, x, alpha):
    out, indices, cmt_losses = outputs
    rec = l1_reconstruction(out, x)
    cmt = cmt_losses.sum()
    return rec + alpha * cmt, rec, cmt, indices


def main(train_iter=1000, lr=3e-4, dim=32, num_codes=256, num_quantizers=8,
         seed=1234, shared_codebook=True, stochastic=True, alpha=10.0,
         batch_size=256, device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    model = SimpleQuantizeAutoEncoder(
        ResidualVQ(
            dim=dim,
            num_quantizers=num_quantizers,
            codebook_size=num_codes,
            kmeans_init=True,
            shared_codebook=shared_codebook,
            stochastic_sample_codes=stochastic,
            sample_codebook_temp=0.1,
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
    p.add_argument('--num_quantizers', type=int, default=8)
    p.add_argument('--num_codes', type=int, default=256)
    add_device_arg(p)
    args = p.parse_args()
    main(train_iter=args.train_iter, batch_size=args.batch_size,
         num_quantizers=args.num_quantizers, num_codes=args.num_codes, device=args.device)
