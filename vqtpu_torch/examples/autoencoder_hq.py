"""HierarchicalVQ autoencoder example (counterpart of
examples/autoencoder_hq.py; scales (1, 2, 4, 7), codebook 512, kmeans
init, quant_resi 0.5). Run:
python -m vqtpu_torch.examples.autoencoder_hq [--train_iter N] [--device cpu]"""

import argparse

import torch
from torch import nn

from ..composite.hierarchical_vq import HierarchicalVQ
from ..core.utils import resolve_device
from ..models.autoencoder import ConvDecoder, ConvEncoder
from .common import add_device_arg, l1_reconstruction, train_loop


class HQAutoEncoder(nn.Module):
    """HierarchicalVQ consumes channel-first feature maps, so this model
    transposes around the quantizer."""

    def __init__(self, dim, num_codes, scales, *, device=None):
        super().__init__()
        self.encoder = ConvEncoder(dim, device=device)
        self.hq = HierarchicalVQ(
            dim=dim, codebook_size=num_codes, scales=scales,
            accept_image_fmap=True, kmeans_init=True, quant_resi=0.5,
            share_quant_resi=1, device=device,
        )
        self.decoder = ConvDecoder(dim, device=device)

    def forward(self, x):
        z = self.encoder(x)                       # (b, h, w, d)
        fmap = z.permute(0, 3, 1, 2)              # (b, d, h, w)
        recon, indices, commit = self.hq(fmap)
        z = recon.permute(0, 2, 3, 1)
        return self.decoder(z), indices, commit


def loss_from_outputs(outputs, x, alpha):
    out, indices, commit_loss = outputs
    rec = l1_reconstruction(out, x)
    return rec + alpha * commit_loss, rec, commit_loss, indices[-1]


def main(train_iter=1000, lr=3e-4, dim=32, num_codes=512, seed=1234,
         scales=(1, 2, 4, 7), alpha=10.0, batch_size=256, device=None):
    device = resolve_device(device)
    torch.manual_seed(seed)
    model = HQAutoEncoder(dim, num_codes, scales, device=device)
    return train_loop(model, loss_from_outputs=loss_from_outputs,
                      codebook_size=num_codes, train_iter=train_iter, lr=lr,
                      alpha=alpha, batch_size=batch_size, seed=seed, device=device)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--train_iter', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=256)
    add_device_arg(p)
    a = p.parse_args()
    main(train_iter=a.train_iter, batch_size=a.batch_size, device=a.device)
