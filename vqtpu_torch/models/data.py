"""The example trainers' data pipeline (counterpart of vqtpu/models/data.py).

Sources, in order:
  1. the native IDX loader (native/vqdata.c through ctypes): a local
     FashionMNIST or MNIST `train-images-idx3-ubyte` is mmap'd and each
     batch is gathered and normalized in one C pass, on a prefetch thread;
  2. a torchvision cache, if torchvision imports;
  3. synthetic structured images (mixtures of oriented gaussian blobs) of
     the same shape and range, with a warning on stderr.

Batches are numpy float32 arrays, the same stream as the JAX package's for
the same seed and source; moving them to the device is the trainer's job.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# the JAX package's candidates; `~root` is the root user's home directory
_IDX_CANDIDATES = (
    '~/data/fashion_mnist/FashionMNIST/raw/train-images-idx3-ubyte',
    '~/data/FashionMNIST/raw/train-images-idx3-ubyte',
    '~root/data/FashionMNIST/raw/train-images-idx3-ubyte',
    '~/data/MNIST/raw/train-images-idx3-ubyte',
)
_TORCHVISION_ROOTS = ('~/data/fashion_mnist', '~/data', '~root/data')


def _try_native_idx():
    from . import native_data

    for cand in _IDX_CANDIDATES:
        path = os.path.expanduser(cand)
        if not os.path.exists(path):
            continue
        try:
            return native_data.IdxDataset(path)
        except Exception:
            continue
    return None


def _try_fashion_mnist():
    try:
        from torchvision import datasets  # type: ignore
    except Exception:
        return None
    for root in _TORCHVISION_ROOTS:
        try:
            ds = datasets.FashionMNIST(root=os.path.expanduser(root), train=True, download=False)
        except Exception:
            continue
        data = ds.data.numpy().astype(np.float32) / 255.0
        return (data - 0.5) / 0.5                        # normalize to [-1, 1]
    return None


def _synthetic_images(num: int = 8192, size: int = 28, seed: int = 0) -> np.ndarray:
    """(num, size, size) float32 in [-1, 1]: 2-4 oriented gaussian blobs an
    image, enough structure for a VQ autoencoder to learn a meaningful
    codebook. Every image has 4 blob slots, the extra ones masked out."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    k = 4
    nblobs = rng.integers(2, 5, size=(num, 1))
    active = (np.arange(k)[None, :] < nblobs).astype(np.float32)  # (num, k)
    cx = rng.uniform(4, size - 4, (num, k)).astype(np.float32)
    cy = rng.uniform(4, size - 4, (num, k)).astype(np.float32)
    sx = rng.uniform(1.5, 5.0, (num, k)).astype(np.float32)
    sy = rng.uniform(1.5, 5.0, (num, k)).astype(np.float32)
    theta = rng.uniform(0, np.pi, (num, k)).astype(np.float32)
    cos_t, sin_t = np.cos(theta), np.sin(theta)

    # (num, k, size, size)
    dx = xs[None, None] - cx[..., None, None]
    dy = ys[None, None] - cy[..., None, None]
    rx = dx * cos_t[..., None, None] + dy * sin_t[..., None, None]
    ry = -dx * sin_t[..., None, None] + dy * cos_t[..., None, None]
    blobs = np.exp(-(rx ** 2 / (2 * sx[..., None, None] ** 2)
                     + ry ** 2 / (2 * sy[..., None, None] ** 2)))
    images = (blobs * active[..., None, None]).sum(axis=1)
    images = np.clip(images, 0.0, 1.0)
    return (images * 2.0 - 1.0).astype(np.float32)


def image_batches(batch_size: int = 256, seed: int = 0, channel_last: bool = True):
    """Infinite iterator of (batch_size, 28, 28, 1) float32 numpy batches in
    [-1, 1] ((batch_size, 1, 28, 28) without `channel_last`): FashionMNIST
    when a local copy exists (the native IDX loader first), synthetic
    images otherwise."""
    rng = np.random.default_rng(seed)

    native = _try_native_idx()
    if native is not None:
        from .native_data import PrefetchLoader

        loader = PrefetchLoader(native, batch_size, seed=seed, channel_last=channel_last)
        try:
            yield from loader
            # the prefetch stream is infinite: ending here means its worker
            # stopped without an error. Another source would change the
            # data mid-run, so fail instead.
            raise RuntimeError('native IDX prefetch loader terminated unexpectedly (worker thread exited '
                               'without an error); refusing to fall back to a different data source mid-iteration')
        finally:
            loader.close()          # joins the worker; closing the stream stops it

    data = _try_fashion_mnist()
    if data is None:
        print(
            '=' * 70 + '\n'
            'WARNING: no local FashionMNIST found — training on SYNTHETIC\n'
            'blob images. Results are NOT comparable to reference runs on\n'
            'real data. Fetch the dataset with:\n'
            '    python tools/fetch_fashion_mnist.py\n'
            '(requires network; writes the IDX file the native loader uses)\n'
            + '=' * 70,
            file=sys.stderr,
        )
        data = _synthetic_images(seed=seed)

    n = data.shape[0]
    while True:
        idx = rng.integers(0, n, batch_size)
        batch = data[idx][..., None]                     # (b, h, w, 1)
        if not channel_last:
            batch = np.moveaxis(batch, -1, 1)
        yield batch.astype(np.float32)
