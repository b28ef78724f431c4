"""The port's data pipeline (vqtpu_torch.models: data, native_data,
native_build) against the JAX package's (vqtpu.models), on the CPU.

The synthetic images and the image stream bit for bit (numpy in both); the
IDX writer byte for byte; the native gather and the prefetch ring bit for
bit on the same file; the error paths raise the types the JAX package's do
(tests/test_native_data.py). The port builds native/vqdata.c into
build/vqtpu_torch/native/. Tests that need the native library skip where
no C compiler exists; the others need none.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import vqtpu.models.data as jdata
import vqtpu.models.native_build as jbuild
import vqtpu.models.native_data as jnative
import vqtpu_torch.models.data as tdata
import vqtpu_torch.models.native_build as tbuild
import vqtpu_torch.models.native_data as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# numpy's decode of the C gather: x * (2/255) - 1 in f32
LUT = np.arange(256, dtype=np.float32) * (2.0 / 255.0) - 1.0


@pytest.fixture(scope='module')
def lib():
    if tbuild.load() is None or jbuild.load() is None:
        pytest.skip('no C toolchain available to build the native runtime')


@pytest.fixture
def idx_file(tmp_path):
    images = np.random.default_rng(3).integers(0, 256, (96, 28, 28), dtype=np.uint8)
    path = str(tmp_path / 'train-images-idx3-ubyte')
    tnative.write_idx(path, images)
    return path, images


@pytest.mark.parametrize('seed', [0, 7])
def test_synthetic_images_bit_equal(seed):
    got = tdata._synthetic_images(num=64, seed=seed)
    want = jdata._synthetic_images(num=64, seed=seed)
    assert got.dtype == np.float32 and got.shape == (64, 28, 28)
    assert np.array_equal(got, want)


def test_sources_are_jax_s(monkeypatch):
    """The same IDX files in the same order, and the same torchvision roots
    tried in the same order, with the same normalization of the cache the
    first root that has one gives (a stand-in torchvision records them)."""
    expand = lambda paths: [os.path.expanduser(p) for p in paths]  # noqa: E731
    assert expand(tdata._IDX_CANDIDATES) == expand(jdata._IDX_CANDIDATES)
    images = np.random.default_rng(2).integers(0, 256, (6, 28, 28), dtype=np.uint8)
    tried = []

    class FashionMNIST:
        def __init__(self, root, train, download):
            tried.append((root, train, download))
            if len(tried) % 3:
                raise FileNotFoundError(root)
            self.data = torch.from_numpy(images)

    monkeypatch.setitem(sys.modules, 'torchvision', types.SimpleNamespace(
        datasets=types.SimpleNamespace(FashionMNIST=FashionMNIST)))
    want = jdata._try_fashion_mnist()
    got = tdata._try_fashion_mnist()
    assert tried[:3] == tried[3:] and len(tried) == 6
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize('channel_last', [True, False])
def test_image_batches_bit_equal_without_a_dataset(channel_last, monkeypatch, capsys):
    """No IDX file and no torchvision in either package: both fall back to
    their synthetic images (512 of them here, to keep the test short) and
    draw the same batches."""
    for mod in (jdata, tdata):
        own = mod._synthetic_images
        monkeypatch.setattr(mod, '_IDX_CANDIDATES', ())
        monkeypatch.setattr(mod, '_try_fashion_mnist', lambda: None)
        monkeypatch.setattr(mod, '_synthetic_images', lambda num=8192, size=28, seed=0, own=own: own(512, size, seed))
    got = tdata.image_batches(batch_size=16, seed=0, channel_last=channel_last)
    want = jdata.image_batches(batch_size=16, seed=0, channel_last=channel_last)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.dtype == np.float32 and g.shape == ((16, 28, 28, 1) if channel_last else (16, 1, 28, 28))
        assert np.array_equal(g, w)
    assert 'SYNTHETIC' in capsys.readouterr().err


def test_write_idx_byte_equal(tmp_path):
    images = np.random.default_rng(1).integers(0, 256, (5, 7, 9), dtype=np.uint8)
    tnative.write_idx(str(tmp_path / 'port'), images)
    jnative.write_idx(str(tmp_path / 'jax'), images)
    assert (tmp_path / 'port').read_bytes() == (tmp_path / 'jax').read_bytes()


def test_library_lands_under_build(lib):
    out_dir = os.path.join(REPO, 'build', 'vqtpu_torch', 'native')
    assert tbuild.OUT_DIR == out_dir
    assert os.path.dirname(tbuild.load()._name) == out_dir
    assert os.path.exists(os.path.join(out_dir, 'libvqdata.so'))


def test_gather_bit_equal(lib, idx_file):
    path, images = idx_file
    tds, jds = tnative.IdxDataset(path), jnative.IdxDataset(path)
    assert (tds.count, tds.rows, tds.cols) == (jds.count, jds.rows, jds.cols) == images.shape
    idx = np.random.default_rng(4).integers(0, 96, 40)
    got = tds.gather(idx)
    assert np.array_equal(got, jds.gather(idx))
    assert np.array_equal(got, LUT[images[idx]])
    out = np.empty((40, 28, 28), np.float32)
    assert tds.gather(idx, out) is out
    tds.close()
    jds.close()


def test_prefetch_loader_matches_jax(lib, idx_file):
    path, images = idx_file
    tds, jds = tnative.IdxDataset(path), jnative.IdxDataset(path)
    tl = tnative.PrefetchLoader(tds, 16, seed=5, depth=2)
    jl = jnative.PrefetchLoader(jds, 16, seed=5, depth=2)
    tl_cf = tnative.PrefetchLoader(tds, 16, seed=5, depth=2, channel_last=False)
    batches = [next(tl) for _ in range(4)]
    rng = np.random.default_rng(5)
    for b in batches:
        assert np.array_equal(b, next(jl))
        assert np.array_equal(b, LUT[images[rng.integers(0, 96, 16)]][..., None])
    assert np.array_equal(next(tl_cf), np.moveaxis(batches[0], -1, 1))
    # every slot is a fresh buffer
    kept = batches[1].copy()
    batches[0][:] = 0
    assert np.array_equal(batches[1], kept)
    for loader in (tl, jl, tl_cf):
        loader.close()
        assert not loader._thread.is_alive()
    tds.close()
    jds.close()


def test_error_paths_raise_like_jax(lib, idx_file, tmp_path):
    path, _ = idx_file
    for mod in (tnative, jnative):
        ds = mod.IdxDataset(path)
        with pytest.raises(IndexError):
            ds.gather(np.array([96], np.int64))
        # a dataset that claims more rows than its file holds: the worker's
        # gather fails, and the consumer gets the error instead of a hang
        ds.count = 10 ** 9
        loader = mod.PrefetchLoader(ds, 8, seed=0)
        with pytest.raises(RuntimeError, match='prefetch worker died'):
            next(loader)
        loader.close()
        ds.close()
        junk = tmp_path / f'junk_{mod.__name__}'
        junk.write_bytes(b'not an idx file at all, definitely')
        with pytest.raises(FileNotFoundError):
            mod.IdxDataset(str(junk))


def test_image_batches_reads_an_imported_file(lib, tmp_path, monkeypatch):
    """tools/import_fashion_mnist.py writes the IDX file that both packages'
    image_batches then read through the native loader, batch for batch."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import import_fashion_mnist as imp
    finally:
        sys.path.remove(os.path.join(REPO, 'tools'))
    images = np.random.default_rng(6).integers(0, 256, (24, 28, 28), dtype=np.uint8)
    np.save(tmp_path / 'imgs.npy', images)
    dst = imp.import_images(str(tmp_path / 'imgs.npy'), str(tmp_path / 'root'))
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, '_IDX_CANDIDATES', (dst,))
    got = tdata.image_batches(batch_size=4, seed=0)
    want = jdata.image_batches(batch_size=4, seed=0)
    for _ in range(2):
        g = next(got)
        assert g.shape == (4, 28, 28, 1) and g.dtype == np.float32
        assert np.array_equal(g, next(want))
    rows = np.random.default_rng(0).integers(0, 24, 4)
    assert np.array_equal(next(tdata.image_batches(batch_size=4, seed=0)), LUT[images[rows]][..., None])
