"""Native IDX dataset loader: the file is mmap'd once and batches are
gathered and normalized to [-1, 1] in one C pass (native/vqdata.c) into a
float32 buffer (counterpart of vqtpu/models/native_data.py).

Batches are numpy arrays on the host; moving them to the device is the
trainer's job. `models/data.py` falls back to other sources when the
library or the file is missing.
"""

from __future__ import annotations

import ctypes
import queue
import threading

import numpy as np

from . import native_build


class IdxDataset:
    """An mmap'd IDX (MNIST-format) image file with a native batch gather."""

    def __init__(self, path: str):
        lib = native_build.load()
        if lib is None:
            raise RuntimeError('native vqdata runtime unavailable')
        handle = lib.vq_idx_open(path.encode())
        if not handle:
            raise FileNotFoundError(f'not a readable IDX image file: {path}')
        self._lib = lib
        self._handle = handle
        self.count = int(lib.vq_idx_count(handle))
        self.rows = int(lib.vq_idx_rows(handle))
        self.cols = int(lib.vq_idx_cols(handle))

    def gather(self, indices: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
        """(b,) int indices -> (b, rows, cols) float32 in [-1, 1], written
        into `out` when given (reused across calls)."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        b = indices.shape[0]
        if out is None:
            out = np.empty((b, self.rows, self.cols), np.float32)
        if out.shape != (b, self.rows, self.cols) or out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError(f'out must be a contiguous float32 array of shape {(b, self.rows, self.cols)}')
        rc = self._lib.vq_idx_gather_f32(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise IndexError('index out of range in native gather')
        return out

    def close(self):
        if self._handle:
            self._lib.vq_idx_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchLoader:
    """Background-thread prefetch ring over `IdxDataset.gather`.

    ctypes releases the GIL for the C gather, so the next batches are
    prepared while the trainer runs the current step. Every slot is a fresh
    buffer (never reused), so a batch handed out stays valid while the next
    ones are written (`torch.from_numpy` shares its memory).

    Iterates forever: `for batch in PrefetchLoader(ds, 256): ...` yields
    (b, rows, cols, 1) float32 in [-1, 1] (channel_last) or (b, 1, rows,
    cols). The indices are those of `np.random.default_rng(seed).integers(0,
    count, batch_size)`, one draw a batch. A worker that fails raises its
    error from `__next__` instead of leaving the consumer waiting.
    """

    def __init__(
        self,
        dataset: IdxDataset,
        batch_size: int,
        seed: int = 0,
        depth: int = 3,
        channel_last: bool = True,
    ):
        self._ds = dataset
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None

        def worker():
            rng = np.random.default_rng(seed)
            while not self._stop.is_set():
                idx = rng.integers(0, dataset.count, batch_size)
                out = np.empty((batch_size, dataset.rows, dataset.cols), np.float32)
                try:
                    dataset.gather(idx, out)
                except Exception as e:          # dataset closed, bad file: surface it
                    self._error = e
                    return
                batch = out[..., None]
                if not channel_last:
                    batch = np.moveaxis(batch, -1, 1)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.25)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        # poll with a timeout, so that a dead worker raises instead of hanging
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError('prefetch worker died') from self._error
                if not self._thread.is_alive():
                    raise StopIteration

    def close(self):
        """Stop and join the worker; call it before closing the dataset (the
        mmap must outlive any gather in flight)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_idx(path: str, images: np.ndarray) -> None:
    """Write (n, rows, cols) uint8 images as an IDX file (for tests, and to
    convert a cached dataset into the native loader's format)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, rows, cols = images.shape
    with open(path, 'wb') as f:
        f.write((0x00000803).to_bytes(4, 'big'))
        f.write(n.to_bytes(4, 'big'))
        f.write(rows.to_bytes(4, 'big'))
        f.write(cols.to_bytes(4, 'big'))
        f.write(images.tobytes())
