"""The arithmetic of the tensor-core selection kernel (vqtpu_torch/kernels/
csrc/select_tf32.cuh), emulated in numpy on the CPU, where the kernel cannot
run.

The kernel splits every f32 operand v into two TF32 values, v ~= big + small
(big rounded to nearest by cvt.rna.tf32.f32, small the remainder rounded the
same way), and sums xs.eb, xb.es and xb.eb per k8 step into one f32
accumulator. The emulation does the same: the TF32 pieces by bit masks,
each product exact in f32 (two 11-bit significands), the sums rounded in f32
one term at a time, in the kernel's order of dims within a 32-dim chunk. The
tensor cores' own order and rounding of the sum are not specified bit for
bit, so this shows the accuracy of the algebra, not the kernel's bits.
Both split rules (round to nearest, and truncation, the cheaper mask) are
held to f32 accuracy:

  - the split itself: big has its 13 low bits clear, x - big is exact in
    f32, and |x - big - small| <= 2^-20 |x|;
  - the scores: within 1e-6 * ||x|| * ||e|| of float64, at a ragged d.

Selection, ties and rows of the kernel itself are held to
`nearest_code_plain` on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

RULES = ('nearest', 'truncate')
LOW_BITS = np.uint32(0x1FFF)  # the 13 mantissa bits f32 has beyond TF32's 10


def tf32(v: np.ndarray, rule: str) -> np.ndarray:
    """f32 -> the nearest TF32 value (ties away from zero, as cvt.rna), or
    the TF32 value truncated towards zero."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    if rule == 'nearest':
        bits = bits + np.uint32(0x1000)
    return (bits & ~LOW_BITS).view(np.float32)


def split(v: np.ndarray, rule: str) -> tuple[np.ndarray, np.ndarray]:
    big = tf32(v, rule)
    return big, tf32(v - big, rule)


def packed_dim(p: int) -> int:
    """The dim of position p of a 32-dim chunk in the kernel's k order."""
    j, q = p >> 3, p & 7
    return 8 * q + 2 * j if q < 4 else 8 * (q - 4) + 2 * j + 1


def emulated_scores(x: np.ndarray, e: np.ndarray, rule: str) -> np.ndarray:
    """(n, d), (c, d) f32 -> (n, c) f32 scores as the kernel sums them: per
    k8 step xs.eb, xb.es, then xb.eb, each product exact, every add rounded
    to f32."""
    d = x.shape[1]
    xb, xs = split(x, rule)
    eb, es = split(e, rule)
    acc = np.zeros((x.shape[0], e.shape[0]), np.float32)
    for k0 in range(0, d, 32):
        order = [k0 + packed_dim(p) for p in range(32)]
        for step in range(4):
            dims = [k for k in order[8 * step:8 * step + 8] if k < d]
            for a, b in ((xs, eb), (xb, es), (xb, eb)):
                for k in dims:
                    acc += a[:, k, None] * b[None, :, k]
    return acc


def _operands(n, c, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d), dtype=np.float32), rng.standard_normal((c, d), dtype=np.float32)


@pytest.mark.parametrize('rule', RULES)
def test_split_pieces(rule):
    v = np.random.default_rng(1).standard_normal(1 << 16, dtype=np.float32) * np.float32(3.0)
    big, small = split(v, rule)
    assert not (big.view(np.uint32) & LOW_BITS).any() and not (small.view(np.uint32) & LOW_BITS).any()
    rem = v - big
    assert np.array_equal(rem.astype(np.float64), v.astype(np.float64) - big.astype(np.float64))
    err = np.abs(v.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert (err <= 2.0 ** -20 * np.abs(v.astype(np.float64))).all()
    # the products the kernel makes are exact in f32
    prod = big[:-1] * small[1:]
    assert np.array_equal(prod.astype(np.float64), big[:-1].astype(np.float64) * small[1:].astype(np.float64))


@pytest.mark.parametrize('rule', RULES)
def test_scores_within_f32_accuracy(rule):
    x, e = _operands(200, 130, 30, seed=2)
    got = emulated_scores(x, e, rule).astype(np.float64)
    want = x.astype(np.float64) @ e.astype(np.float64).T
    scale = np.linalg.norm(x.astype(np.float64), axis=1)[:, None] * np.linalg.norm(e.astype(np.float64), axis=1)
    assert (np.abs(got - want) <= 1e-6 * scale).all(), float((np.abs(got - want) / scale).max())
