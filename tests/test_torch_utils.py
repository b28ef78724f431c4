"""The port's utilities (vqtpu_torch.utils) on the CPU: checkpoints,
upstream state import against the JAX package's `import_torch_state`, and
profiling.

- Checkpoints mirror tests/test_checkpoint.py: a state_dict snapshot of a
  trained VectorQuantize, ResidualVQ, SimVQ and LatentQuantize loaded into a
  module built from another seed gives bit-equal eval outputs; the file
  round trip (torch.save, torch.load(weights_only=True)) likewise; a
  restored VectorQuantize trains on to bit-identical codebooks; derived
  tensors (levels, bases, bit masks, scales) are not in the state.
- `import_torch_state`: the upstream package (lucidrains
  vector-quantize-pytorch) is not installed here, so each upstream-keyed
  state_dict is built from seeded numpy under the keys that
  vqtpu/utils/torch_import.py reads, with the shapes of the port module's
  own tensors. Both importers load it into fresh modules, and their eval
  outputs are held to each other: indices equal, values to rtol 1e-5,
  atol 1e-5 (f32 projections summed in another order by XLA).
- `timeit_chained` returns a positive time on the CPU; `trace` writes a
  Chrome trace holding an `annotate` label.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vqtpu
import vqtpu.utils as jutils
import vqtpu_torch
from vqtpu_torch.utils import (
    DERIVED_STATE_DOC, annotate, import_torch_state, load_state_dict, restore_checkpoint, save_checkpoint,
    state_dict, timeit_chained, trace,
)

from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _eq(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _outputs(out):
    return [t for t in out if isinstance(t, torch.Tensor)]


CHECKPOINT_CASES = {
    'VectorQuantize': (lambda: vqtpu_torch.VectorQuantize(dim=8, codebook_size=16, decay=0.8,
                                                          threshold_ema_dead_code=2, device='cpu'), (4, 10, 8)),
    'ResidualVQ': (lambda: vqtpu_torch.ResidualVQ(dim=8, num_quantizers=3, codebook_size=16, device='cpu'),
                   (2, 10, 8)),
    'SimVQ': (lambda: vqtpu_torch.SimVQ(dim=8, codebook_size=16, device='cpu'), (2, 10, 8)),
    # channel-first (b, d, n)
    'LatentQuantize': (lambda: vqtpu_torch.LatentQuantize(levels=[5, 5, 8], dim=9, device='cpu'), (2, 9, 10)),
}


@pytest.mark.parametrize('name', sorted(CHECKPOINT_CASES))
def test_state_dict_round_trip(name):
    build, shape = CHECKPOINT_CASES[name]
    x = torch.from_numpy(np.random.default_rng(len(name)).standard_normal(shape, dtype=np.float32))
    torch.manual_seed(0)
    m1 = build().train()
    m1(x)                                       # move the EMA and the stateful parts
    torch.manual_seed(123)
    m2 = build()
    load_state_dict(m2, state_dict(m1))
    with torch.no_grad():
        _eq(_outputs(m1.eval()(x)), _outputs(m2.eval()(x)))


def test_checkpoint_file_round_trip(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 10, 8), dtype=np.float32))
    torch.manual_seed(0)
    vq = vqtpu_torch.VectorQuantize(dim=8, codebook_size=16, decay=0.8, device='cpu').train()
    vq(x)
    q1, i1, _ = vq.eval()(x)
    save_checkpoint(tmp_path / 'ckpt.pt', vq)
    torch.manual_seed(42)
    vq2 = vqtpu_torch.VectorQuantize(dim=8, codebook_size=16, decay=0.8, device='cpu')
    restore_checkpoint(tmp_path / 'ckpt.pt', vq2)
    q2, i2, _ = vq2.eval()(x)
    assert torch.equal(i1, i2) and torch.equal(q1, q2)
    # the snapshot is a copy: a later step does not move it
    snapshot = state_dict(vq)
    vq.train()(x * 2)
    assert not torch.equal(snapshot['_codebook.embed'], vq._codebook.embed)


def test_checkpoint_resumes_training_trajectory():
    xs = [torch.from_numpy(np.random.default_rng(7 + i).standard_normal((4, 10, 8), dtype=np.float32))
          for i in range(5)]
    torch.manual_seed(0)
    vq = vqtpu_torch.VectorQuantize(dim=8, codebook_size=16, decay=0.8, device='cpu').train()
    for x in xs[:3]:
        vq(x)
    d = state_dict(vq)
    torch.manual_seed(9)
    resumed = vqtpu_torch.VectorQuantize(dim=8, codebook_size=16, decay=0.8, device='cpu').train()
    load_state_dict(resumed, d)
    for x in xs[3:]:
        vq(x)
        resumed(x)
    assert torch.equal(vq._codebook.embed, resumed._codebook.embed)


def test_derived_state_is_not_checkpointed():
    derived = ('levels_f32', 'basis_i32', 'bit_mask', 'scales_f32')
    modules = [vqtpu_torch.FSQ([8, 5, 5], device='cpu'), vqtpu_torch.LFQ(dim=8, codebook_size=2 ** 8, device='cpu'),
               vqtpu_torch.ResidualFSQ(dim=3, levels=[8, 5, 5], num_quantizers=2, device='cpu')]
    for m in modules:
        keys = list(state_dict(m))
        assert not [k for k in keys if k.rsplit('.', 1)[-1] in derived], keys
    assert 'derived' in DERIVED_STATE_DOC and 'generator' in DERIVED_STATE_DOC


# -- import_torch_state ----------------------------------------------------------

# name: (class, kwargs, input shape, upstream renames of the port's keys,
# upstream keys stored transposed)
IMPORT_CASES = {
    'VectorQuantize': ('VectorQuantize', dict(dim=8, codebook_size=16, codebook_dim=4), (2, 6, 8),
                       [('project_in_linear.', 'project_in.'), ('project_out_linear.', 'project_out.')], ()),
    'VectorQuantize_layernorm': ('VectorQuantize', dict(dim=8, codebook_size=16, codebook_dim=4,
                                                        layernorm_after_project_in=True), (2, 6, 8),
                                 [('project_in_linear.', 'project_in.0.'), ('project_in_norm.', 'project_in.1.'),
                                  ('project_out_linear.', 'project_out.')], ()),
    'ResidualVQ': ('ResidualVQ', dict(dim=8, num_quantizers=2, codebook_size=16, codebook_dim=4), (2, 6, 8), [], ()),
    'GroupedResidualVQ': ('GroupedResidualVQ', dict(dim=8, groups=2, num_quantizers=2, codebook_size=16),
                          (2, 6, 8), [], ()),
    'SimVQ': ('SimVQ', dict(dim=8, codebook_size=16), (2, 6, 8), [], ()),
    'ResidualSimVQ': ('ResidualSimVQ', dict(dim=8, num_quantizers=2, codebook_size=16), (2, 6, 8), [], ()),
    'LatentQuantize': ('LatentQuantize', dict(levels=[5, 5, 8], dim=9), (2, 9, 6), [], ()),
    'RandomProjectionQuantizer': ('RandomProjectionQuantizer',
                                  dict(dim=8, codebook_size=16, codebook_dim=4, num_codebooks=2), (2, 6, 8),
                                  [('project_in_linear.', 'project_in.'), ('project_out_linear.', 'project_out.')],
                                  ()),
    'HierarchicalVQ_shared': ('HierarchicalVQ', dict(dim=8, codebook_size=16, scales=(1, 2, 4), accept_image_fmap=True),
                              (2, 8, 4, 4), [('phi_levels.0.', 'phi_shared.')], ()),
    'HierarchicalVQ_levels': ('HierarchicalVQ', dict(dim=8, codebook_size=16, scales=(1, 2, 4), share_quant_resi=3,
                                                     accept_image_fmap=True), (2, 8, 4, 4), [], ()),
    'FSQ': ('FSQ', dict(levels=[8, 5, 5], dim=8), (2, 6, 8), [], ()),
    'FSP': ('FSP', dict(levels=[8, 6, 5], dim=8), (2, 6, 8), [], ()),
    'LFQ_cosine': ('LFQ', dict(dim=8, codebook_size=2 ** 4, cosine_sim_project_in=True), (2, 6, 8), [],
                   ('project_in.weight',)),
    'ResidualFSQ': ('ResidualFSQ', dict(dim=8, levels=[8, 5, 5], num_quantizers=2), (2, 6, 8), [], ()),
    'ResidualLFQ': ('ResidualLFQ', dict(dim=8, codebook_size=2 ** 4, num_quantizers=2), (2, 6, 8), [], ()),
    'GroupedResidualFSQ': ('GroupedResidualFSQ', dict(dim=8, groups=2, levels=[8, 5, 5], num_quantizers=2),
                           (2, 6, 8), [], ()),
    'GroupedResidualLFQ': ('GroupedResidualLFQ', dict(dim=8, groups=2, codebook_size=2 ** 4, num_quantizers=2),
                           (2, 6, 8), [], ()),
    'BinaryMapper': ('BinaryMapper', dict(bits=4, deterministic_on_eval=True), (2, 6, 4), [], ()),
}


def upstream_state(tm, renames, transposed, seed):
    """An upstream-keyed state_dict of numpy arrays shaped like the port
    module's tensors: its keys renamed to upstream's, floats drawn from a
    seeded normal (cluster sizes positive), flags True."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in tm.state_dict().items():
        if '.accum_' in key:              # the manual EMA's accumulators: no upstream buffer
            continue
        if key.rpartition('.')[2] == 'rng_state':     # the port's random stream: no upstream buffer
            continue
        for port, upstream in renames:
            key = key.replace(port, upstream)
        shape = tuple(value.shape)
        if value.dtype == torch.bool:
            out[key] = np.array(True)
            continue
        a = rng.standard_normal(shape).astype(np.float32)
        if key.endswith('cluster_size'):
            a = np.abs(a) + 1.0
        if key.endswith('variance'):
            a = np.abs(a) + 0.5
        out[key] = a.T.copy() if key in transposed else a
    return out


def _arrays(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _arrays(o)]
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _arrays(out[k])]
    if isinstance(out, (torch.Tensor, jax.Array)):
        return [np.asarray(out.detach() if isinstance(out, torch.Tensor) else out)]
    return []


@pytest.mark.parametrize('case', sorted(IMPORT_CASES))
def test_import_torch_state_matches_jax(case):
    cls, kwargs, shape, renames, transposed = IMPORT_CASES[case]
    jm = getattr(vqtpu, cls)(**kwargs, rngs=nnx.Rngs(0))
    torch.manual_seed(0)
    tm = getattr(vqtpu_torch, cls)(**kwargs, device='cpu')
    sd = upstream_state(tm, renames, transposed, seed=len(case))
    jutils.import_torch_state(jm, sd)
    import_torch_state(tm, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    for key, value in tm.state_dict().items():
        # every tensor the upstream state names was written
        upstream = key
        for port, up in renames:
            upstream = upstream.replace(port, up)
        if upstream in sd and value.dtype != torch.bool:
            want = sd[upstream].T if upstream in transposed else sd[upstream]
            np.testing.assert_array_equal(value.numpy(), want, err_msg=key)
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = _arrays(tm(torch.from_numpy(x)))
    want = _arrays(jm(jnp.asarray(x)))
    assert len(got) == len(want) and got, (len(got), len(want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_import_torch_state_refuses_other_modules():
    for module in (torch.nn.Linear(2, 2), vqtpu_torch.Sequential(torch.nn.Identity(),
                                                                    vqtpu_torch.FSQ([5, 5], device='cpu'))):
        with pytest.raises(NotImplementedError, match=re.escape(type(module).__name__)):
            import_torch_state(module, {})
    with pytest.raises(ValueError, match='shape mismatch'):
        import_torch_state(vqtpu_torch.SimVQ(dim=8, codebook_size=16, device='cpu'),
                           {'frozen_codebook': np.zeros((3, 8), np.float32)})


# -- profiling ------------------------------------------------------------------


def test_timeit_chained_returns_a_positive_time():
    a = torch.randn(192, 192)
    per_call = timeit_chained(lambda m: m @ m @ m, a)
    assert per_call > 0.0
    with pytest.raises(ValueError):
        timeit_chained(lambda m: m, a, lo=4, hi=4)


def test_trace_holds_the_annotation(tmp_path):
    with trace(tmp_path):
        with annotate('vqtpu_torch_label'):
            torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    assert any(e.get('name') == 'vqtpu_torch_label' for e in events)


def test_utils_exports_the_jax_names():
    import vqtpu_torch.utils as tutils
    names = ('state_dict', 'load_state_dict', 'save_checkpoint', 'restore_checkpoint', 'DERIVED_STATE_DOC',
             'trace', 'annotate', 'timeit_chained', 'import_torch_state')
    assert all(hasattr(jutils, n) for n in names)
    assert all(hasattr(tutils, n) for n in names)
