"""The port's public API (vqtpu_torch.__all__) against the JAX package's
(vqtpu.__all__): every public name of vqtpu has its counterpart, under the
same name, at the top of vqtpu_torch; the port adds only its own two
extras. Each subpackage's exports (the names vqtpu/<sub>/__init__.py
imports) resolve in vqtpu_torch.<sub> with the same kind. The four codebook metrics are reached through the top-level names
and agree with JAX's (rtol 1e-6: f32 sums in another order)."""

import ast
import importlib
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqtpu
import vqtpu_torch

from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# names the port has and the JAX package has not: the flagship autoencoder,
# which vqtpu keeps in vqtpu.models, and the weight loader
PORT_EXTRAS = {'SimpleQuantizeAutoEncoder', 'load_vqtpu_state'}


def test_all_lists_every_vqtpu_name():
    assert set(vqtpu_torch.__all__) == set(vqtpu.__all__) | PORT_EXTRAS
    assert len(vqtpu_torch.__all__) == len(set(vqtpu_torch.__all__))


@pytest.mark.parametrize('name', vqtpu.__all__)
def test_each_name_resolves_to_its_kind(name):
    port, ref = getattr(vqtpu_torch, name), getattr(vqtpu, name)
    assert isinstance(port, type) == isinstance(ref, type)
    if isinstance(port, type) and name != 'LossBreakdown':
        assert issubclass(port, torch.nn.Module)


@pytest.mark.parametrize('name', ['codebook_perplexity', 'codebook_utilization'])
def test_index_metrics_match(name):
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 16, (4, 30)).astype(np.int32)
    got = getattr(vqtpu_torch, name)(torch.from_numpy(idx), 16)
    want = getattr(vqtpu, name)(jnp.asarray(idx), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize('name', ['ema_perplexity', 'ema_utilization'])
def test_ema_metrics_match(name):
    cluster_size = np.random.default_rng(1).random((2, 16), dtype=np.float32)
    cluster_size[0, :3] = 0.0
    got = getattr(vqtpu_torch, name)(torch.from_numpy(cluster_size))
    want = getattr(vqtpu, name)(jnp.asarray(cluster_size))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


SUBPACKAGES = ('core', 'codebook', 'quantizers', 'composite', 'models', 'utils', 'parallel', 'kernels')


def _imported_names(sub: str) -> list[str]:
    """The public names vqtpu/<sub>/__init__.py binds by its imports."""
    path = Path(vqtpu.__file__).parent / sub / '__init__.py'
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split('.')[0] for a in node.names]
    return [n for n in names if not n.startswith('_')]


def _kind(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return 'module'
    if isinstance(obj, type):
        return 'class'
    return 'callable' if callable(obj) else 'value'


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_subpackage_exports_match(sub):
    """Every public name the JAX subpackage's __init__ imports resolves in
    the port's subpackage, and is of the same kind: a module where JAX's is
    a module, a class exactly where JAX's is a class, a callable that is
    neither where JAX's is such a callable (vqtpu.codebook.kmeans is the
    function, not its module)."""
    jsub = importlib.import_module(f'vqtpu.{sub}')
    tsub = importlib.import_module(f'vqtpu_torch.{sub}')
    names = _imported_names(sub)
    assert names
    missing = [n for n in names if not hasattr(tsub, n)]
    assert not missing, f'vqtpu_torch.{sub} lacks {missing}'
    kinds = {n: (_kind(getattr(jsub, n)), _kind(getattr(tsub, n))) for n in names}
    assert {n: k for n, k in kinds.items() if k[0] != k[1]} == {}


def test_codebook_kmeans_is_the_function():
    from vqtpu_torch.codebook import kmeans
    from vqtpu_torch.core.sampling import new_stream

    assert callable(kmeans) and not isinstance(kmeans, types.ModuleType)
    samples = torch.randn(1, 64, 4, generator=torch.Generator().manual_seed(0))
    means, bins = kmeans(new_stream(1), samples, 8, num_iters=2)
    assert means.shape == (1, 8, 4) and bins.shape == (1, 8) and int(bins.sum()) == 64
