"""The port's public API (vqtpu_torch.__all__) against the JAX package's
(vqtpu.__all__): every public name of vqtpu has its counterpart, under the
same name, at the top of vqtpu_torch; the port adds only its own two
extras. The four codebook metrics are reached through the top-level names
and agree with JAX's (rtol 1e-6: f32 sums in another order)."""

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
