"""The port's entry points (vqtpu_torch.entry) against __graft_entry__.py,
and LatentQuantize.quantize_and_project against the JAX package's, on the
CPU.

  - entry(device='cpu') from the JAX entry's state (load_vqtpu_state): the
    reconstruction and the commitment loss within 1e-4 of their largest
    entry (the autoencoder's convolutions sum in another order than XLA's,
    as in tests/test_torch_autoencoder.py), indices equal but at near-ties
    (the float64 tie rule of torch_parity); two calls bit-identical and
    the state left as it was.
  - dryrun_multichip(n, backend='gloo', device='cpu') passes every section
    for n = 4 and reports the odd-n skips for n = 1.
  - Config 5's data-parallel step and the code-sharded ResidualVQ's
    tensor-parallel step, the port's in a 4-rank gloo world
    (tests/torch_dist.py::entry_sections_body), the JAX package's on 4 of
    the 8 virtual CPU devices, from the same state and batch: the loss to
    1e-5 relative, every codebook within 1e-5 of its largest entry, and
    the ranks' codebooks bit-identical.
  - The rank launcher (parallel.run_ranks): a failing rank raises with its
    traceback; a calling script without a main guard runs it.
  - quantize_and_project against JAX: codes and outputs to rtol 1e-5,
    atol 1e-6, indices edge-aware as in tests/test_torch_latent.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh

import __graft_entry__
import torch_dist as td
import vqtpu
import vqtpu_torch
from test_torch_latent import _assert_indices_edge_equal
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.entry import Config5Model, TPRVQModel, build_flagship, dryrun_multichip, entry
from vqtpu_torch.parallel import run_ranks
from vqtpu_torch.parallel.multihost import rank_devices

from torch_parity import assert_indices_tie_equal, one_torch_thread  # noqa: F401  (autouse)

WORLD = 4


def _numpy_tree(state) -> dict:
    """An nnx.State -> the nested numpy dict load_vqtpu_state takes."""
    def to_np(leaf):
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(leaf))
        return np.asarray(leaf)
    return jax.tree.map(to_np, nnx.to_pure_dict(state))


def _close_to_largest(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def test_entry_matches_graft_entry():
    jfn, (jstate, jx) = __graft_entry__.entry()
    jrecon, jidx, jloss = jax.jit(jfn)(jstate, jx)

    fn, (state, x) = entry(device='cpu')
    assert x.shape == tuple(jx.shape) == (8, 28, 28, 1) and not x.any()
    assert sorted(state) == sorted(build_flagship(device='cpu').state_dict())
    model = build_flagship(device='cpu')
    load_vqtpu_state(model, _numpy_tree(jstate))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    before = {k: v.clone() for k, v in state.items()}
    recon, idx, loss = fn(state, x)
    again = fn(state, x)
    assert all(torch.equal(a, b) for a, b in zip((recon, idx, loss), again))
    assert all(torch.equal(before[k], v) for k, v in state.items())

    with torch.no_grad():
        z = model.encoder(x)
    assert_indices_tie_equal(z.reshape(1, -1, 32), model.quantizer._codebook.embed, 'euclidean', idx,
                             np.asarray(jidx))
    _close_to_largest(recon.detach().numpy(), jrecon, 1e-4)
    _close_to_largest(loss.detach().numpy(), jloss, 1e-4)


def test_entry_state_takes_gradients():
    """fn is differentiable in the state, as JAX's is."""
    fn, (state, x) = entry(device='cpu')
    weight = state['encoder.conv1.weight'].requires_grad_()
    recon, _, loss = fn(state, x + 0.5)
    (recon.square().mean() + loss).backward()
    assert weight.grad is not None and bool(weight.grad.abs().sum() > 0)


@pytest.mark.parametrize('n', [4, 1])
def test_dryrun_multichip_gloo_cpu(n, capsys, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    out = dryrun_multichip(n, backend='gloo', device='cpu')
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert summary == out['summary'] and summary.startswith(f'dryrun_multichip({n}) ok: dp train loss=')
    assert summary.endswith('group-axis GroupedResidualVQ indices == serial')
    assert out['devices'] == ['cpu'] * n
    for key in ('dp_loss', 'config5_loss'):
        assert np.isfinite(out[key])
    if n % 2 == 0:
        assert out['skipped'] == [] and np.isfinite(out['tp_loss']) and np.isfinite(out['rvq_tp_loss'])
        assert 'skipped' not in summary
        sections = ['dp_autoencoder', 'tp_argmin_bf16', 'sharded_ema_2d', 'tp_vq_65536', 'config5', 'rvq_tp',
                    'group_parallel']
    else:
        assert out['tp_loss'] is None and out['rvq_tp_loss'] is None
        assert summary.count('skipped (odd n)') == 2
        sections = ['dp_autoencoder', 'tp_argmin_bf16', 'config5', 'group_parallel']
    # on the CPU every wrapper takes its plain version: no launch
    for launches in out['launches']:
        assert list(launches) == sections
        assert all(v == 0 for s in launches.values() for v in s.values())


def test_dryrun_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match='NCCL runs on CUDA cards only'):
        dryrun_multichip(2, backend='nccl', device='cpu')
    with pytest.raises(ValueError, match='backend must be'):
        rank_devices(2, 'mpi', 'cpu')
    with pytest.raises(ValueError, match='not importable'):
        run_ranks(lambda rank, world, mesh, device: rank, 2, backend='gloo', device='cpu')


def test_run_ranks_reports_a_failing_rank():
    results = run_ranks(td.echo_body, 2, backend='gloo', device='cpu', timeout=120)
    assert [r['rank'] for r in results] == [0, 1]
    assert all(r['world'] == 2 and r['size'] == 2 and r['device'] == 'cpu' for r in results)
    with pytest.raises(RuntimeError, match='rank 1 fails on purpose'):
        run_ranks(td.failing_body, 2, backend='gloo', device='cpu', timeout=120)


def test_run_ranks_from_a_script_without_a_main_guard(tmp_path):
    """The ranks are fresh interpreters that import the target by name and
    never run the caller's main module again."""
    tests = Path(__file__).resolve().parent
    script = tmp_path / 'caller.py'
    script.write_text(
        'import sys\n'
        f'sys.path[:0] = [{str(tests)!r}, {str(tests.parent)!r}]\n'
        'import torch_dist\n'
        'from vqtpu_torch.parallel import run_ranks\n'
        "print('ranks', [r['rank'] for r in run_ranks(torch_dist.echo_body, 2, backend='gloo', device='cpu',"
        ' timeout=120)])\n')
    done = subprocess.run([sys.executable, str(script)], cwd=tests.parent, capture_output=True, text=True,
                          timeout=180)
    assert done.returncode == 0, done.stderr
    assert done.stdout.count('ranks [0, 1]') == 1


def test_run_ranks_runs_a_target_of_the_main_script(tmp_path):
    """A target defined in the script that runs as the main program, and a
    function of that script among the keyword arguments: the ranks import
    the script from its file under the name multiprocessing's spawn gives
    it, so its main guard keeps the script's main from running again."""
    tests = Path(__file__).resolve().parent
    script = tmp_path / 'driver.py'
    script.write_text(
        'import sys\n'
        f'sys.path[:0] = [{str(tests.parent)!r}]\n'
        'from vqtpu_torch.parallel import run_ranks\n\n'
        'def body(rank, world, mesh, out, device):\n'
        '    return (rank, world, mesh.axis_names, mesh.shape, out, device, __name__)\n\n'
        'def adapter(rank, world, mesh, device, body, out):\n'
        '    return body(rank, world, mesh, out, device=device)\n\n'
        "if __name__ == '__main__':\n"
        "    print('main ran')\n"
        "    print(run_ranks(adapter, 2, backend='gloo', device='cpu', axes=('data', 'code'), shape=(1, 2),\n"
        "                    kwargs=dict(body=body, out='x'), timeout=120))\n")
    done = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True, text=True, timeout=180)
    assert done.returncode == 0, done.stderr
    lines = done.stdout.strip().splitlines()
    assert lines[0] == 'main ran' and len(lines) == 2
    assert lines[1] == str([(r, 2, ('data', 'code'), (1, 2), 'x', 'cpu', '__mp_main__') for r in range(2)])


# -- config 5 and the code-sharded ResidualVQ against the JAX package --------------


class JaxConfig5Model(nnx.Module):
    """__graft_entry__.py:226-239."""

    def __init__(self, rngs):
        self.enc = nnx.Linear(8, 16, rngs=rngs)
        self.grvq = vqtpu.GroupedResidualVQ(dim=16, groups=2, num_quantizers=2, codebook_size=32, sync_axis='data',
                                            rngs=rngs)
        self.sim = vqtpu.SimVQ(dim=16, codebook_size=32, rotation_trick=True, rngs=rngs)
        self.dec = nnx.Linear(16, 8, rngs=rngs)

    def __call__(self, x):
        q, _, losses = self.grvq(self.enc(x))
        q2, _, sim_loss = self.sim(q)
        return self.dec(q2), losses.sum() + sim_loss


class JaxTPRVQModel(nnx.Module):
    """__graft_entry__.py:267-279."""

    def __init__(self, rngs, n_devices):
        self.enc = nnx.Linear(8, 16, rngs=rngs)
        self.rvq = vqtpu.ResidualVQ(dim=16, num_quantizers=2, codebook_size=16 * n_devices, sync_axis='data',
                                    code_axis='code', rngs=rngs)
        self.dec = nnx.Linear(16, 8, rngs=rngs)

    def __call__(self, x):
        q, _, losses = self.rvq(self.enc(x))
        return self.dec(q), losses.sum()


def _jax_recon_plus_aux(m, b):
    out, aux = m(b)
    return ((out - b) ** 2).mean() + aux


def _jax_codebooks(rvqs):
    return [{k: np.asarray(getattr(layer._codebook, k)[...]) for k in ('embed', 'embed_avg', 'cluster_size')}
            for rvq in rvqs for layer in rvq.layers]


@pytest.fixture(scope='module')
def sections():
    """The JAX steps in this process and the port's in a 4-rank world, from
    the same states and batches."""
    from vqtpu.parallel import DataParallelTrainer, TensorParallelTrainer

    rng = np.random.default_rng(15)
    c5_batch = rng.standard_normal((2 * WORLD, 4, 8), dtype=np.float32)
    rvq_batch = rng.standard_normal((4 * WORLD, 4, 8), dtype=np.float32)
    devices = np.array(jax.devices()[:WORLD])

    c5 = JaxConfig5Model(nnx.Rngs(0))
    c5_state = _numpy_tree(nnx.state(c5))
    c5_loss = DataParallelTrainer(c5, optax.adamw(3e-4), _jax_recon_plus_aux, Mesh(devices, ('data',))).step(
        jnp.asarray(c5_batch))
    rvq = JaxTPRVQModel(nnx.Rngs(0), WORLD)
    rvq_state = _numpy_tree(nnx.state(rvq))
    rvq_loss = TensorParallelTrainer(rvq, optax.adamw(3e-4), _jax_recon_plus_aux,
                                     Mesh(devices.reshape(2, WORLD // 2), ('data', 'code'))).step(
        jnp.asarray(rvq_batch))
    jax_side = dict(c5_loss=float(c5_loss), c5_codebooks=_jax_codebooks(c5.grvq.rvqs), rvq_loss=float(rvq_loss),
                    rvq_codebooks=_jax_codebooks([rvq.rvq]), c5_after=_numpy_tree(nnx.state(c5)),
                    rvq_after=_numpy_tree(nnx.state(rvq)))
    ranks = td.run_world(td.entry_sections_body, world=WORLD,
                         c5_state=c5_state, c5_batch=c5_batch, rvq_state=rvq_state, rvq_batch=rvq_batch)
    return jax_side, ranks


@pytest.mark.parametrize('which', ['c5', 'rvq'])
def test_dryrun_step_matches_jax(sections, which):
    jax_side, ranks = sections
    want_loss, want = jax_side[f'{which}_loss'], jax_side[f'{which}_codebooks']
    got = ranks[0][f'{which}_codebooks']
    assert len(got) == len(want) == (4 if which == 'c5' else 2)
    np.testing.assert_allclose(ranks[0][f'{which}_loss'], want_loss, rtol=1e-5, atol=0)
    for g, w in zip(got, want):
        for k in w:
            assert g[k].shape == w[k].shape, k
            _close_to_largest(g[k], w[k], 1e-5)
    for r in ranks[1:]:
        assert r[f'{which}_loss'] == ranks[0][f'{which}_loss']
        for a, b in zip(r[f'{which}_codebooks'], got):
            assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize('which', ['c5', 'rvq'])
def test_dryrun_step_state_matches_jax(sections, which):
    """The whole state after the step (the Linears, SimVQ's transform, the
    codebooks and their statistics), so the backward and the AdamW update
    too: JAX's state after its step, carried across by load_vqtpu_state,
    against the port's, every tensor within 1e-5 of its largest entry."""
    jax_side, ranks = sections
    model = Config5Model('cpu') if which == 'c5' else TPRVQModel(16 * WORLD, 'cpu')
    load_vqtpu_state(model, jax_side[f'{which}_after'])
    want = model.state_dict()
    got = ranks[0][f'{which}_state']
    assert sorted(got) == sorted(want)
    assert any(k.endswith('weight') for k in want)
    for k, w in want.items():
        assert got[k].shape == tuple(w.shape), k
        if w.is_floating_point():
            _close_to_largest(got[k], w.numpy(), 1e-5)
        else:
            assert np.array_equal(got[k], w.numpy()), k
    for r in ranks[1:]:
        assert all(np.array_equal(r[f'{which}_state'][k], got[k]) for k in got)


# -- LatentQuantize.quantize_and_project ------------------------------------------------

QP_CASES = {
    'projected': dict(levels=[5, 5, 8], dim=9),
    'two_codebooks': dict(levels=[5, 6], dim=8, num_codebooks=2),
    'frozen_values': dict(levels=[5, 5, 8], dim=3, optimize_values=False),
}


@pytest.mark.parametrize('with_ps', [True, False], ids=['ps', 'no_ps'])
@pytest.mark.parametrize('case', sorted(QP_CASES))
def test_quantize_and_project_matches_jax(case, with_ps):
    kw = QP_CASES[case]
    jm = vqtpu.LatentQuantize(**kw, rngs=nnx.Rngs(0))
    tm = vqtpu_torch.LatentQuantize(**kw, device='cpu')
    load_vqtpu_state(tm, _numpy_tree(nnx.state(jm)))
    x = np.random.default_rng(len(case)).standard_normal((2, kw['dim'], 4, 5), dtype=np.float32) * 0.6

    def tokens(m, z, move, project):
        z = move(z)
        ps = tuple(z.shape)
        z = z.reshape(z.shape[0], -1, m.dim)
        if m.project_in is not None:
            z = project(m, z)
        return z.reshape(*z.shape[:-1], m.num_codebooks, m.codebook_dim), ps

    jz, ps = tokens(jm, jnp.asarray(x), lambda z: jnp.moveaxis(z, 1, -1), lambda m, z: m.project_in(z))
    jcodes, jout, jidx = jm.quantize_and_project(jz, True, ps if with_ps else None)
    with torch.no_grad():
        tz, tps = tokens(tm, torch.from_numpy(x), lambda z: z.movedim(1, -1), lambda m, z: m.project_in(z))
        codes, out, idx = tm.quantize_and_project(tz, True, tps if with_ps else None)
        quantized, indices, _ = tm.eval()(torch.from_numpy(x))
    assert tps == ps and codes.shape == jcodes.shape and out.shape == jout.shape and idx.shape == jidx.shape
    assert idx.dtype == torch.int32
    np.testing.assert_allclose(codes.numpy(), np.asarray(jcodes), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    if with_ps:
        _assert_indices_edge_equal(tm, x, idx, jidx)
        assert torch.equal(out, quantized) and torch.equal(idx, indices)
    else:
        _assert_indices_edge_equal(tm, x, idx.reshape(indices.shape), np.asarray(jidx).reshape(indices.shape))
        assert out.shape == (2, tm.dim, 20) and torch.equal(out.reshape(quantized.shape), quantized)
