"""The compiled step on the CPU: the kernels as `torch.ops.vqtpu` custom ops
and the port's paths under `torch.compile(..., fullgraph=True)` with the
`aot_eager` backend (no code generation), held to the eager port and, where
the JAX package runs the same path, to it.

  - `torch.library.opcheck` on every op (schema, fake, autograd where
    registered, AOT dispatch with dynamic shapes), small CPU inputs.
  - The entry forward `fn(state, x)` compiled: against the eager call and
    against `jax.jit(fn)` of `__graft_entry__.entry()` from the same state
    (load_vqtpu_state), with the tolerances of tests/test_torch_entry.py;
    the state and the model's generators left as they were.
  - Three steps of the VQ example (`examples/common.py::train_step`,
    forward, `torch.autograd.grad` and the AdamW update in one graph)
    against three eager steps of a twin: outputs, parameters, buffers and
    the optimizer's state within 1e-5 of their largest entry, indices by
    the float64 tie rule.
  - VectorQuantize eval (against eager and JAX, the tolerances of
    tests/test_torch_vq.py) and three 'on' training steps with the gradient
    reaching x (against eager and JAX, those of tests/test_torch_vq_train.py).
  - The LFQ 'on' training step with x.grad (against eager and JAX, those of
    tests/test_torch_lfq.py).
  - ResidualFSQ eval with eval_fused='on' (against eager, bit for bit, and
    against the JAX loop's values).
  - A recording backend: each captured graph (forward and backward) holds
    the expected `torch.ops.vqtpu` nodes, the kernel op and not a
    decomposition (no argmax standing in for the selection).
"""

import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch._dynamo.backends.common import aot_autograd

import __graft_entry__
import vqtpu
import vqtpu_torch
from test_torch_entry import _close_to_largest, _numpy_tree
from test_torch_lfq import _pair as lfq_pair
from test_torch_lfq import _train_both as lfq_train_both
from test_torch_vq import _pair as vq_eval_pair
from test_torch_vq_train import SHAPE as VQ_TRAIN_SHAPE
from test_torch_vq_train import _assert_states_close, _codebook_space, _flat_indices, _jax_step
from test_torch_vq_train import _pair as vq_train_pair
from torch_parity import assert_indices_tie_equal, jax_state, one_torch_thread  # noqa: F401  (autouse)
from vqtpu_torch import load_vqtpu_state
from vqtpu_torch.core.compile import compile_step
from vqtpu_torch.core.utils import module_generators
from vqtpu_torch.entry import build_flagship, entry
from vqtpu_torch.examples import autoencoder as vq_example
from vqtpu_torch.examples.common import adamw, train_step
from vqtpu_torch.kernels import distance as kd
from vqtpu_torch.kernels import lfq_entropy as kl
from vqtpu_torch.kernels import residual_fsq_fused as kr

tkmeans = importlib.import_module('vqtpu_torch.codebook.kmeans')

BACKEND = 'aot_eager'
REL = 1e-5


@pytest.fixture(autouse=True)
def fresh_dynamo():
    """Each test compiles from a clean cache: the steps of several tests
    share code objects, and their recompilations would add up."""
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _assert_close_to_largest(got, want, rel=REL, what=''):
    got, want = torch.as_tensor(got).detach().double(), torch.as_tensor(want).detach().double()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * scale, f'{what}: {err} > {rel} * {scale}'


# -- opcheck on every op -----------------------------------------------------------


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def _op_case(name):
    rng = np.random.default_rng(len(name))
    x2, e2 = _randn(rng, 40, 8), _randn(rng, 16, 8)
    x3, e3 = _randn(rng, 2, 40, 8), _randn(rng, 2, 16, 8)
    b2, b3 = kd.selection_bias(e2, 'euclidean'), kd.selection_bias(e3, 'euclidean')
    w3 = torch.from_numpy((rng.random((2, 40)) > 0.3).astype(np.float32))
    idx2 = torch.from_numpy(rng.integers(0, 16, 40).astype(np.int32))
    idx3 = torch.from_numpy(rng.integers(0, 16, (2, 40)).astype(np.int32))
    d = 5
    k, v, inv_temp, eps = 1 << d, kl.code_magnitude(d, 1.0, True), 1.0, 1e-5
    lx, lw = _randn(rng, 24, d), torch.from_numpy((rng.random(24) > 0.2).astype(np.float32))
    _, _, logz = kl.entropy_fwd_plain(lx, lw, k, v, inv_temp, eps)
    entbar, gbar = _randn(rng, 24), _randn(rng, k)
    levels, q = [8, 5, 5, 5], 3
    clamp = [1.0 + 1.0 / (lv - 1) for lv in levels]
    ops = torch.ops.vqtpu
    cases = {
        'nearest_code': (ops.nearest_code, (x2, e2, b2)),
        'nearest_code_heads': (ops.nearest_code, (x3, e3, b3)),
        'nearest_code_best': (ops.nearest_code_best, (x2, e2, b2)),
        'quantize_lookup': (ops.quantize_lookup, (x2, e2.clone().requires_grad_(), b2)),
        'quantize_lookup_heads': (ops.quantize_lookup, (x3, e3.clone().requires_grad_(), b3)),
        'fused_train': (ops.fused_train, (x2, e2, b2, None)),
        'fused_train_weighted_heads': (ops.fused_train, (x3, e3, b3, w3)),
        'code_sums': (ops.code_sums, (x2, idx2, 16, None)),
        'code_sums_weighted_heads': (ops.code_sums, (x3, idx3, 16, w3)),
        'lfq_entropy': (ops.lfq_entropy, (lx.clone().requires_grad_(), lw.clone().requires_grad_(), k, v, inv_temp,
                                          eps)),
        'lfq_entropy_backward': (ops.lfq_entropy_backward, (lx, lw, logz, entbar, gbar, k, v, inv_temp, eps, True)),
        'lfq_entropy_backward_no_dx': (ops.lfq_entropy_backward,
                                       (lx, lw, logz, entbar, gbar, k, v, inv_temp, eps, False)),
        'residual_fsq_eval': (ops.residual_fsq_eval,
                              (_randn(rng, 2, 30, 4) * 2, kr.canonical_scales(levels, q), levels, clamp, q)),
        'random_words': (ops.random_words, (torch.tensor([7, 9, (1 << 32) - 3]), 50)),
        'kmeans': (ops.kmeans, (x3, torch.tensor([7, 9, 0]), 6, 3, False, w3 > 0, None, None, torch.tensor(False))),
        'kmeans_skipped': (ops.kmeans, (x3, torch.tensor([7, 9, 0]), 6, 3, False, None, None, None, torch.tensor(True))),
    }
    return cases[name]


OP_CASES = ('nearest_code', 'nearest_code_heads', 'nearest_code_best', 'quantize_lookup', 'quantize_lookup_heads',
            'fused_train', 'fused_train_weighted_heads', 'code_sums', 'code_sums_weighted_heads', 'lfq_entropy',
            'lfq_entropy_backward', 'lfq_entropy_backward_no_dx', 'residual_fsq_eval', 'random_words', 'kmeans',
            'kmeans_skipped')


@pytest.mark.parametrize('name', OP_CASES)
def test_opcheck(name):
    op, args = _op_case(name)
    torch.library.opcheck(op, args)


def test_every_kernel_entry_point_is_an_op():
    """Each wrapper of a hand-written kernel calls its op: the CPU
    implementation is the plain version, and the op is registered for
    CUDA tensors too (the kernel)."""
    names = {'nearest_code', 'nearest_code_best', 'quantize_lookup', 'fused_train', 'code_sums', 'lfq_entropy',
             'lfq_entropy_backward', 'residual_fsq_eval'}
    for name in names:
        op = getattr(torch.ops.vqtpu, name).default
        for key in ('CPU', 'CUDA', 'Meta'):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)


# -- the entry forward ---------------------------------------------------------------


def test_entry_forward_compiles_whole_and_matches_eager_and_jax():
    jfn, (jstate, jx) = __graft_entry__.entry()
    jrecon, jidx, jloss = jax.jit(jfn)(jstate, jx)

    fn, (_, x) = entry(device='cpu')
    model = build_flagship(device='cpu')
    load_vqtpu_state(model, _numpy_tree(jstate))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    before = {k: v.clone() for k, v in state.items()}
    eager = fn(state, x)
    compiled = torch.compile(fn, backend=BACKEND, fullgraph=True)
    got = compiled(state, x)
    again = compiled(state, x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(before[k], v) for k, v in state.items())

    recon, idx, loss = got
    assert torch.equal(idx, eager[1])
    _assert_close_to_largest(recon, eager[0], what='recon')
    _assert_close_to_largest(loss, eager[2], what='commit loss')
    with torch.no_grad():
        z = model.encoder(x)
    assert_indices_tie_equal(z.reshape(1, -1, 32), model.quantizer._codebook.embed, 'euclidean', idx,
                             np.asarray(jidx))
    _close_to_largest(recon.detach().numpy(), jrecon, 1e-4)
    _close_to_largest(loss.detach().numpy(), jloss, 1e-4)


def test_entry_forward_leaves_the_generators_alone():
    """The traced body reads and writes no random state: the model's
    generators are where they were after an eager and a compiled call."""
    fn, (state, x) = entry(device='cpu')
    gens = [g for cell in fn.__closure__ for g in module_generators(cell.cell_contents)
            if isinstance(cell.cell_contents, torch.nn.Module)]
    assert gens
    before = [g.get_state() for g in gens]
    fn(state, x + 0.25)
    torch.compile(fn, backend=BACKEND, fullgraph=True)(state, x + 0.25)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, before))


# -- the VQ example's training step ------------------------------------------------------


def _example_model(train_fused):
    return vq_example.main(train_iter=0, batch_size=8, device='cpu', train_fused=train_fused)


def _example_batches(steps, batch=8):
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.uniform(-1, 1, (batch, 28, 28, 1)).astype(np.float32)) for _ in range(steps)]


@pytest.mark.parametrize('train_fused', ['auto', 'on'])
def test_vq_example_steps_compiled_match_eager(train_fused):
    eager_model, compiled_model = _example_model(train_fused), _example_model(train_fused)
    compiled_model.load_state_dict(eager_model.state_dict())
    eager_opt, compiled_opt = adamw(eager_model.parameters(), 3e-4), adamw(compiled_model.parameters(), 3e-4)
    eager_step = train_step(eager_model, eager_opt, vq_example.loss_from_outputs, 10.0)
    compiled_step = train_step(compiled_model, compiled_opt, vq_example.loss_from_outputs, 10.0, compiled=True,
                               backend=BACKEND)
    for s, x in enumerate(_example_batches(3)):
        with torch.no_grad():
            z = eager_model.encoder(x).reshape(1, -1, 32)
        embed = eager_model.quantizer._codebook.embed.clone()
        want = eager_step(x)
        got = compiled_step(x)
        assert_indices_tie_equal(z, embed, 'euclidean', got[2].reshape(1, -1), want[2].reshape(1, -1).numpy())
        for a, b, what in zip(got[:2], want[:2], ('rec', 'aux')):
            _assert_close_to_largest(a, b, what=f'step {s} {what}')
    want_state, got_state = eager_model.state_dict(), compiled_model.state_dict()
    assert sorted(want_state) == sorted(got_state)
    for key, w in want_state.items():
        _assert_close_to_largest(got_state[key], w, what=key)
    for pw, pg in zip(eager_model.parameters(), compiled_model.parameters()):
        sw, sg = eager_opt.state[pw], compiled_opt.state[pg]
        assert float(sg['step']) == float(sw['step']) == 3.0
        for key in ('exp_avg', 'exp_avg_sq'):
            _assert_close_to_largest(sg[key], sw[key], what=key)


# -- the in-place optimizers' functional updates ----------------------------------------

OPTIMIZERS = {
    'sgd': lambda ps: torch.optim.SGD(ps, lr=1e-2),
    'sgd_momentum': lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9, dampening=0.1, weight_decay=1e-3),
    'sgd_nesterov': lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9, nesterov=True),
    'adam': lambda ps: torch.optim.Adam(ps, lr=1e-3, weight_decay=1e-2),
    'adamw': lambda ps: torch.optim.AdamW(ps, lr=1e-3),
    'adam_amsgrad': lambda ps: torch.optim.Adam(ps, lr=1e-3, amsgrad=True),
    'rmsprop': lambda ps: torch.optim.RMSprop(ps, lr=1e-3),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_update_equals_step(name):
    """`core.optim.optimizer_update(opt, grads)` (the in-place codebook
    optimizer's step inside a compiled step) against `opt.step()` on the
    same gradients, 3 steps: the parameters and the optimizer's state bit
    for bit, and the parameters' `.grad` left as they were."""
    from vqtpu_torch.core.optim import optimizer_update

    rng = np.random.default_rng(11)
    p0 = [_randn(rng, 4, 5), _randn(rng, 7)]
    ref = [torch.nn.Parameter(t.clone()) for t in p0]
    got = [torch.nn.Parameter(t.clone()) for t in p0]
    ref_opt, opt = OPTIMIZERS[name](ref), OPTIMIZERS[name](got)
    outer = [_randn(rng, 4, 5), None]
    for p, g in zip(got, outer):
        p.grad = g
    for _ in range(3):
        grads = [_randn(rng, 4, 5), _randn(rng, 7)]
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        ref_opt.step()
        optimizer_update(opt, grads)
        for a, b in zip(got, ref):
            assert torch.equal(a.detach(), b.detach()), name
        for a, b in zip(got, ref):
            for key, t in ref_opt.state[b].items():
                assert torch.equal(opt.state[a][key], t), (name, key)
    assert got[0].grad is outer[0] and got[1].grad is None


# -- the examples that draw: the RQ-VAE, HQ, FVQ and FSP steps --------------------------

DRAWING_EXAMPLES = ('autoencoder_rvq', 'autoencoder_hq', 'autoencoder_fvq', 'autoencoder_fsp')


@pytest.mark.parametrize('name', DRAWING_EXAMPLES)
def test_drawing_example_steps_compiled_match_eager(name):
    """Three compiled steps against three eager steps of a twin from the same
    state, the random streams' included: the same draws (stochastic codes,
    kmeans init inside the compiled step at step 0 for the RQ-VAE and HQ, FSP's
    perturbation), so the same indices, losses within 1e-5 of their
    largest, every buffer within 1e-5 of its largest entry, the parameters
    within 1e-5 of the model's largest (an entry whose gradient is 0 but
    for rounding, such as MiniEncoder's attention key bias, moves by Adam's
    step either way), Adam's moments within 1e-4 of their largest (they
    hold the gradients, which AOT's decomposed backward rounds otherwise:
    1.3e-5 in FVQ's nested backward through its bridge) and the streams'
    states equal."""
    mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
    eager_model = mod.main(train_iter=0, batch_size=8, device='cpu')
    compiled_model = mod.main(train_iter=0, batch_size=8, device='cpu')
    compiled_model.load_state_dict(eager_model.state_dict())
    eager_opt, compiled_opt = adamw(eager_model.parameters(), 3e-4), adamw(compiled_model.parameters(), 3e-4)
    eager_step = train_step(eager_model, eager_opt, mod.loss_from_outputs, 10.0)
    compiled_step = train_step(compiled_model, compiled_opt, mod.loss_from_outputs, 10.0, compiled=True,
                               backend=BACKEND)
    initted = [b for k, b in compiled_model.named_buffers() if k.endswith('initted')]
    # kmeans init is still to run in the RQ-VAE and HQ
    assert any(not bool(b) for b in initted) == (name in ('autoencoder_rvq', 'autoencoder_hq'))
    for s, x in enumerate(_example_batches(3)):
        want = eager_step(x)
        got = compiled_step(x)
        assert torch.equal(got[2], want[2]), f'step {s} indices'
        for a, b, what in zip(got[:2], want[:2], ('rec', 'aux')):
            _assert_close_to_largest(a, b, what=f'step {s} {what}')
    assert all(bool(b) for b in initted)
    want_state, got_state = eager_model.state_dict(), compiled_model.state_dict()
    assert sorted(want_state) == sorted(got_state) and any(k.endswith('rng_state') for k in want_state)
    params = dict(eager_model.named_parameters())
    scale = max(float(p.abs().max()) for p in params.values())
    for key, w in want_state.items():
        if key in params:
            assert float((got_state[key] - w).abs().max()) <= REL * scale, key
        elif w.is_floating_point():
            _assert_close_to_largest(got_state[key], w, what=key)
        else:
            assert torch.equal(got_state[key], w), key
    for key in ('exp_avg', 'exp_avg_sq'):
        moments = [(compiled_opt.state[pg][key], eager_opt.state[pw][key])
                   for pw, pg in zip(eager_model.parameters(), compiled_model.parameters())]
        largest = max(float(w.abs().max()) for _, w in moments)
        assert max(float((g - w).abs().max()) for g, w in moments) <= 10 * REL * largest, key


def _put_back(model, opt, saved):
    """`model` and `opt` in place as chip_smoke.twin_state saw them (the
    compiled step's tensors and the host mirrors stay)."""
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(saved[0][k])
    for p, state in zip(model.parameters(), saved[1]):
        for k, v in state.items():
            opt.state[p][k].copy_(v)


def _moments_rel(opt_a, model_a, opt_b, model_b) -> float:
    """Adam's moments of a against b's, each kind against b's largest entry
    of that kind (chip_smoke.py's measure)."""
    return max(
        max(float((opt_a.state[p][k] - opt_b.state[q][k]).abs().max())
            for p, q in zip(model_a.parameters(), model_b.parameters()))
        / max(float(opt_b.state[q][k].abs().max()) for q in model_b.parameters())
        for k in ('exp_avg', 'exp_avg_sq'))


@pytest.mark.parametrize('name', DRAWING_EXAMPLES)
def test_replay_with_the_compiled_picks(name):
    """chip_smoke.py's check of the compiled drawing examples replays the
    eager step from the same state with the compiled step's picks where the
    two picked differently (a near-tie flip moves its token's whole share
    of every gradient). HQ and FVQ: a compiled step made to pick another
    code for one token (chip_smoke.selection_tape, forcing K4's or K1's
    picks) moves Adam's moments or the codebook beyond the check's limits
    from the eager step; the eager step replayed with the compiled picks
    (chip_smoke.compiled_picks, FVQ's three launches from the compiled
    step's two) is within them, COMPILED_MOMENTS_REL (1e-4) and
    COMPILED_REL (1e-5), with the same indices. The RQ-VAE and FSP (their
    picks inside the graph): the replay returns the picks it is given, one
    flipped, and with the eager step's own picks it is the eager step."""
    import chip_smoke as cs

    mod = importlib.import_module(f'vqtpu_torch.examples.{name}')
    eager_model = mod.main(train_iter=0, batch_size=8, device='cpu')
    compiled_model = mod.main(train_iter=0, batch_size=8, device='cpu')
    compiled_model.load_state_dict(eager_model.state_dict())
    eager_opt, compiled_opt = adamw(eager_model.parameters(), 3e-4), adamw(compiled_model.parameters(), 3e-4)
    eager_step = train_step(eager_model, eager_opt, mod.loss_from_outputs, 10.0)
    compiled_step = train_step(compiled_model, compiled_opt, mod.loss_from_outputs, 10.0, compiled=True,
                               backend=BACKEND)
    x0, x = _example_batches(2)
    # a first step (kmeans init in HQ and the RQ-VAE), then both from one state
    eager_step(x0)
    compiled_step(x0)
    _put_back(compiled_model, compiled_opt, cs.twin_state(eager_model, eager_opt))
    before = cs.twin_state(eager_model, eager_opt)
    cpu = torch.device('cpu')
    codebooks = lambda m: {k: v.detach().clone() for k, v in m.state_dict().items()    # noqa: E731
                           if '_codebook.' in k and v.is_floating_point()}
    if name in ('autoencoder_rvq', 'autoencoder_fsp'):
        want = eager_step(x)
        for flip in (False, True):
            picks = want[2].clone()
            if flip:
                picks.view(-1)[0] = (picks.view(-1)[0] + 1) % 2
            cs.restore_twin(eager_model, eager_opt, before)
            with cs.compiled_picks(name, eager_model, picks, [], cpu):
                got = eager_step(x)
            assert torch.equal(got[2], picks), flip
            if not flip:
                for a, b, what in zip(got[:2], want[:2], ('rec', 'aux')):
                    _assert_close_to_largest(a, b, what=what)
        return

    launched = []
    with cs.selection_tape('cpu', record=launched):
        compiled_step(x)
    assert len(launched) == (2 if name == 'autoencoder_fvq' else 4)
    _put_back(compiled_model, compiled_opt, before)
    # one token of the selection of FVQ's outer forward, of HQ's last scale,
    # takes the next code
    flipped = [t.clone() for t in launched]
    k = 0 if name == 'autoencoder_fvq' else len(flipped) - 1
    flipped[k].view(-1)[0] = (flipped[k].view(-1)[0] + 1) % 8
    with cs.selection_tape('cpu', force=flipped):
        got = compiled_step(x)

    def gaps(want):
        cb_want, cb_got = codebooks(eager_model), codebooks(compiled_model)
        codebook = max((cs.rel_err(cb_got[k], w) for k, w in cb_want.items()), default=0.0)
        return dict(moments=_moments_rel(compiled_opt, compiled_model, eager_opt, eager_model), codebook=codebook,
                    rec=cs.rel_err(got[0], want[0]), aux=cs.rel_err(got[1], want[1]))

    plain = gaps(eager_step(x))
    assert plain['moments'] > cs.COMPILED_MOMENTS_REL or plain['codebook'] > cs.COMPILED_REL, plain
    cs.restore_twin(eager_model, eager_opt, before)
    with cs.compiled_picks(name, eager_model, got[2], flipped, cpu) as verdicts:
        want = eager_step(x)
    assert torch.equal(want[2], got[2])
    replayed = gaps(want)
    assert replayed['moments'] <= cs.COMPILED_MOMENTS_REL and replayed['codebook'] <= cs.COMPILED_REL, replayed
    assert replayed['rec'] <= cs.COMPILED_REL and replayed['aux'] <= cs.COMPILED_REL, replayed
    # the replay changed the flipped token's pick (in FVQ in its outer and
    # inner forward), and the float64 verdict counts it: not a near-tie here
    assert sum(v['disagree'] for v in verdicts) == (2 if name == 'autoencoder_fvq' else 1), verdicts
    assert sum(v['non_tie'] for v in verdicts) >= 1, verdicts


def test_kmeans_init_runs_once_inside_the_compiled_forward(monkeypatch):
    """kmeans init inside a compiled training forward: the first call's
    graph calls the op `vqtpu::kmeans` once, with the `initted` flag, and
    no `torch.cond`; kmeans runs at the first call and not after, as the
    eager twin's does (the codebooks equal at every step); `initted` set,
    and its host mirror with it, on which the forward compiles once more,
    into a graph with no kmeans and no host read of the flag."""
    calls = []
    kmeans = tkmeans.kmeans

    def counted(*a, **k):
        calls.append(1)
        return kmeans(*a, **k)
    monkeypatch.setattr(tkmeans, 'kmeans', counted)
    torch.manual_seed(0)
    kw = dict(dim=8, codebook_size=16, kmeans_init=True, kmeans_iters=3, device='cpu')
    eager, compiled = vqtpu_torch.VectorQuantize(**kw).train(), vqtpu_torch.VectorQuantize(**kw).train()
    compiled.load_state_dict(eager.state_dict())
    graphs = []
    fn = torch.compile(compiled, backend=_recording_backend(graphs), fullgraph=True)
    rng = np.random.default_rng(8)
    for s in range(3):
        x = _randn(rng, 2, 24, 8)
        with torch.no_grad():
            want, got = eager(x), fn(x)
        assert bool(compiled._codebook.initted) and compiled._codebook.initted_on_host
        assert len(calls) == 2, (s, len(calls))         # once in each model, at the first call
        assert len(graphs) == (1 if s == 0 else 2), (s, len(graphs))
        assert torch.equal(got[1], want[1]), s
        for key, w in eager.state_dict().items():
            assert torch.equal(compiled.state_dict()[key], w), (s, key)
        if s == 0:
            # kmeans' means, not the zeros a kmeans_init codebook starts from
            assert int(compiled._codebook.embed.abs().sum(-1).gt(0).sum()) > kw['codebook_size'] // 2
    counts = _op_counts(graphs)
    assert counts['vqtpu::kmeans'] == 1 and _op_counts(graphs[1:])['vqtpu::kmeans'] == 0, counts
    assert not any(n.target is torch.ops.higher_order.cond for gm in graphs for n in gm.graph.nodes)


# -- VectorQuantize: eval and the 'on' training step ------------------------------------


def test_vq_eval_compiled_matches_eager_and_jax():
    kw = dict(dim=32, codebook_size=64)
    jvq, tvq = vq_eval_pair(kw)
    x = np.random.default_rng(5).standard_normal((2, 64, 32), dtype=np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        want = tvq(tx)
        got = torch.compile(tvq, backend=BACKEND, fullgraph=True)(tx)
    assert torch.equal(got[1], want[1])
    _assert_close_to_largest(got[0], want[0], what='quantize')
    jq, jidx, _ = jvq(jnp.asarray(x))
    xc = tvq.codebook_input(tx).reshape(1, -1, 32)
    assert_indices_tie_equal(xc, tvq._codebook.embed, 'euclidean', got[1].reshape(1, -1),
                             np.asarray(jidx).reshape(1, -1))
    same = got[1].numpy() == np.asarray(jidx)
    np.testing.assert_allclose(got[0].numpy()[same], np.asarray(jq)[same], atol=1e-5)


def _vq_train_step(tvq):
    def step(x, g):
        q, idx, loss = tvq(x)
        total = (q * g).sum() + loss
        gx, = torch.autograd.grad(total, [x])
        return q.detach(), idx, loss.detach(), gx
    return step


def test_vq_on_training_steps_compiled_match_eager_and_jax():
    jvq, tvq = vq_train_pair(dict(dim=32, codebook_size=64), 'on')
    twin = vqtpu_torch.VectorQuantize(dim=32, codebook_size=64, train_fused='on', device='cpu').train()
    twin.load_state_dict(tvq.state_dict())
    compiled = compile_step(_vq_train_step(tvq), backend=BACKEND)
    eager = _vq_train_step(twin)
    for s in range(3):
        rng = np.random.default_rng(s)
        x = rng.standard_normal(VQ_TRAIN_SHAPE, dtype=np.float32)
        g = rng.standard_normal(VQ_TRAIN_SHAPE, dtype=np.float32)
        xc, embed = _codebook_space(tvq, x)
        jq, jidx, jloss, jgx = _jax_step(jvq, jnp.asarray(x), jnp.asarray(g), {})
        got = compiled(torch.from_numpy(x).requires_grad_(), torch.from_numpy(g))
        want = eager(torch.from_numpy(x).requires_grad_(), torch.from_numpy(g))
        assert torch.equal(got[1], want[1])
        for a, b, what in zip(got[::2] + got[3:], want[::2] + want[3:], ('quantize', 'loss', 'x.grad')):
            _assert_close_to_largest(a, b, what=f'step {s} {what} against eager')
        tq, tidx, tloss, tgx = (t.numpy() for t in got)
        assert_indices_tie_equal(xc, embed, 'euclidean', _flat_indices(tvq, tidx), _flat_indices(tvq, jidx))
        np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-6, err_msg=f'step {s} quantize')
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-6, err_msg=f'step {s} loss')
        np.testing.assert_allclose(tgx, jgx, rtol=1e-5, atol=1e-6, err_msg=f'step {s} x.grad')
    _assert_states_close(jvq, tvq)
    for key, w in twin.state_dict().items():
        _assert_close_to_largest(tvq.state_dict()[key], w, what=key)


# -- LFQ: the 'on' training step ------------------------------------------------------------


LFQ_KW = dict(dim=10, codebook_size=2 ** 10, entropy_loss_weight=0.1, spherical=True)


def _lfq_step(tm, inv_temp):
    def step(x):
        (q, idx, aux), bd = tm(x, inv_temperature=inv_temp, return_loss_breakdown=True)
        loss = aux + q.square().mean()
        gx, = torch.autograd.grad(loss, [x])
        return q.detach(), idx, aux.detach(), loss.detach(), gx
    return step


def test_lfq_on_step_compiled_matches_eager_and_jax():
    x = np.random.default_rng(7).standard_normal((2, 33, 10), dtype=np.float32)
    jm, tm = lfq_pair('fused', LFQ_KW)
    assert tm.entropy_fused == 'on'
    j, t = lfq_train_both(jm, tm, x, None, 100.0)
    got = compile_step(_lfq_step(tm, 100.0), backend=BACKEND)(torch.from_numpy(x).requires_grad_())
    q, idx, aux, loss, gx = (v.numpy() for v in got)
    np.testing.assert_array_equal(idx, t['idx'])
    _assert_close_to_largest(q, t['q'], what='quantize against eager')
    _assert_close_to_largest(aux, t['aux'], what='aux against eager')
    _assert_close_to_largest(gx, t['gx'], what='x.grad against eager')
    np.testing.assert_array_equal(idx, j['idx'])
    np.testing.assert_allclose(q, j['q'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux, j['aux'], rtol=1e-4)
    assert float(np.abs(gx - j['gx']).max()) < 5e-4


# -- ResidualFSQ: the fused eval ---------------------------------------------------------------


def test_residual_fsq_eval_on_compiled_matches_eager_and_jax():
    kw = dict(dim=4, levels=[8, 5, 5, 5], num_quantizers=4)
    jm = vqtpu.ResidualFSQ(**kw, rngs=nnx.Rngs(0)).eval()
    tm = vqtpu_torch.ResidualFSQ(**kw, eval_fused='on', device='cpu').eval()
    load_vqtpu_state(tm, jax_state(jm))
    x = np.random.default_rng(9).standard_normal((2, 64, 4), dtype=np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        assert tm._fused_eval_ok(tx)
        want = tm(tx)
        got = torch.compile(tm, backend=BACKEND, fullgraph=True)(tx)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jq, jidx = jm(jnp.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    assert float((got[1].numpy() != np.asarray(jidx)).mean()) <= 0.02


# -- the captured graphs hold the kernel ops ------------------------------------------------------


def _recording_backend(graphs):
    def record(gm, example_inputs):
        graphs.append(gm)
        return gm.forward
    return aot_autograd(fw_compiler=record, bw_compiler=record)


def _op_counts(graphs) -> Counter:
    out = Counter()
    for gm in graphs:
        for node in gm.graph.nodes:
            if node.op == 'call_function' and isinstance(node.target, torch._ops.OpOverload):
                out[f'{node.target.namespace}::{node.target._opname}'] += 1
    return out


def _path_entry(backend):
    fn, (state, x) = entry(device='cpu')
    return torch.compile(fn, backend=backend, fullgraph=True)(state, x + 0.5)


def _path_vq_example_on(backend):
    model = _example_model('on')
    step = train_step(model, adamw(model.parameters(), 3e-4), vq_example.loss_from_outputs, 10.0, compiled=True,
                      backend=backend)
    return step(_example_batches(1)[0])


def _path_vq_eval(backend):
    tvq = vqtpu_torch.VectorQuantize(dim=32, codebook_size=64, device='cpu').eval()
    with torch.no_grad():
        return torch.compile(tvq, backend=backend, fullgraph=True)(torch.randn(2, 16, 32))


def _path_vq_on(backend):
    tvq = vqtpu_torch.VectorQuantize(dim=32, codebook_size=64, train_fused='on', device='cpu').train()
    return compile_step(_vq_train_step(tvq), backend=backend)(torch.randn(2, 16, 32, requires_grad=True),
                                                              torch.randn(2, 16, 32))


def _path_simvq_step(backend):
    tm = vqtpu_torch.SimVQ(dim=16, codebook_size=32, device='cpu').train()

    def step(x):
        q, idx, loss = tm(x)
        return torch.autograd.grad(q.square().sum() + loss, [tm.code_transform.weight])[0]
    return compile_step(step, backend=backend)(torch.randn(2, 8, 16))


def _path_lfq_on(backend):
    tm = vqtpu_torch.LFQ(**LFQ_KW, entropy_fused='on', device='cpu').train()
    return compile_step(_lfq_step(tm, 100.0), backend=backend)(torch.randn(2, 9, 10, requires_grad=True))


def _path_rfsq_on(backend):
    tm = vqtpu_torch.ResidualFSQ(dim=4, levels=[8, 5, 5, 5], num_quantizers=4, eval_fused='on', device='cpu').eval()
    with torch.no_grad():
        return torch.compile(tm, backend=backend, fullgraph=True)(torch.randn(2, 16, 4))


# path -> (run, the vqtpu ops its graphs hold); on the CPU the 'auto' VQ
# training forward takes the selection op and plain statistics (the card's
# takes fused_train)
RECORDED_PATHS = {
    'entry': (_path_entry, {'vqtpu::quantize_lookup': 1}),
    'vq_example_on': (_path_vq_example_on, {'vqtpu::fused_train': 1}),
    'vq_eval': (_path_vq_eval, {'vqtpu::quantize_lookup': 1}),
    'vq_on_step': (_path_vq_on, {'vqtpu::fused_train': 1}),
    'simvq_step': (_path_simvq_step, {'vqtpu::quantize_lookup': 1, 'vqtpu::code_sums': 1}),
    'lfq_on_step': (_path_lfq_on, {'vqtpu::lfq_entropy': 1, 'vqtpu::lfq_entropy_backward': 1}),
    'rfsq_eval_on': (_path_rfsq_on, {'vqtpu::residual_fsq_eval': 1}),
}


@pytest.mark.parametrize('path', list(RECORDED_PATHS))
def test_captured_graphs_hold_the_kernel_ops(path):
    run, want = RECORDED_PATHS[path]
    graphs = []
    run(_recording_backend(graphs))
    assert graphs, 'nothing was captured'
    counts = _op_counts(graphs)
    assert {k: v for k, v in counts.items() if k.startswith('vqtpu::')} == want, counts
    # the selection is the op, not a product and an argmax standing in for it
    assert counts['aten::argmax'] == 0, counts
