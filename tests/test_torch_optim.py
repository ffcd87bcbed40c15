"""amsgrad, rmsprop and radam of bpbreid_tpu_torch (``OptaxRule``) and
``metrics/accuracy.py`` against bpbreid_tpu (optax, jnp), on the CPU.

Eight steps on seeded parameters and gradients (gradients that shrink
from step to step, so amsgrad's running maximum matters), with weight
decay, without and with the staged learning rate: the parameters after
every step within 1e-6 of optax's (an update is about lr = 1e-3 a step).
radam's rho crosses its threshold of 5 inside the eight steps, so both
of its branches run. ``accuracy`` with tied scores equals JAX's (ties
ordered as a stable ``argsort(-output)``).

Each group's step count is a float32 tensor on the parameters' device,
advanced in place, and the step's scalars are computed from it there:
equal, bit for bit, to optax's float32 formulas computed in numpy on the
host, and over 24 steps with weight decay and two staged groups the
parameters stay within 1e-6 of optax's. The count round-trips through a
checkpoint, an int as older checkpoints hold it included."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.metrics.accuracy import accuracy as j_accuracy
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu_torch.metrics.accuracy import accuracy
from bpbreid_tpu_torch.optim import build_optimizer
from bpbreid_tpu_torch.optim.optimizer import RADAM_THRESHOLD, OptaxRule
from bpbreid_tpu_torch.utils.checkpoint import load_optimizer_state
from tests.test_torch_train_losses import _Two
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

STEPS = 8
LR, WD = 1e-3, 5e-4


def _params(rng):
    return {'backbone': {'w': rng.normal(size=(4, 3)).astype(np.float32),
                         'b': rng.normal(size=(3,)).astype(np.float32)},
            'classifier': {'w': rng.normal(size=(3, 2)).astype(np.float32)}}


def _grads(rng, params, step):
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) / (1 + step)).astype(np.float32),
        params)


@pytest.mark.parametrize('staged', [False, True])
@pytest.mark.parametrize('optim', ['amsgrad', 'rmsprop', 'radam'])
def test_optimizer_matches_optax(optim, staged):
    rng = np.random.default_rng(11)
    params = _params(rng)
    kw = dict(optim=optim, lr=LR, weight_decay=WD, staged_lr=staged,
              new_layers=['classifier'], base_lr_mult=0.1)
    jopt = j_build_optimizer(params if staged else None, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    model = _Two(params['backbone'], params['classifier'])
    topt = build_optimizer(model, **kw)
    assert isinstance(topt, OptaxRule)
    assert len(topt.param_groups) == (2 if staged else 1)
    for step in range(STEPS):
        grads = _grads(rng, params, step)
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        for group in ('backbone', 'classifier'):
            for name, p in getattr(model, group).items():
                p.grad = torch.from_numpy(grads[group][name])
        topt.step()
        for group in ('backbone', 'classifier'):
            for name, p in getattr(model, group).items():
                np.testing.assert_allclose(
                    p.detach().numpy(), np.asarray(jparams[group][name]),
                    atol=1e-6, rtol=0, err_msg='{}.{} step {}'.format(
                        group, name, step + 1))


def test_radam_crosses_its_threshold_within_the_steps():
    """optax's rho_t = rho_inf - 2 t b2^t / (1 - b2^t), in float32: below
    5 at step 1, at or above 5 by step 8."""
    b2 = np.float32(0.999)
    rho = [np.float32(2 / (1 - 0.999) - 1) - np.float32(2 * t) * b2 ** t
           / (np.float32(1) - b2 ** t) for t in range(1, STEPS + 1)]
    assert rho[0] < 5 <= rho[-1]


def test_optimizer_state_round_trips_through_a_checkpoint():
    """Four steps, ``state_dict`` through ``torch.save`` and a
    ``weights_only`` load into a fresh optimizer, four more steps: the
    same parameters as eight uninterrupted steps, bit for bit."""
    rng = np.random.default_rng(12)
    params = _params(rng)
    grads = [_grads(rng, params, s) for s in range(STEPS)]
    runs = []
    for resume in (False, True):
        model = _Two(params['backbone'], params['classifier'])
        opt = build_optimizer(model, optim='amsgrad', lr=LR, weight_decay=WD)
        for step in range(STEPS):
            if resume and step == STEPS // 2:
                buf = io.BytesIO()
                torch.save(opt.state_dict(), buf)
                buf.seek(0)
                opt = build_optimizer(model, optim='amsgrad', lr=LR,
                                      weight_decay=WD)
                opt.load_state_dict(torch.load(buf, weights_only=True))
            for group in ('backbone', 'classifier'):
                for name, p in getattr(model, group).items():
                    p.grad = torch.from_numpy(grads[step][group][name])
            opt.step()
        runs.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _staged(model, optim):
    return build_optimizer(model, optim=optim, lr=LR, weight_decay=WD,
                           staged_lr=True, new_layers=['classifier'],
                           base_lr_mult=0.1)


def _set_grads(model, grads):
    for group in ('backbone', 'classifier'):
        for name, p in getattr(model, group).items():
            p.grad = torch.from_numpy(grads[group][name])


def _numpy_scalars(rule, t, b1=0.9, b2=0.999):
    """optax's scalars at step ``t`` in numpy float32, in its order of
    operations: ``(1 - b1^t, 1 - b2^t)``, and for radam r and the
    switch (rho >= 5)."""
    f32 = np.float32
    b1t, b2t = f32(b1) ** f32(t), f32(b2) ** f32(t)
    out = [f32(1) - b1t, f32(1) - b2t]
    if rule == 'radam':
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
        on = ro >= RADAM_THRESHOLD
        r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                    / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)) \
            if on else f32(0)
        out += [r, f32(on)]
    return out


@pytest.mark.parametrize('rule', ['amsgrad', 'radam'])
def test_device_scalars_equal_numpy_float32(rule):
    """The scalars computed from the count on the device equal optax's
    float32 formulas on the host bit for bit, over the first 2,000 steps
    (radam's switch included)."""
    opt = OptaxRule([torch.nn.Parameter(torch.zeros(2))], rule)
    for t in range(1, 2001):
        got = opt._scalars(opt.param_groups[0],
                           torch.tensor(float(t), dtype=torch.float32))
        want = _numpy_scalars(rule, t)
        assert [g.dtype for g in got] == [torch.float32] * len(want)
        assert [float(g) for g in got] == [float(w) for w in want], t


@pytest.mark.parametrize('optim', ['amsgrad', 'rmsprop', 'radam'])
def test_device_count_matches_optax_over_24_steps(optim):
    rng = np.random.default_rng(14)
    params = _params(rng)
    kw = dict(optim=optim, lr=LR, weight_decay=WD, staged_lr=True,
              new_layers=['classifier'], base_lr_mult=0.1)
    jopt = j_build_optimizer(params, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    model = _Two(params['backbone'], params['classifier'])
    opt = _staged(model, optim)
    counts = [g['step'] for g in opt.param_groups]
    addresses = [t.data_ptr() for t in counts]
    for step in range(3 * STEPS):
        grads = _grads(rng, params, step)
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        _set_grads(model, grads)
        opt.step()
        for group in ('backbone', 'classifier'):
            for name, p in getattr(model, group).items():
                np.testing.assert_allclose(
                    p.detach().numpy(), np.asarray(jparams[group][name]),
                    atol=1e-6, rtol=0, err_msg='{}.{} step {}'.format(
                        group, name, step + 1))
    # one count a group, advanced in place
    for g, t, address in zip(opt.param_groups, counts, addresses):
        assert g['step'] is t and t.data_ptr() == address
        assert t.dtype == torch.float32 and float(t) == 3 * STEPS


@pytest.mark.parametrize('optim', ['amsgrad', 'radam'])
def test_count_round_trips_through_load_optimizer_state(optim):
    """Twelve steps, resumed at step 4 from a checkpoint whose counts
    are ints (as older checkpoints hold them) and at step 8 from one
    whose counts are tensors: each load leaves a new float32 count on
    the parameters' device, and the parameters equal twelve
    uninterrupted steps bit for bit."""
    rng = np.random.default_rng(15)
    params = _params(rng)
    grads = [_grads(rng, params, s) for s in range(3 * 4)]
    runs = []
    for resume in (False, True):
        model = _Two(params['backbone'], params['classifier'])
        opt = _staged(model, optim)
        for step, g in enumerate(grads):
            if resume and step in (4, 8):
                buf = io.BytesIO()
                torch.save(opt.state_dict(), buf)
                buf.seek(0)
                saved = torch.load(buf, weights_only=True)
                if step == 4:
                    for group in saved['param_groups']:
                        group['step'] = int(group['step'])
                opt = _staged(model, optim)
                old = [group['step'] for group in opt.param_groups]
                load_optimizer_state(opt, saved)
                for group, was in zip(opt.param_groups, old):
                    assert isinstance(group['step'], torch.Tensor)
                    assert group['step'].dtype == torch.float32
                    assert float(group['step']) == step
                    assert group['step'] is not was
                    assert 'capturable' not in group
            _set_grads(model, g)
            opt.step()
        runs.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize('topk', [(1,), (1, 3, 5)])
def test_accuracy_matches_jax_with_ties(topk):
    rng = np.random.default_rng(13)
    # scores on a coarse grid: many ties, among them at the true class
    output = rng.integers(0, 4, size=(32, 10)).astype(np.float32)
    target = rng.integers(0, 10, size=32)
    want = j_accuracy(jnp.asarray(output), jnp.asarray(target), topk=topk)
    got = accuracy(torch.from_numpy(output), torch.from_numpy(target),
                   topk=topk)
    assert len(got) == len(topk)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a tie at the top goes to the lower class index
    tied = torch.tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0]])
    assert accuracy(tied, torch.tensor([0, 1])) == [50.0]
