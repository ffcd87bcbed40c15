"""The softmax, triplet and video engines of bpbreid_tpu_torch under
``parallel.distribute_engine`` on 2 gloo ranks on the CPU, against JAX's
sharded step on the 8-device CPU mesh and against the same engine's
one-process step on the global batch.

A reduced OSNet (one block a stage, channels 16-64, as
tests/test_torch_softmax_engine.py) at 64x32 in f32, JAX's seeded weights
(``seeded_variables``, loaded into the port's model) and JAX's
augmentation draws (``jax_draws`` of the step's key): 8 images (4 ids x 2)
a step, or 4 tracklets of 2 frames (2 ids) for the video engines, whose
ranks take whole tracklets. Each rank runs the model on its half and the
loss (cross entropy, batch-hard triplets) on the gathered outputs; the
gradients are summed over the ranks. Batch norm takes the global
statistics.

The JAX step follows its image engines' ``_train_step_impl``
(``train_augment`` on the step's key, ``model.apply``, the engines'
criteria, the optax update) with the batch sharded over the mesh (the recipe of
tests/test_parallel.py); the augmentation is jitted on its own (it
changes no value and partitioning it too doubles the compile time). One
program serves both engines: the triplet-mode model, whose logits are the
softmax-mode model's, and the loss ``CE + w * triplet`` with ``w`` 0 (the
softmax engine's loss, bit for bit, and its gradient) or 1 (the triplet
engine's ``weight_t = weight_x = 1``). The video engines' JAX step is the
same on JAX's flattened ``[B*S]`` batch (its
``VideoSoftmaxEngine.forward_backward``; its video triplet engine cannot
step, a fault pinned in tests/test_torch_video.py, so its image triplet
step on the same flattened batch stands in).

Tolerances: the loss of step 1 to 1e-5 relative of JAX's and of the
one-process step's; step 1's gradients against JAX's at the noise floor
of tests/test_torch_train_step.py (relative L2 over all parameters 4e-2,
per tensor 0.3 of its largest entry, median 2e-2; the bias of OSNet's
``fc`` ahead of its BN, zero in exact arithmetic, below 1e-6 on both
sides; measured up to 7.6e-3 and 5.0e-2, the triplet engine), against
the one-process step's, whose only difference is the order of the sums,
as tests/test_torch_parallel_train.py: relative L2 1e-4 and per tensor
1e-2 of its largest entry (measured up to 1.1e-5 and 2.0e-4); the BN
running statistics after step 1 to 1e-6 of their scale and the
parameters to Adam's first update from each side's gradient, to 1e-6;
step 2's loss to 1e-3 of the one-process step's (measured up to 6.1e-5:
Adam's first update moves every entry by about lr whatever its
gradient's size, so entries whose gradient is float noise move apart by
2 lr); after every step the two ranks' parameters, buffers and gradients
are bit-equal.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from bpbreid_tpu.data.augment import train_augment as j_train_augment
from bpbreid_tpu.losses.cross_entropy import CrossEntropyLoss
from bpbreid_tpu.losses.triplet import TripletLoss
from bpbreid_tpu.models import osnet as josnet
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu.parallel import DATA_AXIS, make_mesh
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.models import osnet as tosnet
from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
from tests import torch_parallel_ranks as ranks
from tests.test_torch_train_augment import jax_draws
from tests.torch_port_helpers import limit_torch_threads, seeded_variables

limit_torch_threads()

H, W = 64, 32
# OSNet (batch norms, no dropout), one block a stage: quick to build in
# every rank and to compile on the mesh
SMALL = dict(blocks=(('os',),) * 3, channels=(16, 32, 48, 64),
             num_classes=4)
TRANSFORMS = ('rf', 'rc', 're')
LR, WD = ranks.LR, ranks.WD
STEPS = 2


def _is_triplet(kind):
    return kind.endswith('triplet')


def _rngs(seed):
    """Each step's augmentation key (the engines' key chain)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(STEPS):
        rng, aug_rng, _model_rng = jax.random.split(rng, 3)
        out.append(aug_rng)
    return out


def _models(seed=3):
    """The port's softmax- and triplet-mode models and JAX's triplet-mode
    model's variables, all with the same seeded weights."""
    tmodels = {loss: tosnet._osnet(loss=loss, **SMALL)
               for loss in ('softmax', 'triplet')}
    variables = seeded_variables(
        josnet._osnet(loss='triplet', **SMALL), tmodels['triplet'],
        np.zeros((2, H, W, 3), np.float32), train=True, seed=seed)
    tmodels['softmax'].load_state_dict(tmodels['triplet'].state_dict())
    return tmodels, variables


def _payload(kind, seed, tmodels):
    """The engine's input: its model, batches and draws."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(4, H, W, 3))
    pids = np.repeat(np.arange(4), 2)
    batches = []
    for _ in range(STEPS):
        imgs = np.clip(base[pids] + rng.integers(-30, 31, (8, H, W, 3)), 0,
                       255).astype(np.uint8)
        batch = {'image': torch.as_tensor(imgs), 'pid': torch.as_tensor(pids)}
        if kind.startswith('video'):
            batch = {'image': batch['image'].reshape(4, 2, H, W, 3),
                     'pid': torch.as_tensor([0, 0, 1, 1])}
        batches.append(batch)
    return {'kind': kind, 'transforms': TRANSFORMS,
            'model': tmodels['triplet' if _is_triplet(kind) else 'softmax'],
            'batches': batches,
            'draws': [jax_draws(key, 8, H, W, TRANSFORMS)
                      for key in _rngs(seed)]}


def _jax_flat(batch):
    """JAX's flattening of a tracklet batch
    (``VideoSoftmaxEngine.forward_backward``)."""
    imgs = np.asarray(batch['image'])
    b, s = imgs.shape[:2]
    return {'image': imgs.reshape(b * s, *imgs.shape[2:]),
            'pid': np.repeat(np.asarray(batch['pid']), s)}


def _jax_sharded_steps(payloads, seeds, variables):
    """JAX's sharded steps on each payload's batches from ``variables``:
    per step the loss, the gradients and the params + batch_stats after
    it."""
    cfg = get_default_config()
    jmodel = josnet._osnet(loss='triplet', **SMALL)
    jopt = j_build_optimizer(optim='adam', lr=LR, weight_decay=WD)
    criterion_x = CrossEntropyLoss(label_smooth=True)
    criterion_t = TripletLoss(margin=0.3)

    def step(params, batch_stats, opt_state, imgs, pids, weight_t):
        def loss_fn(p):
            (logits, feats), new_state = jmodel.apply(
                {'params': p, 'batch_stats': batch_stats}, imgs, train=True,
                mutable=['batch_stats'])
            return criterion_x(logits, pids) \
                + weight_t * criterion_t(feats, pids), \
                new_state['batch_stats']

        (value, new_bs), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return value, grads, params, new_bs, opt_state

    augment = jax.jit(lambda imgs_u8, key: j_train_augment(
        imgs_u8, None, key, transforms=TRANSFORMS,
        norm_mean=tuple(cfg.data.norm_mean),
        norm_std=tuple(cfg.data.norm_std))[0])
    mesh = make_mesh()
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P(DATA_AXIS))
    j_step = jax.jit(step, in_shardings=(repl, repl, repl, data, data, repl))
    out = []
    for payload, seed in zip(payloads, seeds):
        # committed to the mesh as the step returns them: one compile
        params, bs, opt_state = jax.device_put(
            (variables['params'], variables['batch_stats'],
             jopt.init(variables['params'])), repl)
        steps = []
        weight_t = jnp.float32(_is_triplet(payload['kind']))
        for batch, key in zip(payload['batches'], _rngs(seed)):
            if payload['kind'].startswith('video'):
                batch = _jax_flat(batch)
            imgs = augment(jnp.asarray(np.asarray(batch['image'])), key)
            loss, grads, params, bs, opt_state = j_step(
                params, bs, opt_state, imgs,
                jnp.asarray(np.asarray(batch['pid'])), weight_t)
            steps.append({'loss': float(loss),
                          'grads': jax_variables_to_state_dict(
                              {'params': jax.device_get(grads)}),
                          'state': jax_variables_to_state_dict(
                              jax.device_get({'params': params,
                                              'batch_stats': bs}))})
        out.append(steps)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    # the ranks start up while this process makes their input
    started = ranks.start(ranks.distributed_steps, 2,
                          tmp_path_factory.mktemp('parallel_engines'))
    tmodels, variables = _models()
    seeds = [10 + i for i in range(len(ranks.GLOBAL_ENGINES))]
    payloads = [_payload(kind, seed, tmodels)
                for kind, seed in zip(ranks.GLOBAL_ENGINES, seeds)]
    started.send(payloads)
    before = {k: v.clone() for k, v in tmodels['triplet'].state_dict().items()}
    # the one-process steps in a thread while JAX compiles
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        one = pool.map(ranks.one_process_steps, payloads)
        out = {'jax': _jax_sharded_steps(payloads, seeds, variables)}
        out['one'] = list(one)
    out.update(before=before, ranked=started.results())
    return out


CASES = pytest.mark.parametrize('case', range(len(ranks.GLOBAL_ENGINES)),
                                ids=list(ranks.GLOBAL_ENGINES))


@CASES
def test_engine_at_2_ranks_matches_jax_sharded_step(runs, case):
    want = runs['jax'][case][0]
    for res in runs['ranked']:
        assert res[case]['steps'][0]['loss'] == pytest.approx(want['loss'],
                                                              rel=1e-5)
    # held on rank 0; the other rank's are bit-equal to it (below)
    got = runs['ranked'][0][case]['steps'][0]
    rel_l2, worst, median = ranks.grad_errors(got['grads'], want['grads'])
    assert rel_l2 <= 4e-2 and worst <= 0.3 and median <= 2e-2, \
        (rel_l2, worst, median)
    ranks.check_state(got['state'], want['state'], runs['before'],
                      got['grads'], want['grads'])


@CASES
def test_engine_at_2_ranks_matches_one_process(runs, case):
    one = runs['one'][case]
    for res in runs['ranked']:
        got = res[case]['steps']
        assert got[0]['loss'] == pytest.approx(one[0]['loss'], rel=1e-5)
        assert got[1]['loss'] == pytest.approx(one[1]['loss'], rel=1e-3)
    got = runs['ranked'][0][case]['steps'][0]
    rel_l2, worst, _ = ranks.grad_errors(got['grads'], one[0]['grads'])
    assert rel_l2 <= 1e-4 and worst <= 1e-2, (rel_l2, worst)
    ranks.check_state(got['state'], one[0]['state'], runs['before'],
                      got['grads'], one[0]['grads'])


@CASES
def test_engine_ranks_stay_bit_equal(runs, case):
    for step in range(STEPS):
        want, got = (r[case]['steps'][step] for r in runs['ranked'])
        for part in ('state', 'grads'):
            assert all(torch.equal(got[part][k], want[part][k])
                       for k in want[part]), (step, part)
