"""Data parallelism of bpbreid_tpu_torch (``parallel/``,
``distribute_engine``) on 2 and 4 gloo ranks on the CPU, against JAX's
sharded train step on the 8-device CPU mesh and against the port's
one-process step on the global batch.

The part-based case: a reduced BPBReID (resnet18, five parts, 32-d
after-pooling reduction) at 64x32, a global batch of 16 (4 ids x 4), f32,
JAX's weights through ``load_jax_variables`` and JAX's augmentation
draws; the JAX step is ``engine._loss_fn`` + the optax update jitted
with the batch sharded over the mesh (the recipe of
tests/test_parallel.py), on the batch that JAX's ``train_augment``
made. Each rank takes 8 or 4 of the 16 images; batch
norm takes the global statistics (``bn_stats`` sums all-reduced, then
``bn_apply_sums``; backward, ``bn_grad_stats``'s sums written twice and
one copy all-reduced in place), GiLt + BPA run over the gathered outputs
and the gradients are summed over the ranks. One spawn of 4 ranks runs the
4-rank step, then the 2-rank step on a group of two of them and the
one-process step on a third, while this process compiles the JAX step
(once: its inputs are committed to the mesh as the step returns them).
The softmax, triplet and video engines:
tests/test_torch_parallel_engines.py.

Tolerances, step 1:
- loss: 1e-5 relative to JAX's and to the one-process step;
- gradients against JAX: the noise floor of
  tests/test_torch_train_step.py (relative L2 over all parameters 4e-2;
  per tensor 0.3 of its largest entry, median 2e-2); against the
  one-process step, whose only difference is the order of the sums:
  relative L2 1e-4 and per tensor 1e-2 of its largest entry. Biases
  ahead of a train-mode BN are zero in exact arithmetic: below 1e-6;
- BN running statistics: 1e-6 of their scale;
- parameters: Adam's first update is lr * g / (|g| + eps), so two runs
  differ by exactly lr * |u_a - u_b| with u = g / (|g| + eps) from each
  side's gradient: that to 1e-6 (a sign flip of a gradient within float
  noise of 0 moves an entry by 2 lr and is predicted so).
Step 2 (after step 1's sign flips): the loss to 1e-3 relative of the
one-process step's. After every step the ranks' parameters, buffers and
gradients are bit-equal to each other (the gradients and states are
held against JAX and the one-process step on rank 0).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.data.augment import train_augment as j_train_augment
from bpbreid_tpu.engine import ImagePartBasedEngine as JEngine
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu.parallel import DATA_AXIS, make_mesh
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
from tests import torch_parallel_ranks as ranks
from tests.test_torch_train_augment import jax_draws
from tests.torch_port_helpers import limit_torch_threads, seeded_variables

limit_torch_threads()

KW = dict(num_classes=4, parts_num=5, backbone='resnet18', last_stride=2,
          dim_reduce='after_pooling', dim_reduce_output=32)
TRANSFORMS = ('rf', 'rc', 're')
LR, WD = ranks.LR, ranks.WD
N, H, W = 16, 64, 32
STEPS = 2


def _batches(seed, n=N, ids=4):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(ids, H, W, 3))
    pids = np.repeat(np.arange(ids), n // ids)
    return [{'image': np.clip(base[pids] + rng.integers(-30, 31, (n, H, W, 3)),
                              0, 255).astype(np.uint8),
             'mask': rng.uniform(size=(n, H // 8, W // 8, 36))
                     .astype(np.float32),
             'pid': pids} for _ in range(STEPS)]


def _rngs():
    """Each step's (augmentation, model) keys."""
    rng, out = jax.random.PRNGKey(5), []
    for _ in range(STEPS):
        rng, aug_rng, model_rng = jax.random.split(rng, 3)
        out.append((aug_rng, model_rng))
    return out


def _jax_sharded_steps(variables, batches):
    """JAX's sharded steps from ``variables``: per step the loss, the
    gradients and the params + batch_stats after it."""
    jcfg = j_default_config()
    jcfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg = get_default_config()
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    kw = mask_chain_kwargs(cfg)
    dm = types.SimpleNamespace(transforms=list(TRANSFORMS),
                               norm_mean=cfg.data.norm_mean,
                               norm_std=cfg.data.norm_std,
                               mask_chain_kwargs=lambda: kw)
    jmodel = JBPBreID(**KW)
    jopt = j_build_optimizer(optim='adam', lr=LR, weight_decay=WD)
    jengine = JEngine(jcfg, dm, jmodel, jopt)
    state = jengine.load_variables(variables)

    def step(params, batch_stats, opt_state, imgs, masks, pids, model_rng):
        (loss, (new_bs, _)), grads = jax.value_and_grad(
            jengine._loss_fn, has_aux=True)(params, batch_stats, imgs, masks,
                                            pids, model_rng)
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return loss, grads, params, new_bs, opt_state

    # the augmentation, per sample, jitted on its own; the step with the
    # batch sharded over the mesh (partitioning the augmentation too
    # doubles the compile time and changes no value)
    augment = jax.jit(lambda imgs_u8, raw, key: j_train_augment(
        imgs_u8, raw, key, transforms=TRANSFORMS, mask_kwargs=kw))
    mesh = make_mesh()
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P(DATA_AXIS))
    j_step = jax.jit(step, in_shardings=(repl, repl, repl, data, data, data,
                                         repl))
    # committed to the mesh as the step returns them: one compile
    params, bs, opt_state = jax.device_put(
        (state.params, state.batch_stats, state.opt_state), repl)
    out = []
    for batch, (aug_rng, model_rng) in zip(batches, _rngs()):
        imgs, masks = augment(jnp.asarray(batch['image']),
                              jnp.asarray(batch['mask']), aug_rng)
        loss, grads, params, bs, opt_state = j_step(
            params, bs, opt_state, imgs, masks, jnp.asarray(batch['pid']),
            model_rng)
        out.append({'loss': float(loss),
                    'grads': jax_variables_to_state_dict(
                        {'params': jax.device_get(grads)}),
                    'state': jax_variables_to_state_dict(jax.device_get(
                        {'params': params, 'batch_stats': bs}))})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    # the ranks start up while this process makes their input
    started = ranks.start(ranks.steps_at_4_and_2_ranks, 4,
                          tmp_path_factory.mktemp('parallel_train'))
    batches = _batches(0)
    tmodel = TBPBreID(**KW)
    variables = seeded_variables(
        JBPBreID(**KW), tmodel, jnp.zeros((2, H, W, 3)),
        jnp.zeros((2, H // 4, W // 4, 6)), seed=2)
    part = {'kind': 'part_based', 'model_kwargs': KW,
            'state_dict': tmodel.state_dict(), 'transforms': TRANSFORMS,
            'batches': [{k: torch.as_tensor(v) for k, v in b.items()}
                        for b in batches],
            'draws': [jax_draws(aug_rng, N, H, W, TRANSFORMS)
                      for aug_rng, _ in _rngs()]}
    started.send(part)
    out = {'jax': _jax_sharded_steps(variables, batches),
           'before': {k: v.clone() for k, v in part['state_dict'].items()}}
    ranked = started.results()
    out.update({world: [r[world] for r in ranked if world in r]
                for world in (2, 4)})
    out['one'] = [ranked[2][1]]
    out['bn_entries_one'] = ranked[2]['bn_entries_one']
    return out


# the gradients and states are held on rank 0; the other ranks' are
# bit-equal to them (test_ranks_stay_bit_equal)
@pytest.mark.parametrize('world', [2, 4])
def test_part_based_step_matches_jax_sharded_step(runs, world):
    want = runs['jax'][0]
    for r, res in enumerate(runs[world]):
        assert res[0]['steps'][0]['loss'] == pytest.approx(want['loss'],
                                                           rel=1e-5), r
    got = runs[world][0][0]['steps'][0]
    rel_l2, worst, median = ranks.grad_errors(got['grads'], want['grads'])
    assert rel_l2 <= 4e-2 and worst <= 0.3 and median <= 2e-2, \
        (rel_l2, worst, median)
    ranks.check_state(got['state'], want['state'], runs['before'],
                      got['grads'], want['grads'])


@pytest.mark.parametrize('world', [2, 4])
def test_part_based_step_matches_one_process_step(runs, world):
    one = runs['one'][0]
    for res in runs[world]:
        got = res[0]['steps']
        assert got[0]['loss'] == pytest.approx(one[0]['loss'], rel=1e-5)
        assert got[1]['loss'] == pytest.approx(one[1]['loss'], rel=1e-3)
    got = runs[world][0][0]['steps']
    rel_l2, worst, _ = ranks.grad_errors(got[0]['grads'], one[0]['grads'])
    assert rel_l2 <= 1e-4 and worst <= 1e-2, (rel_l2, worst)
    ranks.check_state(got[0]['state'], one[0]['state'], runs['before'],
                      got[0]['grads'], one[0]['grads'])


@pytest.mark.parametrize('world', [2, 4])
def test_ranks_stay_bit_equal(runs, world):
    """After every step the ranks hold the same parameters, buffers and
    (summed) gradients, bit for bit."""
    for case in range(len(runs[world][0])):
        for step in range(STEPS):
            want = runs[world][0][case]['steps'][step]
            for res in runs[world][1:]:
                got = res[case]['steps'][step]
                for part in ('state', 'grads'):
                    assert all(torch.equal(got[part][k], want[part][k])
                               for k in want[part]), (case, step, part)


@pytest.mark.parametrize('world', [2, 4])
def test_collectives_per_step(runs, world):
    """One all_reduce for each train-mode BN forward and backward, the
    pixel classifier's moments (forward and backward), the gathers of the
    loss's inputs and the gradient sum; no other collective."""
    got = runs[world][0][0]['collectives']
    assert set(got) == {'all_reduce'}
    assert got['all_reduce'] == runs[2][0][0]['collectives']['all_reduce']
    assert got['all_reduce'] % STEPS == 0


@pytest.mark.parametrize('world', [2, 4])
def test_mesh_batch_norm_is_two_entries_each_way(runs, world):
    """Under the mesh a train-mode BN calls ``bn_local_sums`` and
    ``bn_apply_sums`` forward (no ``bn_stats`` and ``bn_apply`` of their
    own) and ``bn_grad_local_sums`` and ``bn_dx`` backward, as often as
    the one-process step calls ``bn_stats`` / ``bn_apply`` and
    ``bn_grad_stats`` / ``bn_dx``; every backward all-reduce is in place
    on the copy of the sums that ``bn_grad_local_sums`` wrote (no stacked
    copy)."""
    one = runs['bn_entries_one']
    assert one.get('bn_local_sums', 0) == one.get('bn_apply_sums', 0) == 0
    assert one['bn_stats'] > 0 and one['bn_grad_stats'] > 0
    for res in runs[world]:
        got = res[0]['bn_entries']
        assert got.get('bn_stats', 0) == got.get('bn_grad_stats', 0) == 0
        assert got['bn_local_sums'] == got['bn_apply_sums'] \
            == one['bn_stats']
        # eval-mode BNs (the pixel classifier's): bn_apply in both
        assert got.get('bn_apply', 0) == one['bn_apply'] - one['bn_stats']
        assert got['bn_grad_local_sums'] == one['bn_grad_stats']
        assert got['bn_dx'] == one['bn_dx'] == got['grad_sums_in_place']
