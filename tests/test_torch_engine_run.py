"""The train/test CLI of bpbreid_tpu_torch against the JAX engine, on
``configs/bpbreid/bpbreid_synthetic_smoke.yaml`` (synthetic data, 8
identities, BPBReID on resnet18 at 64x32, batch 8 = 2 ids x 4, one epoch
of 4 steps, then the final test on 48 query and 96 gallery images), in
f32 (``model.compute_dtype float32``) on the CPU, with test batches of
40 (two query and three gallery batches, the last of each padded).

The JAX side is its ``Engine.run`` over its own data manager; the port's
side is ``scripts.main.build_model_engine`` then ``Engine.run``, with
the JAX weights crossed over and the JAX engine's augmentation draws fed
in (each step's key split into next, aug and model keys, as
``_train_step_impl`` does). Both samplers draw the same batches.

Tolerances: per-batch losses 1e-4 relative (measured: 7.3e-6 at most);
the final distance matrix 1e-4 absolute (measured: 3.6e-5), mAP 1e-3,
rank-1 equal. The port-only checks of the CLI (checkpoints, resume,
preemption, ``main``) are in tests/test_torch_cli.py.
"""
import os
import types

import jax
import numpy as np
import pytest
import torch

from bpbreid_tpu import metrics as j_metrics
from bpbreid_tpu.config import engine_run_kwargs as j_engine_run_kwargs
from bpbreid_tpu.config import imagedata_kwargs as j_imagedata_kwargs
from bpbreid_tpu.config import lr_scheduler_kwargs as j_lr_scheduler_kwargs
from bpbreid_tpu.config import optimizer_kwargs as j_optimizer_kwargs
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.data.datasets import clear_dataset_cache as j_clear_cache
from bpbreid_tpu.models import build_model as j_build_model
from bpbreid_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu.scripts.main import build_config as j_build_config
from bpbreid_tpu.scripts.main import build_engine as j_build_engine
from bpbreid_tpu_torch.config import engine_run_kwargs
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_train_augment import jax_draws
from tests.torch_port_helpers import limit_torch_threads, randomize_variables

limit_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')
OPTS = ['model.compute_dtype', 'float32', 'test.batch_size', '40']


def _args(save_dir, opts=()):
    return types.SimpleNamespace(save_dir=str(save_dir), job_id=1,
                                 opts=OPTS + list(opts))


def _run_kwargs(cfg, run_kwargs):
    return dict(run_kwargs(cfg), max_epoch=cfg.train.max_epoch,
                eval_freq=cfg.train.eval_freq, start_eval=cfg.test.start_eval)


def _seeded_variables(jmodel, cfg, seed=3):
    """Variables of ``jmodel`` drawn in numpy on the shapes of
    ``jax.eval_shape`` of its init (no init program is compiled):
    lecun-normal kernels, BN statistics, scales and biases perturbed
    (``randomize_variables``)."""
    h, w = cfg.data.height, cfg.data.width
    k1 = cfg.model.bpbreid.masks.parts_num + 1
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((2, h, w, 3)),
        jax.numpy.zeros((2, h // 4, w // 4, k1)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        a = np.zeros(leaf.shape, np.float32)
        if path[-1].key == 'kernel':
            a[...] = rng.standard_normal(leaf.shape) \
                / np.sqrt(np.prod(leaf.shape[:-1]))
        return a
    return randomize_variables(
        jax.tree_util.tree_map_with_path(fill, dict(shapes)), seed)


def _jax_run(save_dir):
    """The JAX engine's run; returns its variables at init, the keys and
    batches of its steps, its losses and the final test."""
    j_clear_cache()
    jcfg = j_build_config(_args(save_dir, ['test.batches_per_dispatch', '1']),
                          SMOKE)
    dm = JImageDataManager(**j_imagedata_kwargs(jcfg))
    model = j_build_model('bpbreid', dm.num_train_pids, loss='part_based',
                          config=jcfg)
    engine = j_build_engine(
        jcfg, dm, model, j_build_optimizer(**j_optimizer_kwargs(jcfg)),
        j_build_lr_scheduler(lr=jcfg.train.lr,
                             **j_lr_scheduler_kwargs(jcfg)), None, None)
    variables = _seeded_variables(model, jcfg)
    engine.load_variables(variables)
    steps = []
    fb = engine.forward_backward

    def recorded(batch):
        aug_key = jax.random.split(engine._rng, 3)[1]
        loss, summary = fb(batch)
        steps.append({'aug_key': aug_key, 'loss': float(loss),
                      'image': batch['image'], 'pid': batch['pid']})
        return loss, summary

    engine.forward_backward = recorded
    captured = {}
    rank = j_metrics.evaluate_rank

    def evaluate_rank(distmat, *args, **kwargs):
        captured['distmat'] = np.asarray(distmat)
        return rank(distmat, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_metrics, 'evaluate_rank', evaluate_rank)
        cmc, mAP, ssmd, _ = engine.run(**_run_kwargs(jcfg,
                                                     j_engine_run_kwargs))
    return {'variables': jax.device_get(variables), 'steps': steps,
            'cmc': np.asarray(cmc), 'mAP': float(mAP), 'ssmd': float(ssmd),
            'distmat': captured['distmat']}


def _port_engine(save_dir, opts=(), variables=None):
    clear_dataset_cache()
    cfg = cli.build_config(_args(save_dir, ['use_gpu', 'False'] + list(opts)),
                           SMOKE)
    engine, model = cli.build_model_engine(cfg)
    if variables is not None:
        load_jax_variables(model, variables)
    return cfg, engine


def _feed_draws(engine, keys, n, h, w):
    """Each step of ``engine`` takes the draws of the next JAX key."""
    keys = iter(keys)
    losses = []

    def step(batch):
        loss, summary = ImagePartBasedEngine.forward_backward(
            engine, batch, draws=jax_draws(next(keys), n, h, w,
                                           engine.transforms))
        losses.append(float(loss))
        return loss, summary

    engine.forward_backward = step
    return losses


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    jax_out = _jax_run(tmp_path_factory.mktemp('jax'))
    cfg, engine = _port_engine(tmp_path_factory.mktemp('port'),
                               variables=jax_out['variables'])
    batches = []
    losses = _feed_draws(engine, [s['aug_key'] for s in jax_out['steps']],
                         cfg.train.batch_size, cfg.data.height,
                         cfg.data.width)
    step = engine.forward_backward

    def recorded(batch):
        batches.append({k: np.asarray(batch[k]) for k in ('image', 'pid')})
        return step(batch)

    engine.forward_backward = recorded
    results = []
    evaluate = engine.evaluate

    def captured(*args, **kwargs):
        results.append(evaluate(*args, **kwargs))
        return results[-1]

    engine.evaluate = captured
    cmc, mAP, ssmd, _ = engine.run(**_run_kwargs(cfg, engine_run_kwargs))
    return jax_out, {'cfg': cfg, 'engine': engine, 'losses': losses,
                     'batches': batches, 'cmc': cmc, 'mAP': mAP,
                     'ssmd': ssmd, 'distmat': results[-1]['distmat']}


def test_run_draws_the_same_batches(runs):
    jax_out, port = runs
    assert len(port['batches']) == len(jax_out['steps']) == 4
    for got, want in zip(port['batches'], jax_out['steps']):
        np.testing.assert_array_equal(got['image'], np.asarray(want['image']))
        np.testing.assert_array_equal(got['pid'], np.asarray(want['pid']))


def test_run_losses_match_jax(runs):
    jax_out, port = runs
    want = [s['loss'] for s in jax_out['steps']]
    np.testing.assert_allclose(port['losses'], want, rtol=1e-4)


def test_run_final_test_matches_jax(runs):
    jax_out, port = runs
    np.testing.assert_allclose(port['distmat'], jax_out['distmat'],
                               atol=1e-4)
    assert abs(port['mAP'] - jax_out['mAP']) < 1e-3
    assert port['cmc'][0] == jax_out['cmc'][0]
