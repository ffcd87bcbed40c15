"""Grouped dispatch of bpbreid_tpu_torch (``train.steps_per_dispatch``,
``test.batches_per_dispatch``; ``engine/engine.py``, ``engine/graphs.py``)
against the JAX engine's, on the CPU in f32 (mirroring JAX's own
tests/test_engine_e2e.py:134-210).

On the CPU the k steps of ``forward_backward_multi`` run eagerly: the
CUDA graph path is checked on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 18). Here:

- the part-based engine on ``configs/bpbreid/bpbreid_synthetic_smoke.yaml``
  (resnet18 at 64x32, batch 8) with the JAX weights crossed over and the
  JAX draws fed in: ``forward_backward_multi`` on k = 3 stacked batches
  against JAX's (its ``lax.scan``), and against three single steps of
  the port bit for bit; an epoch of 4 batches at ``steps_per_dispatch``
  3 (one group, then one single step) against ``steps_per_dispatch`` 1,
  bit for bit; grouped eval at ``batches_per_dispatch`` 3 over 5 query
  and 10 gallery batches (the trailing groups padded) against per-batch
  eval (bit for bit) and JAX's grouped eval;
- the image softmax engine (a reduced OSNet, no augmentation) k = 3
  steps against JAX's ``forward_backward_multi`` and its grouped eval;
- the video engine: k = 2 steps on stacked tracklets against two single
  steps, and grouped eval against per-batch eval, bit for bit;
- the helpers' semantics against JAX's (``group_train_batches``,
  ``_eval_batch_groups``, a ``[k]`` meter update).

Tolerances against JAX (the steps at epoch 0's lr, as ``Engine.run``
sets it): the first step's loss 1e-5 relative (measured 6.4e-7), the
later steps' 1e-4, the bound tests/test_torch_engine_run.py holds each
step of this config to (measured 1.3e-5 at step 3: the f32 noise of the
gradients goes through Adam's per-entry normalization); the parameters
after k steps entry by entry to 2 k lr, with at most 0.1 % of the
entries apart by more than 1e-6 and 0.1 % by more than lr (measured: max
2.63 lr, 0.019 % and 0.0096 %): Adam moves an entry by about lr
whatever its gradient's size, so entries whose gradient lies within f32
noise of 0 may step apart; features 1e-4 absolute; CMC and mAP 1e-6.
"""
import copy
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from bpbreid_tpu.config import imagedata_kwargs as j_imagedata_kwargs
from bpbreid_tpu.config import lr_scheduler_kwargs as j_lr_scheduler_kwargs
from bpbreid_tpu.config import optimizer_kwargs as j_optimizer_kwargs
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.data.datasets import clear_dataset_cache as j_clear_cache
from bpbreid_tpu.engine.engine import Engine as JEngine
from bpbreid_tpu.engine.engine import group_train_batches as j_group
from bpbreid_tpu.models import build_model as j_build_model
from bpbreid_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu.scripts.main import build_config as j_build_config
from bpbreid_tpu.scripts.main import build_engine as j_build_engine
from bpbreid_tpu.utils.avgmeter import MetricsSummary as JMetricsSummary
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.engine import Engine, group_train_batches
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.avgmeter import MetricsSummary
from bpbreid_tpu_torch.utils.weights import (jax_variables_to_state_dict,
                                             load_jax_variables)
from tests.test_torch_engine_run import SMOKE, _seeded_variables
from tests.test_torch_train_augment import jax_draws
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

K = 3
OPTS = ['model.compute_dtype', 'float32', 'test.batch_size', '10']
LR = 3e-4


def _args(save_dir, opts):
    return types.SimpleNamespace(save_dir=str(save_dir), job_id=1,
                                 opts=OPTS + list(opts))


def _jax_engine(save_dir):
    j_clear_cache()
    jcfg = j_build_config(_args(save_dir, ['test.batches_per_dispatch',
                                           str(K)]), SMOKE)
    dm = JImageDataManager(**j_imagedata_kwargs(jcfg))
    model = j_build_model('bpbreid', dm.num_train_pids, loss='part_based',
                          config=jcfg)
    engine = j_build_engine(
        jcfg, dm, model, j_build_optimizer(**j_optimizer_kwargs(jcfg)),
        j_build_lr_scheduler(lr=jcfg.train.lr, **j_lr_scheduler_kwargs(jcfg)),
        None, None)
    variables = _seeded_variables(model, jcfg)
    engine.load_variables(variables)
    engine.update_lr(0)          # epoch 0's lr, as Engine.run sets it
    return jcfg, dm, engine, variables


def _port_engine(save_dir, variables, opts=()):
    clear_dataset_cache()
    cfg = cli.build_config(_args(save_dir, ['use_gpu', 'False'] + list(opts)),
                           SMOKE)
    engine, model = cli.build_model_engine(cfg)
    load_jax_variables(model, variables)
    engine.update_lr(0)
    return cfg, engine


def _snapshot(engine):
    return ({k: v.clone() for k, v in engine.model.state_dict().items()},
            copy.deepcopy(engine.optimizer.state_dict()),
            engine.generator.get_state())


def _restore(engine, snap):
    # the optimizer gets a copy: load_state_dict keeps tensors that fit
    model_state, opt_state, gen_state = snap
    engine.model.load_state_dict(model_state)
    engine.optimizer.load_state_dict(copy.deepcopy(opt_state))
    engine.generator.set_state(gen_state)


def _stack(batches, keys=('image', 'mask', 'pid')):
    return {k: np.stack([np.asarray(b[k]) for b in batches])
            for k in keys if batches[0].get(k) is not None}


def _aug_keys(rng, k):
    """The augmentation keys of k steps of JAX's scan from ``rng``."""
    keys = []
    for _ in range(k):
        rng, aug, _model = jax.random.split(rng, 3)
        keys.append(aug)
    return keys


@pytest.fixture(scope='module')
def smoke(tmp_path_factory):
    jcfg, jdm, jengine, variables = _jax_engine(
        tmp_path_factory.mktemp('jax'))
    cfg, engine = _port_engine(tmp_path_factory.mktemp('port'), variables)
    batches = list(itertools.islice(jdm.train_loader, K))
    return {'jcfg': jcfg, 'jdm': jdm, 'jengine': jengine,
            'variables': variables, 'cfg': cfg, 'engine': engine,
            'batches': batches, 'snap': _snapshot(engine),
            'jstate': jax.device_get(jengine.state),
            'jrng': jax.device_get(jengine._rng)}


def _port_params(engine):
    return {n: p.detach().numpy().copy()
            for n, p in engine.model.named_parameters()}


def test_multi_step_matches_jax(smoke):
    """k = 3 stacked steps: the port's ``forward_backward_multi`` (JAX
    draws fed in) against JAX's ``lax.scan`` of the same steps."""
    engine, jengine = smoke['engine'], smoke['jengine']
    _restore(engine, smoke['snap'])
    jengine.state = jax.device_put(smoke['jstate'])
    jengine._rng = jax.device_put(smoke['jrng'])
    stacked = _stack(smoke['batches'])
    n, h, w = stacked['image'].shape[1:4]
    draws = [jax_draws(key, n, h, w, engine.transforms)
             for key in _aug_keys(jengine._rng, K)]
    j_losses, j_summary = jengine.forward_backward_multi(stacked)
    losses, summary = engine.forward_backward_multi(stacked, draws=draws)
    assert tuple(losses.shape) == (K,)
    # step 1 as one step of the port (6.4e-7 measured); the later steps
    # as tests/test_torch_engine_run.py holds this config's steps
    # (1.3e-5 measured at step 3: Adam's update of the f32 noise)
    np.testing.assert_allclose(losses.numpy()[0], np.asarray(j_losses)[0],
                               rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=1e-4)
    leaf = next(iter(next(iter(summary.values())).values()))
    assert tuple(leaf.shape) == (K,)
    j_leaf = jax.tree_util.tree_leaves(j_summary)[0]
    assert j_leaf.shape[0] == K

    # the parameters after the k steps against JAX's
    want = jax_variables_to_state_dict(
        {'params': jax.device_get(jengine.state.params)})
    lr = engine.optimizer.param_groups[0]['lr']
    errs = np.concatenate([np.abs(p - np.asarray(want[name], np.float32))
                           .ravel() for name, p in _port_params(engine)
                           .items()])
    print('params: max err {:.3g} ({:.3g} lr), share above 1e-7 {:.3g}, '
          '1e-6 {:.3g}, lr {:.3g}'.format(
              errs.max(), errs.max() / lr, np.mean(errs > 1e-7),
              np.mean(errs > 1e-6), np.mean(errs > lr)))
    # measured: max 2.63 lr; 0.019 % of the entries above 1e-6, 0.0096 %
    # above lr (lr = 3.5e-6, epoch 0 of the warm-up)
    assert errs.max() <= 2 * K * lr
    assert np.mean(errs > 1e-6) <= 1e-3
    assert np.mean(errs > lr) <= 1e-3


def test_multi_step_equals_single_steps(smoke):
    """k = 3 through ``forward_backward_multi`` equal three
    ``forward_backward`` calls bit for bit (the engine's own draws)."""
    engine = smoke['engine']
    stacked = _stack(smoke['batches'])
    _restore(engine, smoke['snap'])
    single = [engine.forward_backward(b)[0] for b in smoke['batches']]
    params_single = _port_params(engine)
    _restore(engine, smoke['snap'])
    losses, _ = engine.forward_backward_multi(stacked)
    torch.testing.assert_close(losses, torch.stack(single), rtol=0, atol=0)
    for name, p in _port_params(engine).items():
        np.testing.assert_array_equal(p, params_single[name], err_msg=name)


def _epoch(engine, spd):
    engine.config.train.steps_per_dispatch = spd
    losses = []
    fb, fbm = engine.forward_backward, engine.forward_backward_multi

    def single(batch, draws=None):
        out = fb(batch, draws)
        losses.append(out[0])
        return out

    def multi(batch, draws=None):
        out = fbm(batch, draws)
        losses.extend(out[0].unbind(0))
        return out
    engine.forward_backward, engine.forward_backward_multi = single, multi
    calls = []
    state = engine.engine_state
    started = state.global_step
    try:
        meters = engine.train(0, print_freq=0)
    finally:
        del engine.forward_backward, engine.forward_backward_multi
    calls.append(state.global_step - started)
    return losses, meters, calls


def test_grouped_epoch_equals_per_batch(smoke):
    """An epoch of 4 batches at ``steps_per_dispatch`` 3 (one group of 3,
    then a single step) equals the epoch at 1: losses, parameters,
    meters (count 4 each) and the engine state's 4 batch events."""
    engine = smoke['engine']
    assert len(engine.datamanager.train_loader) == 4
    sampler = engine.datamanager.train_loader.sampler
    sampler_state = sampler._rng.getstate()
    _restore(engine, smoke['snap'])
    losses1, meters1, steps1 = _epoch(engine, 1)
    params1 = _port_params(engine)
    _restore(engine, smoke['snap'])
    sampler._rng.setstate(sampler_state)
    losses3, meters3, steps3 = _epoch(engine, K)
    assert steps1 == steps3 == [4]
    torch.testing.assert_close(torch.stack(losses3), torch.stack(losses1),
                               rtol=0, atol=0)
    for name, p in _port_params(engine).items():
        np.testing.assert_array_equal(p, params1[name], err_msg=name)
    for group, names in meters1.meters.items():
        for name, m in names.items():
            m3 = meters3.meters[group][name]
            assert m.count == m3.count == 4, (group, name)
            assert m3.avg == pytest.approx(m.avg, rel=1e-6), (group, name)


def test_grouped_eval_matches_per_batch_and_jax(smoke):
    """Grouped eval (``batches_per_dispatch`` 3; 5 query batches of 10,
    the last padded by the loader, so the second group is padded with an
    all-invalid batch) against per-batch eval and JAX's grouped eval."""
    engine, jengine, jdm = smoke['engine'], smoke['jengine'], smoke['jdm']
    _restore(engine, smoke['snap'])
    jengine.state = jax.device_put(smoke['jstate'])
    loaders = engine.datamanager.test_loader['synthetic']
    assert len(loaders['query']) % K and len(loaders['gallery']) % K
    engine.config.test.batches_per_dispatch = K
    grouped = engine.evaluate(loaders['query'], loaders['gallery'])
    fq = engine.feature_extraction(loaders['query'])
    engine.config.test.batches_per_dispatch = 1
    single = engine.evaluate(loaders['query'], loaders['gallery'])
    fq1 = engine.feature_extraction(loaders['query'])
    engine.config.test.batches_per_dispatch = K
    for a, b in zip(fq, fq1):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grouped['distmat'], single['distmat'])
    assert grouped['mAP'] == single['mAP']

    captured, extracted = {}, []
    from bpbreid_tpu import metrics as j_metrics
    rank, extract = j_metrics.evaluate_rank, jengine._feature_extraction

    def evaluate_rank(distmat, *args, **kwargs):
        captured['distmat'] = np.asarray(distmat)
        return rank(distmat, *args, **kwargs)

    def feature_extraction(loader):
        extracted.append(extract(loader))
        return extracted[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_metrics, 'evaluate_rank', evaluate_rank)
        mp.setattr(jengine, '_feature_extraction', feature_extraction)
        cmc, mAP, _ssmd, _acc = jengine._evaluate(
            0, dataset_name='synthetic',
            query_loader=jdm.test_loader['synthetic']['query'],
            gallery_loader=jdm.test_loader['synthetic']['gallery'],
            normalize_feature=True)
    jq = extracted[0]                       # the query loader's, grouped
    np.testing.assert_allclose(fq[0].numpy(), jq[0], atol=1e-4)
    np.testing.assert_allclose(fq[1].numpy(), jq[1], atol=1e-4)
    np.testing.assert_array_equal(fq[2], jq[2])
    np.testing.assert_array_equal(fq[3], jq[3])
    np.testing.assert_allclose(grouped['distmat'], captured['distmat'],
                               atol=1e-4)
    np.testing.assert_allclose(grouped['cmc'], np.asarray(cmc)[:len(
        grouped['cmc'])], atol=1e-6)
    assert abs(grouped['mAP'] - float(mAP)) <= 1e-6


def test_group_helpers_match_jax():
    """``group_train_batches`` and ``_eval_batch_groups`` group and pad as
    JAX's do; a ``[k]`` summary counts as k meter updates."""
    rng = np.random.default_rng(0)
    batches = [{'image': rng.integers(0, 255, (2, 4, 4, 3), np.uint8),
                'pid': rng.integers(0, 9, 2), 'camid': np.arange(2),
                'valid': np.array([True, i < 4])} for i in range(5)]
    got, want = list(group_train_batches(batches, 2)), list(
        j_group(batches, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])
    got = list(Engine._eval_batch_groups(batches, 3))
    want = list(JEngine._eval_batch_groups(batches, 3))
    assert [len(g) for g in got] == [len(g) for g in want] == [3, 3]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a['valid'], np.asarray(b['valid']))
            np.testing.assert_array_equal(a['image'], b['image'])
    meters, jmeters = MetricsSummary(), JMetricsSummary()
    vec = np.array([0.5, 1.25, 2.0], np.float32)
    meters.update({'g': {'loss': torch.from_numpy(vec)}})
    meters.update({'g': {'loss': torch.tensor(3.0)}})
    jmeters.update({'g': {'loss': vec}})
    jmeters.update({'g': {'loss': np.float32(3.0)}})
    assert meters.avg('g', 'loss') == jmeters.avg('g', 'loss')
    assert meters.meters['g']['loss'].count == 4
