"""The global-embedding engines of bpbreid_tpu_torch
(``engine/image/softmax.py``, ``engine/image/triplet.py``) and their CLI
against the JAX package's, on the CPU in f32.

Each case is one CLI run of each package on the synthetic set (8
identities at 64x32, batch 8 = 2 ids x 4, one epoch of 4 steps, then the
final test on 48 query and 96 gallery images in batches of 40), with a
reduced OSNet (one block a stage) registered under one name in both
registries for the test, and no augmentation (``data.transforms []``:
JAX's draws cannot be fed to these engines). The JAX side is its
``Engine.run`` over its own data manager; the port's side is
``scripts.main.main(argv)``, with the JAX weights loaded into the model
it builds. Both samplers draw the same batches.

- ``softmax``: label-smoothed CE, the whole epoch with the base frozen
  (``train.fixbase_epoch 1``: only ``classifier`` gets a gradient),
  L2-normalized features, k-reciprocal re-ranking; with
  ``--inference-enabled`` on a folder of PNG crops;
- ``triplet``: batch-hard triplet (margin 0.3) + CE, every layer
  training, cosine distance, the CUHK03 metric; a checkpoint, from which
  a test-only run gives the same CMC and mAP (1e-6).

Tolerances: per-step losses 1e-4 relative; CMC and mAP 1e-3, SSMD 1e-3
relative (after 4 Adam steps the weights differ by the updates of
entries whose gradient is within f32 noise of 0, whose sign the two
frameworks may take apart); before training, the ``FeatureExtractor``
on an OSNet (the no-mask forward) against JAX's eval step to 1e-4 of
the largest embedding magnitude; the saved features equal the engine's
``eval_step`` on the same crops (1e-6).
"""
import functools
import os
import types

import jax
import numpy as np
import pytest

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.config import engine_run_kwargs as j_engine_run_kwargs
from bpbreid_tpu.config import imagedata_kwargs as j_imagedata_kwargs
from bpbreid_tpu.config import lr_scheduler_kwargs as j_lr_scheduler_kwargs
from bpbreid_tpu.config import optimizer_kwargs as j_optimizer_kwargs
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.data.datasets import clear_dataset_cache as j_clear_cache
from bpbreid_tpu.models import osnet as josnet
from bpbreid_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu.scripts.main import build_config as j_build_config
from bpbreid_tpu.scripts.main import build_engine as j_build_engine
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.data.datasets.dataset import read_image, write_png
from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                           ImageTripletEngine)
from bpbreid_tpu_torch.models import BACKBONES
from bpbreid_tpu_torch.models import osnet as tosnet
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.tools import FeatureExtractor
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_helpers import (assert_close, limit_torch_threads,
                                      randomize_variables)

limit_torch_threads()

SMALL = dict(blocks=(('os',), ('os',), ('os',)), channels=(16, 32, 48, 64))
MODEL = 'osnet_small'
H, W = 64, 32
OPTS = ['data.sources', "['synthetic']", 'data.targets', "['synthetic']",
        'data.height', str(H), 'data.width', str(W), 'data.transforms', '[]',
        'model.name', MODEL, 'model.compute_dtype', 'float32',
        'train.batch_size', '8', 'sampler.num_instances', '4',
        'train.max_epoch', '1', 'train.eval_freq', '-1',
        'train.steps_per_dispatch', '1', 'test.batch_size', '40',
        'test.batches_per_dispatch', '1']
CASES = {
    'softmax': ['loss.name', 'softmax', 'train.fixbase_epoch', '1',
                'train.open_layers', "['classifier']",
                'test.normalize_feature', 'True', 'test.rerank', 'True'],
    'triplet': ['loss.name', 'triplet', 'loss.triplet.weight_x', '1.0',
                'test.normalize_feature', 'False', 'test.dist_metric',
                'cosine', 'cuhk03.use_metric_cuhk03', 'True',
                'model.save_model_flag', 'True'],
}


@pytest.fixture(autouse=True)
def small_osnet(monkeypatch):
    """The reduced OSNet under ``MODEL`` in both packages' registries."""
    monkeypatch.setitem(BACKBONES, MODEL, lambda num_classes, **kw:
                        tosnet._osnet(num_classes=num_classes, **SMALL,
                                      **kw))
    monkeypatch.setitem(jmodels.__dict__['__model_factory'], MODEL,
                        functools.partial(josnet._osnet, **SMALL))


def _seeded_variables(jmodel, seed=3):
    """Variables of ``jmodel`` (with its train-mode classifier) drawn in
    numpy on the shapes of ``jax.eval_shape`` of its init: lecun-normal
    kernels, BN statistics, scales and biases perturbed."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((2, H, W, 3)), train=True))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        a = np.zeros(leaf.shape, np.float32)
        if path[-1].key == 'kernel':
            a[...] = rng.standard_normal(leaf.shape) \
                / np.sqrt(np.prod(leaf.shape[:-1]))
        return a
    return randomize_variables(
        jax.tree_util.tree_map_with_path(fill, dict(shapes)), seed)


def _jax_run(save_dir, opts):
    """The JAX engine's run from seeded variables; returns them, its
    losses, its final test and its engine."""
    j_clear_cache()
    args = types.SimpleNamespace(save_dir=str(save_dir), job_id=1,
                                 opts=OPTS + opts)
    jcfg = j_build_config(args, None)
    dm = JImageDataManager(**j_imagedata_kwargs(jcfg))
    model = jmodels.build_model(MODEL, dm.num_train_pids,
                                loss=jcfg.loss.name, config=jcfg)
    engine = j_build_engine(
        jcfg, dm, model, j_build_optimizer(**j_optimizer_kwargs(jcfg)),
        j_build_lr_scheduler(lr=jcfg.train.lr,
                             **j_lr_scheduler_kwargs(jcfg)), None, None)
    variables = _seeded_variables(model)
    engine.load_variables(variables)
    first = next(iter(dm.test_loader['synthetic']['query']))['image']
    embeddings = np.asarray(engine._eval_step(
        engine.state.params, engine.state.batch_stats, first))
    losses = []
    fb = engine.forward_backward

    def recorded(batch):
        loss, summary = fb(batch)
        losses.append(float(loss))
        return loss, summary

    engine.forward_backward = recorded
    cmc, mAP, ssmd, _ = engine.run(**j_engine_run_kwargs(jcfg),
                                   max_epoch=jcfg.train.max_epoch,
                                   eval_freq=jcfg.train.eval_freq,
                                   start_eval=jcfg.test.start_eval)
    return {'variables': jax.device_get(variables), 'losses': losses,
            'cmc': np.asarray(cmc), 'mAP': float(mAP), 'ssmd': float(ssmd),
            'first_images': first, 'embeddings': embeddings}


def _crops(folder, n=5):
    os.makedirs(folder)
    rng = np.random.default_rng(11)
    for i in range(n):
        write_png(os.path.join(folder, 'crop{}.png'.format(i)),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))


@pytest.mark.parametrize('case', sorted(CASES))
def test_cli_run_matches_jax(case, tmp_path, monkeypatch):
    want = _jax_run(tmp_path / 'jax', CASES[case])
    engine_cls = {'softmax': ImageSoftmaxEngine,
                  'triplet': ImageTripletEngine}[case]
    built, losses = {}, []
    build = cli.build_model_engine

    def build_model_engine(cfg):
        engine, model = build(cfg)
        load_jax_variables(model, want['variables'])
        # before training: the FeatureExtractor's no-mask forward on the
        # first query batch, against JAX's eval step
        got = FeatureExtractor(cfg, model=model, device='cpu',
                               verbose=False)(want['first_images'])
        assert_close(got, want['embeddings'], 1e-4)
        built['engine'] = engine
        return engine, model

    fb = engine_cls.forward_backward

    def recorded(engine, batch, draws=None):
        loss, summary = fb(engine, batch, draws)
        losses.append(float(loss))
        return loss, summary

    monkeypatch.setattr(cli, 'build_model_engine', build_model_engine)
    monkeypatch.setattr(engine_cls, 'forward_backward', recorded)
    argv = ['--save_dir', str(tmp_path / 'port'), '--job-id', '1',
            'use_gpu', 'False'] + OPTS + CASES[case]
    if case == 'softmax':
        _crops(str(tmp_path / 'crops'))
        argv[:0] = ['--inference-enabled']
        argv += ['inference.input_folder', str(tmp_path / 'crops')]
    clear_dataset_cache()
    engine, (cmc, mAP, ssmd, _) = cli.main(argv)

    assert type(engine) is engine_cls and engine is built['engine']
    assert len(losses) == len(want['losses']) == 4
    np.testing.assert_allclose(losses, want['losses'], rtol=1e-4)
    np.testing.assert_allclose(cmc, want['cmc'], atol=1e-3)
    assert abs(mAP - want['mAP']) <= 1e-3
    assert abs(ssmd - want['ssmd']) <= 1e-3 * abs(want['ssmd'])
    if case == 'softmax':
        saved = np.load(str(tmp_path / 'port' / '1' / 'embeddings_crops.npy'))
        imgs = np.stack([read_image(str(tmp_path / 'crops' /
                                        'crop{}.png'.format(i)))
                         for i in range(5)])
        assert saved.shape == (5, 512)
        assert_close(saved, engine.eval_step(imgs), 1e-6)
        assert not (tmp_path / 'port' / '1' /
                    'visibility_scores_crops.npy').exists()
    else:
        # a test-only run from the checkpoint the run wrote gives its CMC
        # and mAP
        monkeypatch.setattr(cli, 'build_model_engine', build)
        ckpt = str(tmp_path / 'port' / '1' / 'job-1_0_model.pt')
        clear_dataset_cache()
        _, (cmc_b, mAP_b, _, _) = cli.main(
            argv[:3] + ['2'] + argv[4:] + ['test.evaluate', 'True',
                                          'model.load_weights', ckpt])
        np.testing.assert_allclose(cmc_b, cmc, atol=1e-6)
        assert abs(mAP_b - mAP) <= 1e-6
