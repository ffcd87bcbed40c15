"""Grouped dispatch of the global-embedding engines of bpbreid_tpu_torch
(``engine/image/softmax.py``, ``engine/video/softmax.py``) against the
JAX engines', on the CPU in f32, with the reduced OSNet of
tests/test_torch_video.py (one block a stage) registered in both
registries and no augmentation (JAX's draws cannot be fed to these
engines).

- image softmax engine, synthetic set at 32x16, batch 8, Adam at lr
  3e-5: k = 3 stacked steps through ``forward_backward_multi`` against
  JAX's ``lax.scan`` (the first loss 1e-5 relative, all 1e-4, as the
  engine's single steps are held in tests/test_torch_softmax_engine.py
  (measured at lr 3e-4: 2.2e-4 at step 3, hence the smaller lr); parameters entry by
  entry to 2 k lr, at most 0.1 % of the entries apart by more than
  1e-6) and against three single steps bit for bit; grouped eval at
  ``batches_per_dispatch`` 3 against JAX's grouped eval (1e-4 of the
  largest embedding) and the per-batch eval (bit for bit);
- video softmax engine, tracklets of 3 frames, batch 4: k = 2 stacked
  tracklet batches against JAX's ``forward_backward_multi`` (the first
  loss 1e-5 relative, the second 1e-3: tests/test_torch_video.py's
  engines run Adam at lr 3e-4, whose first update moves every entry by
  about lr, those with a gradient in the f32 noise either way; measured
  1.5e-4) and two single steps (bit for bit); grouped eval (a
  trailing group padded) against the per-batch eval and JAX's (1e-4);
The CPU rehearsal of the captures is in tests/test_torch_graph_rules.py.
"""
import copy
import itertools

import jax
import numpy as np
import pytest
import torch

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.engine.image import ImageSoftmaxEngine as JImageSoftmax
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.datamanager import ImageDataManager
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.engine.image import ImageSoftmaxEngine
from bpbreid_tpu_torch.engine.video.softmax import flatten_tracklets
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.optim import build_optimizer
from bpbreid_tpu_torch.utils.weights import jax_variables_to_state_dict
from tests.test_torch_video import (H, MODEL, W, _engine_pair,  # noqa: F401
                                    small_osnet)
from tests.torch_port_helpers import (assert_close, limit_torch_threads,
                                      seeded_variables)

limit_torch_threads()

K = 3
LR = 3e-5
IMAGE_DM = dict(sources=['synthetic'], targets=['synthetic'], height=H,
                width=W, transforms=[], batch_size_train=8,
                batch_size_test=10, workers=1, num_instances=4)


def _image_pair(seed=1):
    jcfg, cfg = j_default_config(), get_default_config()
    for c in (jcfg, cfg):
        c.data.height, c.data.width, c.data.transforms = H, W, []
        c.train.seed = seed
        c.test.batches_per_dispatch = K
    jdm = JImageDataManager(config=jcfg, **IMAGE_DM)
    clear_dataset_cache()
    dm = ImageDataManager(config=cfg, **IMAGE_DM)
    jmodel = jmodels.build_model(MODEL, jdm.num_train_pids, loss='softmax')
    tmodel = build_model(MODEL, dm.num_train_pids, loss='softmax',
                         device='cpu', dtype=torch.float32)
    variables = seeded_variables(jmodel, tmodel, np.zeros((2, H, W, 3),
                                                          np.float32),
                                 train=True, seed=seed)
    jengine = JImageSoftmax(jdm, jmodel, j_build_optimizer(optim='adam',
                                                           lr=LR),
                            config=jcfg)
    jengine.load_variables(variables)
    tengine = ImageSoftmaxEngine(dm, tmodel, build_optimizer(
        tmodel, optim='adam', lr=LR), config=cfg, device='cpu')
    return jengine, tengine, jdm


def _stack(batches, keys=('image', 'pid')):
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def _params(engine):
    return {n: p.detach().numpy().copy()
            for n, p in engine.model.named_parameters()}


def _snapshot(engine):
    return ({k: v.clone() for k, v in engine.model.state_dict().items()},
            copy.deepcopy(engine.optimizer.state_dict()))


def _restore(engine, snap):
    # the optimizer gets a copy: load_state_dict keeps tensors that fit
    engine.model.load_state_dict(snap[0])
    engine.optimizer.load_state_dict(copy.deepcopy(snap[1]))


def test_image_softmax_multi_step_and_grouped_eval():
    jengine, tengine, jdm = _image_pair()
    batches = list(itertools.islice(jdm.train_loader, K))
    stacked = _stack(batches)
    snap = _snapshot(tengine)
    want, _ = jengine.forward_backward_multi(stacked)
    got, summary = tengine.forward_backward_multi(stacked)
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0],
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert tuple(summary['softmax']['loss'].shape) == (K,)
    jparams = jax_variables_to_state_dict(
        {'params': jax.device_get(jengine.state.params)})
    errs = np.concatenate([np.abs(p - jparams[n]).ravel()
                           for n, p in _params(tengine).items()])
    assert errs.max() <= 2 * K * LR and np.mean(errs > 1e-6) <= 1e-3, (
        errs.max(), np.mean(errs > 1e-6))
    multi = _params(tengine)

    _restore(tengine, snap)
    single = torch.stack([tengine.forward_backward(b)[0] for b in batches])
    torch.testing.assert_close(got, single, rtol=0, atol=0)
    for name, p in _params(tengine).items():
        np.testing.assert_array_equal(p, multi[name], err_msg=name)

    for mode in ('query', 'gallery'):
        loader = jdm.test_loader['synthetic'][mode]
        assert len(loader) % K
        f_want = jengine._feature_extraction(loader)
        f_got = tengine.feature_extraction(loader)
        assert_close(f_got[0], f_want[0], 1e-4)
        for a, b in zip(f_got[1:], f_want[1:]):
            np.testing.assert_array_equal(a, b)
        tengine.config.test.batches_per_dispatch = 1
        f_one = tengine.feature_extraction(loader)
        tengine.config.test.batches_per_dispatch = K
        torch.testing.assert_close(f_got[0], f_one[0], rtol=0, atol=0)


def test_video_multi_step_and_grouped_eval():
    jengine, tengine, jdm = _engine_pair('softmax')
    for cfg in (jengine.config, tengine.config):
        cfg.test.batches_per_dispatch = K
    loader = jdm.test_loader['synthetic_video']['query']
    assert len(loader) % K
    f_want = jengine._feature_extraction(loader)
    f_got = tengine.feature_extraction(loader)
    assert_close(f_got[0], f_want[0], 1e-4)
    for a, b in zip(f_got[1:], f_want[1:]):
        np.testing.assert_array_equal(a, b)
    tengine.config.test.batches_per_dispatch = 1
    f_one = tengine.feature_extraction(loader)
    tengine.config.test.batches_per_dispatch = K
    torch.testing.assert_close(f_got[0], f_one[0], rtol=0, atol=0)

    # the train steps, after the eval at the seeded weights
    k = 2
    batches = list(itertools.islice(jdm.train_loader, k))
    stacked = _stack(batches)
    assert stacked['image'].shape[:3] == (k, 4, 3)
    snap = _snapshot(tengine)
    want, _ = jengine.forward_backward_multi(stacked)
    got, _ = tengine.forward_backward_multi(stacked)
    # the pair's Adam runs at lr 3e-4: the second step reads the first's
    # updates of near-zero gradients (1.5e-4 measured)
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0],
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)
    multi = _params(tengine)
    _restore(tengine, snap)
    single = torch.stack([tengine.forward_backward(b)[0] for b in batches])
    torch.testing.assert_close(got, single, rtol=0, atol=0)
    for name, p in _params(tengine).items():
        np.testing.assert_array_equal(p, multi[name], err_msg=name)


def test_flatten_tracklets_of_groups():
    """``[k, B, S]`` flattened at axis 1 is each step's ``[B, S]``
    flattened (B-major, S fastest; pids repeated per frame)."""
    rng = np.random.default_rng(0)
    batch = {'image': rng.integers(0, 255, (2, 3, 4, 5, 6, 3), np.uint8),
             'pid': rng.integers(0, 9, (2, 3))}
    flat = flatten_tracklets(batch, 1)
    assert flat['image'].shape == (2, 12, 5, 6, 3)
    for i in range(2):
        one = flatten_tracklets({k: v[i] for k, v in batch.items()})
        np.testing.assert_array_equal(flat['image'][i], one['image'])
        np.testing.assert_array_equal(flat['pid'][i], one['pid'])
    t = flatten_tracklets({k: torch.as_tensor(v) for k, v in batch.items()},
                          1)
    np.testing.assert_array_equal(t['pid'].numpy(), flat['pid'])
