"""The video path of bpbreid_tpu_torch (``data/video.py``,
``data/datasets/video_datasets.py``, ``engine/video/``) against the JAX
package's, on the CPU in f32.

- frame sampling: 'evenly' and 'all' equal to JAX's; 'random' (JAX's is
  unseeded) held to its properties;
- the synthetic tracklet set and the ``VideoDataManager``'s batches bit
  for bit, and the four parsers on fabricated trees (as
  ``tests/test_video.py``) with the same tracklet lists;
- one ``VideoTripletEngine`` step (loss 1e-4 relative; the softmax
  engine's steps in the CLI run) and the 'avg' and 'max' tracklet
  embeddings (1e-4 of
  the largest), on a reduced OSNet (one block a stage) registered under
  one name in both registries, no augmentation;
- a CLI run (``data.type video``, softmax: JAX's video triplet engine
  cannot train, a fault pinned here) against JAX's ``Engine.run``:
  losses 1e-4, CMC and mAP 1e-3, rank-1 equal.
"""
import functools
import os
import types

import jax
import numpy as np
import pytest
import torch
from scipy.io import savemat

from bpbreid_tpu import models as jmodels
from bpbreid_tpu.config import engine_run_kwargs as j_engine_run_kwargs
from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.config import lr_scheduler_kwargs as j_lr_scheduler_kwargs
from bpbreid_tpu.config import optimizer_kwargs as j_optimizer_kwargs
from bpbreid_tpu.data.datasets import video_datasets as jvd
from bpbreid_tpu.data.video import SyntheticVideoDataset as JSyntheticVideo
from bpbreid_tpu.data.video import VideoDataManager as JVideoDataManager
from bpbreid_tpu.data.video import VideoDataset as JVideoDataset
from bpbreid_tpu.engine.video import VideoSoftmaxEngine as JVideoSoftmax
from bpbreid_tpu.engine.image import ImageTripletEngine as JImageTriplet
from bpbreid_tpu.engine.video import VideoTripletEngine as JVideoTriplet
from bpbreid_tpu.models import osnet as josnet
from bpbreid_tpu.optim import build_lr_scheduler as j_build_lr_scheduler
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu.scripts.main import build_config as j_build_config
from bpbreid_tpu.scripts.main import build_datamanager as j_build_datamanager
from bpbreid_tpu.scripts.main import build_engine as j_build_engine
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.datasets import video_datasets as tvd
from bpbreid_tpu_torch.data.video import (SyntheticVideoDataset,
                                          VideoDataManager, VideoDataset)
from bpbreid_tpu_torch.engine.video import (VideoSoftmaxEngine,
                                           VideoTripletEngine)
from bpbreid_tpu_torch.models import BACKBONES, build_model
from bpbreid_tpu_torch.models import osnet as tosnet
from bpbreid_tpu_torch.optim import build_optimizer
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.weights import load_jax_variables
from tests.torch_port_helpers import (assert_close, limit_torch_threads,
                                      seeded_variables)

limit_torch_threads()

SMALL = dict(blocks=(('os',), ('os',), ('os',)), channels=(16, 32, 48, 64))
MODEL = 'osnet_video_small'
H, W = 32, 16
DM = dict(sources=['synthetic_video'], targets=['synthetic_video'],
          height=H, width=W, transforms=[], batch_size_train=4,
          batch_size_test=4, workers=1, num_instances=2,
          train_sampler='RandomIdentitySampler', seq_len=3)


@pytest.fixture(autouse=True)
def small_osnet(monkeypatch):
    """The reduced OSNet under ``MODEL`` in both packages' registries."""
    monkeypatch.setitem(BACKBONES, MODEL, lambda num_classes, **kw:
                        tosnet._osnet(num_classes=num_classes, **SMALL,
                                      **kw))
    monkeypatch.setitem(jmodels.__dict__['__model_factory'], MODEL,
                        functools.partial(josnet._osnet, **SMALL))


@pytest.mark.parametrize('method', ['evenly', 'all'])
def test_frame_indices_match_jax(method):
    for seq_len in (1, 4, 15):
        want = JVideoDataset([], [], [], seq_len=seq_len,
                             sample_method=method, verbose=False)
        got = VideoDataset([], [], [], seq_len=seq_len, sample_method=method,
                           verbose=False)
        for n in (1, 3, 4, 7, 15, 16, 31, 45):
            a, b = got._sample_indices(n), want._sample_indices(n)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_random_frame_indices():
    """Sorted, in range, ``seq_len`` of them; with replacement exactly
    when the tracklet is shorter; a seed repeats its draws."""
    ds = VideoDataset([], [], [], seq_len=8, sample_method='random', seed=5,
                      verbose=False)
    again = VideoDataset([], [], [], seq_len=8, sample_method='random',
                         seed=5, verbose=False)
    for n in (3, 8, 9, 40) * 5:
        idx = ds._sample_indices(n)
        np.testing.assert_array_equal(idx, again._sample_indices(n))
        assert len(idx) == 8 and (np.diff(idx) >= 0).all()
        assert idx.min() >= 0 and idx.max() < n
        if n >= 8:
            assert len(set(idx.tolist())) == 8
    short = np.stack([ds._sample_indices(3) for _ in range(20)])
    assert all(len(set(r.tolist())) < 8 for r in short)
    assert set(short.ravel().tolist()) == {0, 1, 2}


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_synthetic_video_and_data_manager_bit_equal():
    for kw in (dict(seq_len=4), dict(seq_len=8, tracklet_len=3),
               dict(seq_len=4, sample_method='all')):
        got, want = SyntheticVideoDataset(**kw), JSyntheticVideo(**kw)
        for mode in ('train', 'query', 'gallery'):
            for i in (0, 5):
                a, b = got.get(mode, i, 32, 16), want.get(mode, i, 32, 16)
                np.testing.assert_array_equal(a['image'], b['image'])
                assert (a['pid'], a['camid']) == (b['pid'], b['camid'])
        # frames resized as cv2.resize resizes them
        np.testing.assert_array_equal(got.get('train', 1, 48, 24)['image'],
                                      want.get('train', 1, 48, 24)['image'])
    cfg, jcfg = get_default_config(), j_default_config()
    got = VideoDataManager(config=cfg, **DM)
    want = JVideoDataManager(config=jcfg, **DM)
    assert (got.num_train_pids, got.num_train_cams) == \
        (want.num_train_pids, want.num_train_cams)
    assert got.mask_chain_kwargs() is None
    for _ in range(2):                       # the sampler carries on
        _batches_equal(list(got.train_loader), list(want.train_loader))
    for mode in ('query', 'gallery'):
        _batches_equal(list(got.test_loader['synthetic_video'][mode]),
                       list(want.test_loader['synthetic_video'][mode]))


def test_sum_of_video_datasets_fault_in_jax():
    """JAX sums datasets into an ``ImageDataset``, which cannot read a
    tracklet (a fault of the JAX package, ROADMAP); the port's sum is a
    ``VideoDataset`` with the second set's identities after the
    first's."""
    want = JSyntheticVideo(seq_len=2) + JSyntheticVideo(seq_len=2, seed=7)
    with pytest.raises(KeyError):
        want.get('train', 0, 32, 16)
    got = SyntheticVideoDataset(seq_len=2) + SyntheticVideoDataset(
        seq_len=2, seed=7)
    assert isinstance(got, VideoDataset) and got.num_train_pids == 8
    assert len(got.train) == 16 and got.train[8]['pid'] == 4
    assert got.get('train', 9, 32, 16)['image'].shape == (2, 32, 16, 3)


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, 'wb').close()


def _mars(root):
    d = root / 'mars'
    names_tr = ['0001C1T0001F001.jpg', '0001C1T0001F002.jpg',
                '0002C2T0001F001.jpg']
    names_te = ['0003C1T0001F001.jpg', '0003C2T0001F001.jpg',
                '0004C3T0001F001.jpg']
    (d / 'info').mkdir(parents=True)
    (d / 'info' / 'train_name.txt').write_text('\n'.join(names_tr) + '\n')
    (d / 'info' / 'test_name.txt').write_text('\n'.join(names_te) + '\n')
    for n in names_tr:
        _touch(str(d / 'bbox_train' / n[:4] / n))
    for n in names_te:
        _touch(str(d / 'bbox_test' / n[:4] / n))
    savemat(str(d / 'info' / 'tracks_train_info.mat'),
            {'track_train_info': np.array([[1, 2, 1, 1], [3, 3, 2, 2]])})
    savemat(str(d / 'info' / 'tracks_test_info.mat'),
            {'track_test_info': np.array([[1, 1, 3, 1], [2, 2, 3, 2],
                                          [3, 3, -1, 3]])})
    savemat(str(d / 'info' / 'query_IDX.mat'), {'query_IDX': np.array([[1]])})
    return 'Mars', {}


def _prid2011(root):
    import json
    d = root / 'prid2011'
    people = ['person_0001', 'person_0002', 'person_0003', 'person_0004']
    for cam in ('cam_a', 'cam_b'):
        for p in people:
            for f in ('0001.png', '0002.png'):
                _touch(str(d / 'prid_2011' / 'multi_shot' / cam / p / f))
    (d / 'splits_prid2011.json').write_text(json.dumps(
        [{'train': people[:2], 'test': people[2:]},
         {'train': people[2:], 'test': people[:2]}]))
    return 'PRID2011Video', {'split_id': 1}


def _ilidsvid(root):
    d = root / 'ilids-vid'
    persons = ['person001', 'person002', 'person003', 'person004']
    for cam in ('cam1', 'cam2'):
        for p in persons:
            _touch(str(d / 'i-LIDS-VID' / 'sequences' / cam / p / '0001.png'))
    (d / 'train-test people splits').mkdir(parents=True)
    savemat(str(d / 'train-test people splits' /
                'train_test_splits_ilidsvid.mat'),
            {'ls_set': np.array([[1, 2, 3, 4], [4, 2, 1, 3]])})
    return 'ILIDSVID', {'split_id': 1}


def _dukemtmcvidreid(root):
    base = root / 'dukemtmc-vidreid' / 'DukeMTMC-VideoReID'
    for subset, pid in (('train', 7), ('train', 9), ('query', 11),
                        ('gallery', 11), ('gallery', 12)):
        for f in (2, 1, 3):
            _touch(str(base / subset / '{:04d}'.format(pid) / '0001' /
                       '{:04d}_C3_F{:04d}_X1.jpg'.format(pid, f)))
    _touch(str(base / 'gallery' / '0012' / '0002' / '0012C5F0001X9.jpg'))
    return 'DukeMTMCVidReID', {}


def _relative(tracklets, root):
    return [(tuple(os.path.relpath(p, str(root)) for p in t['img_paths']),
             t['pid'], t['camid']) for t in tracklets]


@pytest.mark.parametrize('make', [_mars, _prid2011, _ilidsvid,
                                  _dukemtmcvidreid],
                         ids=['mars', 'prid2011', 'ilidsvid',
                              'dukemtmcvidreid'])
def test_video_parsers_match_jax(make, tmp_path):
    """Each package parses its own copy of the tree (splits and caches
    are written beside it), then reads its cache once more."""
    lists = {}
    for side, module in (('jax', jvd), ('port', tvd)):
        root = tmp_path / side
        name, kwargs = make(root)
        for _ in range(2):
            ds = getattr(module, name)(root=str(root), verbose=False,
                                       **kwargs)
            lists.setdefault(side, []).append(
                [_relative(getattr(ds, m), root)
                 for m in ('train', 'query', 'gallery')])
    assert lists['port'] == lists['jax']
    assert lists['port'][0] == lists['port'][1]
    assert all(lists['port'][0])


def _engine_pair(kind, pooling='avg', seed=1):
    """The JAX and the port engine of ``kind`` on the synthetic tracklets,
    the reduced OSNet with the same seeded weights, Adam."""
    jcfg, cfg = j_default_config(), get_default_config()
    for c in (jcfg, cfg):
        c.data.height, c.data.width, c.data.transforms = H, W, []
        c.train.seed = seed
    jdm = JVideoDataManager(config=jcfg, **DM)
    dm = VideoDataManager(config=cfg, **DM)
    loss = 'triplet' if kind == 'triplet' else 'softmax'
    jmodel = jmodels.build_model(MODEL, jdm.num_train_pids, loss=loss)
    tmodel = build_model(MODEL, dm.num_train_pids, loss=loss, device='cpu',
                         dtype=torch.float32)
    variables = seeded_variables(jmodel, tmodel, np.zeros((2, H, W, 3),
                                                          np.float32),
                                 train=True, seed=seed)
    jcls, tcls = {'softmax': (JVideoSoftmax, VideoSoftmaxEngine),
                  'triplet': (JVideoTriplet, VideoTripletEngine)}[kind]
    jengine = jcls(jdm, jmodel, j_build_optimizer(optim='adam', lr=3e-4),
                   config=jcfg, pooling_method=pooling)
    jengine.load_variables(variables)
    tengine = tcls(dm, tmodel, build_optimizer(tmodel, optim='adam',
                                               lr=3e-4),
                   config=cfg, pooling_method=pooling, device='cpu')
    return jengine, tengine, jdm


def _jax_flat(batch):
    """JAX's flattening (``VideoSoftmaxEngine.forward_backward``)."""
    imgs = np.asarray(batch['image'])
    b, s = imgs.shape[:2]
    return dict(batch, image=imgs.reshape(b * s, *imgs.shape[2:]),
                pid=np.repeat(np.asarray(batch['pid']), s))


def test_video_triplet_step_matches_jax():
    """JAX's triplet step is its image engine's on JAX's flattened
    batch: its ``VideoTripletEngine.forward_backward`` raises (below).
    The softmax engine's steps are held in the CLI test."""
    jengine, tengine, jdm = _engine_pair('triplet')
    batch = next(iter(jdm.train_loader))
    assert batch['image'].shape == (4, 3, H, W, 3)
    want, _ = JImageTriplet.forward_backward(jengine, _jax_flat(batch))
    got, _ = tengine.forward_backward(batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_video_triplet_step_fault_in_jax():
    """JAX's ``VideoTripletEngine`` borrows ``VideoSoftmaxEngine
    .forward_backward``, whose zero-argument ``super()`` needs a
    ``VideoSoftmaxEngine``: the first train step raises (a fault of the
    JAX package, ROADMAP), so its CLI cannot train on tracklets with
    ``loss.name triplet``. The port's engine steps (above)."""
    jengine, tengine, jdm = _engine_pair('triplet')
    batch = next(iter(jdm.train_loader))
    with pytest.raises(TypeError, match='super'):
        jengine.forward_backward(batch)
    assert not isinstance(jengine, JVideoSoftmax)
    assert np.isfinite(float(tengine.forward_backward(batch)[0]))


@pytest.mark.parametrize('pooling', ['avg', 'max'])
def test_tracklet_features_match_jax(pooling):
    jengine, tengine, jdm = _engine_pair('softmax', pooling)
    for mode in ('query', 'gallery'):
        loader = jdm.test_loader['synthetic_video'][mode]
        want = jengine._feature_extraction(loader)
        got = tengine.feature_extraction(loader)
        assert got[0].shape == (8, 512)
        assert_close(got[0], want[0], 1e-4)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


OPTS = ['data.type', 'video', 'data.sources', "['synthetic_video']",
        'data.targets', "['synthetic_video']", 'data.height', str(H),
        'data.width', str(W), 'data.transforms', '[]', 'data.workers', '1',
        'model.name', MODEL, 'model.compute_dtype', 'float32',
        'video.seq_len', '3', 'train.batch_size', '4',
        'sampler.num_instances', '2',
        'sampler.train_sampler', 'RandomIdentitySampler',
        'train.max_epoch', '2', 'train.eval_freq', '-1',
        'train.steps_per_dispatch', '1', 'test.batch_size', '4',
        'test.batches_per_dispatch', '1', 'loss.name', 'softmax',
        'video.pooling_method', 'max', 'test.normalize_feature', 'True']


def test_video_cli_matches_jax(tmp_path, monkeypatch):
    args = types.SimpleNamespace(save_dir=str(tmp_path / 'jax'), job_id=1,
                                 opts=list(OPTS))
    jcfg = j_build_config(args, None)
    jdm = j_build_datamanager(jcfg)
    jmodel = jmodels.build_model(MODEL, jdm.num_train_pids, loss='softmax',
                                 config=jcfg)
    jengine = j_build_engine(
        jcfg, jdm, jmodel, j_build_optimizer(**j_optimizer_kwargs(jcfg)),
        j_build_lr_scheduler(lr=jcfg.train.lr,
                             **j_lr_scheduler_kwargs(jcfg)), None, None)
    assert type(jengine) is JVideoSoftmax
    variables = seeded_variables(
        jmodel, build_model(MODEL, jdm.num_train_pids, loss='softmax',
                            device='cpu', dtype=torch.float32),
        np.zeros((2, H, W, 3), np.float32), train=True, seed=2)
    jengine.load_variables(variables)
    want = []
    jfb = jengine.forward_backward
    jengine.forward_backward = lambda b: (
        lambda out: (want.append(float(out[0])), out)[1])(jfb(b))
    jcmc, jmAP, _, _ = jengine.run(**j_engine_run_kwargs(jcfg),
                                   max_epoch=jcfg.train.max_epoch,
                                   eval_freq=jcfg.train.eval_freq,
                                   start_eval=jcfg.test.start_eval)

    got, build = [], cli.build_model_engine

    def build_model_engine(cfg):
        engine, model = build(cfg)
        load_jax_variables(model, jax.device_get(variables))
        return engine, model

    fb = VideoSoftmaxEngine.forward_backward

    def recorded(engine, batch, draws=None):
        out = fb(engine, batch, draws)
        got.append(float(out[0]))
        return out

    monkeypatch.setattr(cli, 'build_model_engine', build_model_engine)
    monkeypatch.setattr(VideoSoftmaxEngine, 'forward_backward', recorded)
    engine, (cmc, mAP, _, _) = cli.main(
        ['--save_dir', str(tmp_path / 'port'), '--job-id', '1',
         'use_gpu', 'False'] + OPTS)
    assert type(engine) is VideoSoftmaxEngine
    assert engine.pooling_method == 'max'
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(cmc, np.asarray(jcmc), atol=1e-3)
    assert cmc[0] == float(jcmc[0])
    assert abs(mAP - float(jmAP)) <= 1e-3
