"""BPBReID's last data and model options in bpbreid_tpu_torch against the
JAX package, on the CPU in f32:

- the ``ro`` random occlusion (``data/data_augmentation``) on the
  synthetic occluder bank and on a fabricated VOC tree, bit-equal to
  JAX's for the same seed, and its
  patch resize at 4 channels bit-equal to ``cv2.resize``; the train
  loader with ``ro`` and one worker bit-equal to JAX's; with more workers
  the port's batches stay those of one worker (JAX's follow its threads'
  order: a divergence kept on purpose);
- ``load_train_targets``: ``train_loader_t``'s batches equal;
- masks that carry their own background channel (Occluded-Duke's
  ``isp_6_parts``): the parts count, the mask chain's parameters and
  output (K + 2 channels in both: JAX prepends a second background, a
  fault the port keeps and this file pins), and a BPBReID train-mode loss
  on such masks (``SMALL_W32`` with one block a branch, 1e-5 relative);
  the pixel loss takes the resulting out-of-range targets as JAX's does,
  while the identity cross entropy still refuses them;
  JAX's ``OccludedDuke``
  cannot be built with ``isp_6_parts`` (it unpacks the four-entry
  ``masks_dirs`` tuple into three names), the port's can;
- ``dim_reduce before_and_after_pooling``: a ResNet-18 BPBReID (the
  before-pooling reduction to twice ``dim_reduce_output``; eval 1e-4,
  train 1e-3 of the largest magnitude) and the reduced HRNet-W32, which
  has no before-pooling reduction in either package.
"""
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.data.augment import mask_chain as j_mask_chain
from bpbreid_tpu.data.augment import train_augment as j_train_augment
from bpbreid_tpu.data.data_augmentation import RandomOcclusion as JRO
from bpbreid_tpu.data.datasets import clear_dataset_cache as j_clear_cache
from bpbreid_tpu.data.datasets.image_datasets import \
    OccludedDuke as JOccludedDuke
from bpbreid_tpu.engine import ImagePartBasedEngine as JEngine
from bpbreid_tpu.losses.bpa import BodyPartAttentionLoss as JBPALoss
from bpbreid_tpu.models.bpbreid import BPBreID as JBPBreID
from bpbreid_tpu.ops.masks import \
    compute_parts_num_and_names as j_parts_num
from bpbreid_tpu.optim import build_optimizer as j_build_optimizer
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.constants import PIXELS
from bpbreid_tpu_torch.data.augment import mask_chain, train_augment
from bpbreid_tpu_torch.data.data_augmentation import RandomOcclusion
from bpbreid_tpu_torch.data.datamanager import ImageDataManager
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.data.datasets.dataset import resize_linear
from bpbreid_tpu_torch.data.datasets.image_datasets import OccludedDuke
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.losses.bpa import BodyPartAttentionLoss
from bpbreid_tpu_torch.losses.cross_entropy import cross_entropy_loss
from bpbreid_tpu_torch.models.bpbreid import BPBreID as TBPBreID
from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
from bpbreid_tpu_torch.optim import build_optimizer
from tests.torch_port_helpers import (SMALL_W32, assert_close,
                                      limit_torch_threads, nchw,
                                      seeded_variables, to_nhwc, to_np)

limit_torch_threads()


@pytest.mark.parametrize('p, n', [(1.0, 1), (1.0, 2), (0.0, 1), (0.5, 1)])
def test_random_occlusion_matches_jax(p, n):
    rng = np.random.default_rng(1)
    want = JRO(p=p, n=n, seed=4)
    got = RandomOcclusion(p=p, n=n, seed=4)
    assert len(got.bank.patches) == len(want.bank.patches) == 32
    for a, b in zip(got.bank.patches, want.bank.patches):
        np.testing.assert_array_equal(a, b)
    for h, w in ((64, 32), (384, 128), (40, 100)) * 4:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        a, b = got(img), want(img)
        np.testing.assert_array_equal(a, b)
        assert (p == 0) <= (a is img)


def test_voc_occluder_bank_matches_jax(tmp_path):
    """A Pascal-VOC tree (segmentation PNGs, JPEG images, one
    segmentation too small to keep): the port's decoders (its own PNG
    reader, PIL for the JPEGs) give JAX's ``cv2.imread`` patches, and the
    occlusions drawn from them are equal."""
    rng = np.random.default_rng(5)
    for sub in ('SegmentationObject', 'JPEGImages'):
        (tmp_path / sub).mkdir()
    for i in range(4):
        h, w = (int(v) for v in rng.integers(60, 120, 2))
        seg = np.zeros((h, w, 3), np.uint8)
        if i != 2:                       # 2: no object pixels, skipped
            seg[10:50, 5:40] = rng.integers(1, 255, 3)
        cv2.imwrite(str(tmp_path / 'JPEGImages' / '{:04d}.jpg'.format(i)),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        cv2.imwrite(str(tmp_path / 'SegmentationObject' /
                        '{:04d}.png'.format(i)), seg)
    want = JRO(path=str(tmp_path), p=1.0, seed=1)
    got = RandomOcclusion(path=str(tmp_path), p=1.0, seed=1)
    assert len(got.bank.patches) == len(want.bank.patches) == 3
    for a, b in zip(got.bank.patches, want.bank.patches):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (128, 64, 3), dtype=np.uint8)
    for _ in range(4):
        np.testing.assert_array_equal(got(img), want(img))


def test_patch_resize_at_four_channels_matches_opencv():
    """OpenCV's vector code could round the 4-channel uint8 path apart
    from the 3-channel one: it does not, at the bank's patch sizes and
    the occlusion's target sizes."""
    rng = np.random.default_rng(2)
    bank = RandomOcclusion(seed=0).bank.patches
    for i in range(60):
        patch = bank[i % len(bank)] if i < 32 else rng.integers(
            0, 256, tuple(rng.integers(3, 80, 2)) + (4,), dtype=np.uint8)
        nh, nw = (int(v) for v in rng.integers(2, 200, 2))
        np.testing.assert_array_equal(resize_linear(patch, nh, nw),
                                      cv2.resize(patch, (nw, nh)))


DM = dict(sources='synthetic', batch_size_train=8, batch_size_test=8,
          num_instances=4, height=64, width=32, seed=3)


def _configs(p=0.8, n=2):
    jcfg, cfg = j_default_config(), get_default_config()
    for c in (jcfg, cfg):
        c.data.ro.p, c.data.ro.n = p, n
    return jcfg, cfg


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_ro_loader_matches_jax_with_one_worker():
    jcfg, cfg = _configs()
    j_clear_cache()
    clear_dataset_cache()
    want = JImageDataManager(config=jcfg, transforms=['rf', 'ro'],
                             workers=1, **DM)
    got = ImageDataManager(config=cfg, transforms=['rf', 'ro'], workers=1,
                           **DM)
    many = ImageDataManager(config=cfg, transforms=['rf', 'ro'], workers=4,
                            **DM)
    plain = ImageDataManager(config=cfg, transforms=['rf'], workers=1, **DM)
    for _ in range(2):                      # the generators carry on
        w, g = list(want.train_loader), list(got.train_loader)
        _batches_equal(g, w)
        _batches_equal(list(many.train_loader), g)
        occluded = [(a['image'] != b['image']).any(axis=(1, 2, 3))
                    for a, b in zip(g, plain.train_loader)]
        assert np.concatenate(occluded).mean() > 0.5
    # no occlusion at test time
    _batches_equal(list(got.test_loader['synthetic']['query']),
                   list(want.test_loader['synthetic']['query']))


def test_train_loader_t_matches_jax():
    jcfg, cfg = _configs()
    kw = dict(DM, targets=['synthetic_hard'], load_train_targets=True,
              train_sampler_t='RandomIdentitySampler', workers=2)
    j_clear_cache()
    clear_dataset_cache()
    want = JImageDataManager(config=jcfg, **kw)
    got = ImageDataManager(config=cfg, **kw)
    assert len(got.train_loader_t) == len(want.train_loader_t)
    _batches_equal(list(got.train_loader_t), list(want.train_loader_t))
    assert ImageDataManager(config=cfg, **DM).train_loader_t is None
    with pytest.raises(ValueError, match='must not overlap'):
        ImageDataManager(config=cfg, **dict(kw, targets=['synthetic']))


K = 5                                  # isp_6_parts: 5 parts + background
# SMALL_W32 with one BasicBlock a branch (as tests/test_torch_train_step.py):
# tracing JAX's train-mode HRNet is most of this file's time
ONE_BLOCK = {stage: (mods, branches, (1,) * branches, channels)
             for stage, (mods, branches, _, channels) in SMALL_W32.items()}


def _isp_masks(rng, n, h, w):
    """Fields with their own background channel first: K + 1 channels
    that sum to 1 at each pixel, at 1/8 of the image grid."""
    m = rng.gamma(0.3, size=(n, h // 8, w // 8, K + 1)).astype(np.float32)
    return m / m.sum(axis=-1, keepdims=True)


def _isp_configs():
    jcfg, cfg = j_default_config(), get_default_config()
    for c in (jcfg, cfg):
        c.data.sources = ['occluded_duke']
        c.model.bpbreid.masks.dir = 'isp_6_parts'
    j_parts_num(jcfg, JOccludedDuke.get_masks_config('isp_6_parts'))
    compute_parts_num_and_names(cfg, OccludedDuke.get_masks_config(
        'isp_6_parts'))
    return jcfg, cfg


def _mask_kwargs(jcfg, cfg):
    """Each package's data manager's mask-chain parameters, read without
    building the datasets (JAX cannot build this one)."""
    dm = dict(use_masks=True, sources=['occluded_duke'],
              masks_dir='isp_6_parts')
    want = JImageDataManager.mask_chain_kwargs(
        types.SimpleNamespace(cfg=jcfg, **dm))
    got = ImageDataManager.mask_chain_kwargs(
        types.SimpleNamespace(cfg=cfg, **dm))
    return got, want


def test_background_channel_mask_chain_matches_jax():
    jcfg, cfg = _isp_configs()
    assert cfg.model.bpbreid.masks.parts_num == \
        jcfg.model.bpbreid.masks.parts_num == K
    assert cfg.model.bpbreid.masks.parts_names == \
        jcfg.model.bpbreid.masks.parts_names
    got, want = _mask_kwargs(jcfg, cfg)
    assert got == want
    assert (got['grouping_matrix'], got['special'],
            got['background_strategy']) == (None, None, 'sum')
    masks = _isp_masks(np.random.default_rng(0), 4, 64, 32)
    up = np.repeat(np.repeat(masks, 8, axis=1), 8, axis=2)
    a = mask_chain(nchw(up), **got)
    b = j_mask_chain(jnp.asarray(up), **want)
    # a second background ahead of the file's own: K + 2 channels leave
    # the chain, where the pixel classifier has K + 1 classes (JAX fault)
    assert a.shape == (4, K + 2, 16, 8) and b.shape == (4, 16, 8, K + 2)
    assert_close(a.permute(0, 2, 3, 1), b, 1e-6)
    imgs = np.zeros((4, 64, 32, 3), np.uint8)
    a = train_augment(torch.from_numpy(imgs), torch.from_numpy(masks), {},
                      mask_kwargs=got)[1]
    b = j_train_augment(jnp.asarray(imgs), jnp.asarray(masks),
                        jax.random.PRNGKey(0), transforms=(),
                        mask_kwargs=want)[1]
    assert_close(a.permute(0, 2, 3, 1), b, 1e-6)
    assert int(a.argmax(dim=1).max()) == K + 1


def test_bpbreid_loss_on_background_channel_masks_matches_jax():
    jcfg, cfg = _isp_configs()
    got_kw, want_kw = _mask_kwargs(jcfg, cfg)
    kw = dict(num_classes=4, parts_num=K, backbone='hrnet32',
              backbone_stages=ONE_BLOCK, dim_reduce_output=32)
    h, w = 64, 32
    jmodel, tmodel = JBPBreID(**kw), TBPBreID(**kw)
    variables = seeded_variables(jmodel, tmodel, jnp.zeros((2, h, w, 3)),
                                 jnp.zeros((2, h // 4, w // 4, K + 1)),
                                 seed=6)
    dm = types.SimpleNamespace(transforms=[], norm_mean=cfg.data.norm_mean,
                               norm_std=cfg.data.norm_std,
                               mask_chain_kwargs=lambda: want_kw)
    jengine = JEngine(jcfg, dm, jmodel, j_build_optimizer(optim='adam'))
    state = jengine.load_variables(variables)
    rng = np.random.default_rng(1)
    pids = np.repeat(np.arange(2), 4)
    batch = {'image': rng.integers(0, 256, (8, h, w, 3), dtype=np.uint8),
             'mask': _isp_masks(rng, 8, h, w), 'pid': pids}
    # the chain's output is held above: JAX's loss takes the port's
    imgs, masks = (to_nhwc(t) for t in train_augment(
        torch.from_numpy(batch['image']), torch.from_numpy(batch['mask']),
        {}, mask_kwargs=got_kw))
    want, _ = jax.jit(jengine._loss_fn)(
        state.params, state.batch_stats, imgs, masks, jnp.asarray(pids),
        jax.random.PRNGKey(1))
    engine = ImagePartBasedEngine.from_config(
        cfg, tmodel, got_kw, device='cpu',
        optimizer=build_optimizer(tmodel, optim='adam'), datamanager=dm)
    got, summary = engine.forward_backward(batch, draws={})
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert np.isfinite(float(summary[PIXELS]['c'].detach()))


@pytest.mark.parametrize('loss_type', ['cl', 'fl', 'dl'])
def test_pixel_loss_takes_jax_out_of_range_targets(loss_type):
    """The pixel targets of such masks reach K + 1, one past the pixel
    classifier's classes: the port's BPA loss gives that label a row of
    zeros, as ``jax.nn.one_hot`` does (1e-6 relative), while the identity
    cross entropy keeps ``F.one_hot``'s range check and raises."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 4, 2, K + 1)).astype(np.float32)
    targets = rng.integers(0, K + 2, (2, 4, 2))
    targets[0, 0, 0] = K + 1
    want, _ = JBPALoss(loss_type)(jnp.asarray(logits), jnp.asarray(targets))
    got, _ = BodyPartAttentionLoss(loss_type)(
        torch.from_numpy(logits).permute(0, 3, 1, 2),
        torch.from_numpy(targets))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    with pytest.raises(RuntimeError):
        cross_entropy_loss(torch.from_numpy(logits[:, 0, 0]),
                           torch.tensor([0, K + 1]))


def test_occluded_duke_isp_masks_fault_in_jax(tmp_path):
    """JAX's parser unpacks ``masks_dirs['isp_6_parts']`` (four entries:
    the parts count, the background flag, the suffix, the part names)
    into three names and raises; the port's reads the first three and
    finds each image's field at the dataset's suffix."""
    root = tmp_path / 'Occluded_Duke'
    names = {'bounding_box_train': ['0001_c1_f0001.jpg', '0002_c2_f0002.jpg'],
             'query': ['0005_c1_f0003.jpg'],
             'bounding_box_test': ['0005_c2_f0004.jpg', '0007_c3_f0005.jpg']}
    for sub, files in names.items():
        (root / sub).mkdir(parents=True)
        for f in files:
            cv2.imwrite(str(root / sub / f), np.zeros((16, 8, 3), np.uint8))
            m = root / 'masks' / 'isp_6_parts' / sub
            m.mkdir(parents=True, exist_ok=True)
            np.save(str(m / (f + '.confidence_fields.npy')),
                    np.ones((K + 1, 4, 2), np.float32))
    with pytest.raises(ValueError, match='unpack'):
        JOccludedDuke(root=str(tmp_path), masks_dir='isp_6_parts',
                      use_masks=True, verbose=False)
    ds = OccludedDuke(root=str(tmp_path), masks_dir='isp_6_parts',
                      use_masks=True, verbose=False)
    assert ds.has_background and ds.num_train_pids == 2
    sample = ds.get('train', 1, 32, 16, mask_grid=(4, 2))
    assert sample['mask'].shape == (4, 2, K + 1)
    assert sample['image'].shape == (32, 16, 3)


def _model_pair(kw, h, w, seed):
    jmodel, tmodel = JBPBreID(**kw), TBPBreID(**kw)
    variables = seeded_variables(jmodel, tmodel, jnp.zeros((2, h, w, 3)),
                                 None, seed=seed)
    return jmodel, variables, tmodel


@pytest.mark.parametrize('backbone', ['resnet18', 'hrnet32'])
def test_before_and_after_pooling_matches_jax(backbone):
    kw = dict(num_classes=7, parts_num=5, backbone=backbone,
              dim_reduce='before_and_after_pooling', dim_reduce_output=32)
    if backbone == 'hrnet32':
        kw['backbone_stages'] = ONE_BLOCK
    h, w = 64, 32
    jmodel, variables, tmodel = _model_pair(kw, h, w, 5)
    before = variables['params'].get('before_pooling_dim_reduce')
    if backbone == 'resnet18':
        # 512 channels -> 2 x 32 before pooling, then 32 after
        assert before['layers.0']['kernel'].shape == (1, 1, 512, 64)
        assert tmodel.use_before_reduce and torch.equal(
            tmodel.before_pooling_dim_reduce.layers[0].weight,
            torch.from_numpy(np.asarray(before['layers.0']['kernel'])
                             .transpose(3, 2, 0, 1).copy()))
    else:
        assert before is None and not tmodel.use_before_reduce
    assert variables['params']['parts_after_pooling_dim_reduce'][
        'layers.0']['kernel'].shape[-1] == 32
    x = np.random.default_rng(0).uniform(-1, 1, (4, h, w, 3)) \
        .astype(np.float32)
    # the reduced HRNet's train mode is held by tests/test_torch_bpbreid.py;
    # here its structure and eval output
    modes = ((False, 1e-4),) if backbone == 'hrnet32' \
        else ((False, 1e-4), (True, 1e-3))
    for train, tol in modes:
        want = jax.jit(lambda v, x: jmodel.apply(
            v, x, None, train=train,
            mutable=['batch_stats'] if train else False))(variables, x)
        want = want[0] if train else want
        with torch.no_grad():
            got = tmodel.train(train)(nchw(x))
        assert got[0]['parts'].shape == (4, 5, 32)
        for key in want[0]:
            assert_close(got[0][key], want[0][key], tol)
        if not train:
            for key in want[1]:
                np.testing.assert_array_equal(to_np(got[1][key]),
                                              to_np(want[1][key]))
