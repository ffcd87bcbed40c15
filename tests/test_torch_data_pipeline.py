"""The data pipeline of bpbreid_tpu_torch against the JAX package's:
the synthetic datasets sample for sample, the dataset parsers on
directory trees made here, ``get()``'s decode and resize, the samplers'
index lists, ``BatchLoader``'s batches and ``ImageDataManager``.

Images are written as PNG bytes under the ``.jpg``/``.tif`` names the
parsers glob, so OpenCV (JAX) and PIL (the port) decode them to the same
pixels. The port's resize emulates ``cv2.resize(INTER_LINEAR)`` in numpy:
uint8 images bit-equal, float fields to 1e-6 (an exact 2x downscale is
OpenCV's area path there, one float32 rounding apart)."""
import io

import cv2
import numpy as np
import pytest
from PIL import Image

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.config import imagedata_kwargs as j_imagedata_kwargs
from bpbreid_tpu.data import ImageDataManager as JImageDataManager
from bpbreid_tpu.data import datasets as jds
from bpbreid_tpu.data.datasets import image_datasets as j_image_datasets
from bpbreid_tpu.data.loader import BatchLoader as JBatchLoader
from bpbreid_tpu.data.sampler import build_train_sampler as j_build_sampler
from bpbreid_tpu.ops.masks import compute_parts_num_and_names as j_parts
from bpbreid_tpu_torch.config import get_default_config, imagedata_kwargs
from bpbreid_tpu_torch.data import datasets as tds
from bpbreid_tpu_torch.data.datamanager import ImageDataManager
from bpbreid_tpu_torch.data.datasets import image_datasets
from bpbreid_tpu_torch.data.datasets.dataset import read_image, resize_linear
from bpbreid_tpu_torch.data.loader import BatchLoader
from bpbreid_tpu_torch.data.sampler import build_train_sampler
from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def _png(path, rng, h=24, w=12):
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format='PNG')
    path.write_bytes(buf.getvalue())


def _masks(path, rng, c=36, h=6, w=3):
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, rng.random((c, h, w)).astype(np.float32))


def _duke_style(root, name, rng, junk=False):
    base = root / name
    for sub, pids in (('bounding_box_train', (7, 3, 12)),
                      ('query', (3, 12)), ('bounding_box_test', (3, 12, 40))):
        for pid in pids:
            for cam in (1, 2):
                _png(base / sub / '{:04d}_c{}s1_000{}.jpg'.format(pid, cam,
                                                                   cam), rng)
        if junk and sub == 'bounding_box_test':
            _png(base / sub / '-1_c1s1_0001.jpg', rng)
            _png(base / sub / '0000_c3s1_0001.jpg', rng)
    return base


def _tree(kind, root, rng):
    """A directory tree for the parser ``kind``."""
    if kind == 'market1501':
        base = _duke_style(root, 'Market-1501-v15.09.15', rng, junk=True)
        for pid in (3, 55):
            _png(base / 'images' / '{:04d}_c6s2_0001.jpg'.format(pid), rng)
        for img in base.rglob('*.jpg'):
            _masks(base / 'masks' / 'pifpaf' / img.parent.name
                   / (img.name + '.confidence_fields.npy'), rng)
    elif kind == 'dukemtmcreid':
        _duke_style(root, 'DukeMTMC-reID', rng)
    elif kind == 'occluded_duke':
        _duke_style(root, 'Occluded_Duke', rng)
    elif kind == 'occluded_reid':
        base = root / 'Occluded_REID'
        for sub in ('occluded_body_images', 'whole_body_images'):
            for pid in (1, 4):
                for i in (1, 2):
                    _png(base / sub / '{:03d}'.format(pid)
                         / '{:03d}_{:02d}.tif'.format(pid, i), rng)
    elif kind == 'p_dukemtmc_reid':
        base = root / 'P-DukeMTMC-reID'
        for split, pids in (('train', (9, 2)), ('test', (5, 6))):
            for sub in ('whole_body_images', 'occluded_body_images'):
                for pid in pids:
                    _png(base / split / sub / '{:04d}'.format(pid)
                         / '{:04d}_c1_f01.jpg'.format(pid), rng)
    else:                                       # msmt17, V1 and V2
        version, train_d, test_d = kind.split(':')[1:]
        base = root / 'msmt17' / version
        for lst, sub, pids in (('train', train_d, (0, 1)),
                               ('val', train_d, (2,)),
                               ('query', test_d, (0, 1)),
                               ('gallery', test_d, (0, 1, 5))):
            lines = []
            for pid in pids:
                rel = '{:04d}/{:04d}_{:03d}_{:02d}_0303morning_0{}.jpg'.format(
                    pid, pid, 7, 3 + pid % 2, len(lines))
                _png(base / sub / rel, rng)
                lines.append('{} {}\n'.format(rel, pid))
            (base / 'list_{}.txt'.format(lst)).write_text(''.join(lines))


PARSERS = [
    ('market1501', 'Market1501', {'market1501_500k': True,
                                  'masks_dir': 'pifpaf'}),
    ('market1501', 'Market1501', {}),
    ('dukemtmcreid', 'DukeMTMCreID', {'masks_dir': 'pifpaf'}),
    ('occluded_duke', 'OccludedDuke', {'masks_dir': 'pifpaf'}),
    ('occluded_reid', 'OccludedReID', {'masks_dir': 'pifpaf'}),
    ('p_dukemtmc_reid', 'PDukemtmcReid', {'masks_dir': 'pifpaf'}),
    ('msmt17:MSMT17_V1:train:test', 'MSMT17', {}),
    ('msmt17:MSMT17_V2:mask_train_v2:mask_test_v2', 'MSMT17',
     {'masks_dir': 'pifpaf'}),
]


@pytest.mark.parametrize('kind, cls, kwargs', PARSERS)
def test_parsers_match_jax(tmp_path, kind, cls, kwargs):
    _tree(kind, tmp_path, np.random.default_rng(0))
    want = getattr(j_image_datasets, cls)(root=str(tmp_path), verbose=False,
                                          **kwargs)
    got = getattr(image_datasets, cls)(root=str(tmp_path), verbose=False,
                                       **kwargs)
    for mode in ('train', 'query', 'gallery'):
        assert got.data(mode) == want.data(mode), mode
    assert got.data('gallery'), kind
    assert (got.num_train_pids, got.num_train_cams) == \
        (want.num_train_pids, want.num_train_cams)


@pytest.mark.parametrize('cls, kwargs', [
    ('SyntheticDataset', {}),
    ('SyntheticDataset', {'num_pids': 5, 'height': 32, 'width': 16,
                          'seed': 3, 'imgs_per_pid_cam': 3}),
    ('SyntheticHardDataset', {'num_pids': 4, 'seed': 2}),
])
def test_synthetic_datasets_match_jax_sample_for_sample(cls, kwargs):
    want = getattr(j_image_datasets, cls)(verbose=False, **kwargs)
    got = getattr(image_datasets, cls)(verbose=False, **kwargs)
    for mode in ('train', 'query', 'gallery'):
        a, b = got.data(mode), want.data(mode)
        assert len(a) == len(b) > 0
        for s, t in zip(a, b):
            assert s.keys() == t.keys()
            for k in s:
                if isinstance(s[k], np.ndarray):
                    assert s[k].dtype == t[k].dtype
                    np.testing.assert_array_equal(s[k], t[k], err_msg=k)
                else:
                    assert s[k] == t[k], k


RESIZES = [(24, 12, 384, 128), (128, 64, 384, 128), (64, 32, 384, 128),
           (400, 200, 384, 128), (100, 37, 384, 128), (37, 23, 11, 5),
           (300, 100, 256, 128), (7, 3, 64, 32), (96, 32, 48, 16)]


@pytest.mark.parametrize('h_in, w_in, h, w', RESIZES)
def test_resize_matches_opencv(h_in, w_in, h, w):
    rng = np.random.default_rng(h_in * w_in)
    img = rng.integers(0, 256, (h_in, w_in, 3), dtype=np.uint8)
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear(img, h, w), want)
    fields = rng.random((max(2, h_in // 8), max(2, w_in // 8), 36)) \
        .astype(np.float32)
    for (fh, fw) in ((max(1, h // 8), max(1, w // 8)), (2 * fields.shape[0],
                                        fields.shape[1] // 2 or 1)):
        want = cv2.resize(fields, (fw, fh), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(fields, fh, fw)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_get_decodes_and_resizes_like_jax(tmp_path):
    _tree('market1501', tmp_path, np.random.default_rng(1))
    kw = dict(root=str(tmp_path), masks_dir='pifpaf', use_masks=True,
              verbose=False)
    want = j_image_datasets.Market1501(**kw)
    got = image_datasets.Market1501(**kw)
    path = got.data('query')[0]['img_path']
    np.testing.assert_array_equal(read_image(path),
                                  cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB))
    for mode in ('train', 'query', 'gallery'):
        for i in range(got.len(mode)):
            for size, grid in (((384, 128), (48, 16)), ((24, 12), None)):
                a = got.get(mode, i, *size, mask_grid=grid)
                b = want.get(mode, i, *size, mask_grid=grid)
                np.testing.assert_array_equal(a['image'], b['image'])
                assert a['mask'].dtype == np.float32
                np.testing.assert_allclose(a['mask'], b['mask'], atol=1e-6)


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('name', ['RandomIdentitySampler', 'RandomSampler',
                                  'SequentialSampler'])
def test_samplers_match_jax_over_two_epochs(name, seed):
    data = image_datasets.SyntheticDataset(num_pids=7, imgs_per_pid_cam=1,
                                           verbose=False).train
    data = data + data[:5]            # some pids with more images
    want = j_build_sampler(data, name, batch_size=8, num_instances=4,
                           seed=seed)
    got = build_train_sampler(data, name, batch_size=8, num_instances=4,
                              seed=seed)
    assert len(got) == len(want)
    for _ in range(2):                # the generators carry on
        a, b = list(iter(got)), list(iter(want))
        assert a == b and len(a) > 0


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batch_loader_matches_jax():
    kw = dict(num_pids=5, height=32, width=16, verbose=False, use_masks=True)
    want_ds = j_image_datasets.SyntheticDataset(**kw)
    got_ds = image_datasets.SyntheticDataset(**kw)
    # the eval loader pads the last batch (30 queries, batch 8) and the
    # train loader drops it; the images are upsampled to 48x24
    for mode, sampler in (('query', None), ('train', 'RandomIdentitySampler')):
        loaders = []
        for ds, cls, build in ((got_ds, BatchLoader, build_train_sampler),
                               (want_ds, JBatchLoader, j_build_sampler)):
            s = build(ds.train, sampler, batch_size=8, num_instances=2,
                      seed=1) if sampler else None
            loaders.append(cls(ds, mode, 8, 48, 24, sampler=s, num_workers=2,
                               drop_last=sampler is not None))
        assert len(loaders[0]) == len(loaders[1])
        for _ in range(2):
            got, want = (list(loader) for loader in loaders)
            _batches_equal(got, want)
        if mode == 'query':
            last = got[-1]
            assert last['valid'].tolist() == [True] * 6 + [False] * 2
            assert last['index'].tolist() == [24, 25, 26, 27, 28, 29, 29, 29]
            assert last['mask'].shape == (8, 6, 3, 36)


def test_datamanager_matches_jax():
    jcfg, cfg = j_default_config(), get_default_config()
    for c, parts in ((jcfg, j_parts), (cfg, compute_parts_num_and_names)):
        c.merge_from_dict({'data': {'sources': ['synthetic'],
                                    'targets': ['synthetic'], 'height': 64,
                                    'width': 32, 'workers': 2},
                           'train': {'batch_size': 8},
                           'model': {'bpbreid': {'masks': {
                               'dir': 'pifpaf', 'preprocess': 'eight'}}}})
        parts(c)
    jds.clear_dataset_cache()
    tds.clear_dataset_cache()
    want = JImageDataManager(**j_imagedata_kwargs(jcfg))
    got = ImageDataManager(**imagedata_kwargs(cfg))
    assert (got.num_train_pids, got.num_train_cams) == \
        (want.num_train_pids, want.num_train_cams)
    assert len(got.train_loader) == len(want.train_loader)
    for mode in ('query', 'gallery'):
        a = got.test_loader['synthetic'][mode]
        b = want.test_loader['synthetic'][mode]
        assert (len(a), a.dataset.len(mode)) == \
            (len(b), b.dataset.len(mode))
    a, b = got.mask_chain_kwargs(), want.mask_chain_kwargs()
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        else:
            assert a[k] == b[k], k
    _batches_equal(list(got.train_loader), list(want.train_loader))


@pytest.mark.parametrize('kwargs', [
    {'transforms': ['rf', 'ro']},
    {'targets': ['synthetic_hard'], 'load_train_targets': True},
], ids=['ro', 'load_train_targets'])
def test_datamanager_builds_ro_and_train_targets(kwargs):
    """The options the data manager refused before they were ported: the
    random occlusion runs in the train loader, the targets get a train
    loader (their parity with JAX: tests/test_torch_occlusion_options.py)."""
    tds.clear_dataset_cache()
    dm = ImageDataManager(config=get_default_config(), sources='synthetic',
                          batch_size_train=8, height=64, width=32, **kwargs)
    assert (dm.train_loader.host_transform is not None) == \
        ('ro' in kwargs.get('transforms', []))
    assert (dm.train_loader_t is not None) == \
        kwargs.get('load_train_targets', False)
    batch = next(iter(dm.train_loader_t or dm.train_loader))
    assert batch['image'].shape == (8, 64, 32, 3)


def test_registry_refuses_unported_datasets():
    """Every JAX dataset resolves (CUHK03 among them); an unknown name
    raises."""
    assert tds.get_image_dataset('cuhk03') is not None
    assert tds.get_dataset_nickname('cuhk03') == 'c3'
    with pytest.raises(ValueError, match='Invalid dataset'):
        tds.get_image_dataset('no_such_dataset')
