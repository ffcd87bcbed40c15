"""The small and split-based dataset parsers of bpbreid_tpu_torch
(``data/datasets/small_datasets.py``) against the JAX package's, on
fabricated trees (as ``tests/test_small_datasets.py`` and
``tests/test_cuhk03_extraction.py``).

Each package parses its own copy of a tree, made the same way, after the
same seeds of Python's and numpy's global generators (the splits are
drawn from them in both); the sample lists (paths relative to the root)
and the split files written beside the tree must be equal. CUHK03's raw
extraction reads an h5py-written ``cuhk-03.mat`` (and the new-protocol
``.mat`` files): the same file names, splits and PNG pixels as JAX's
``cv2.imwrite``.
"""
import json
import os
import random

import cv2
import numpy as np
import pytest
from scipy.io import savemat

from bpbreid_tpu.data import datasets as jds
from bpbreid_tpu_torch.data import datasets as tds
from bpbreid_tpu_torch.data.datasets.dataset import read_image
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, 'wb').close()


def _viper(d):
    for i in range(8):
        _touch(str(d / 'viper/VIPeR/cam_a/{:03d}_0.bmp'.format(i)))
        _touch(str(d / 'viper/VIPeR/cam_b/{:03d}_90.bmp'.format(i)))
    return 'viper', {'split_id': 3}


def _ilids(d):
    for pid in range(1, 7):
        for cam in range(1, 4):
            _touch(str(d / 'ilids/i-LIDS_Pedestrian/Persons/{:04d}{:03d}.jpg'
                       .format(pid, cam)))
    return 'ilids', {'split_id': 2}


def _cuhk01(d):
    for pid in range(1, 7):
        for img in range(1, 5):
            _touch(str(d / 'cuhk01/campus/{:04d}{:03d}.png'.format(pid, img)))
    return 'cuhk01', {'split_id': 1}


def _cuhk02(d):
    for pair in ('P1', 'P2', 'P5'):
        for cam in ('cam1', 'cam2'):
            for pid in (3, 1, 2):
                _touch(str(d / 'cuhk02/Dataset' / pair / cam /
                           '{}_{}{}.png'.format(pid, pair, cam[-1])))
    return 'cuhk02', {}


def _prid(d):
    for pid in range(1, 750):
        name = 'person_{:04d}.png'.format(pid)
        if pid <= 385:
            _touch(str(d / 'prid2011/prid_2011/single_shot/cam_a' / name))
        _touch(str(d / 'prid2011/prid_2011/single_shot/cam_b' / name))
    return 'prid', {'split_id': 4}


def _grid(d):
    base = d / 'grid' / 'underground_reid'
    for idx in range(0, 7):
        for cam in (1, 2):
            if idx:
                _touch(str(base / 'probe' / '{:04d}_{}_1_2_3.jpeg'.format(
                    idx, cam)))
            _touch(str(base / 'gallery' / '{:04d}_{}_4_5_6.jpeg'.format(
                idx, cam + 3)))
    # trainIdxAll: a 1 x 10 cell of structs whose third field lists the
    # split's training identities
    cells = np.empty((1, 10), dtype=object)
    rng = np.random.default_rng(0)
    for i in range(10):
        rec = np.empty((1, 1), dtype=[('a', 'O'), ('b', 'O'),
                                      ('idxtrain', 'O')])
        rec[0, 0] = (np.zeros((1, 1)), np.zeros((1, 1)),
                     np.sort(rng.choice(np.arange(1, 7), 3,
                                        replace=False))[None].astype(float))
        cells[0, i] = rec
    savemat(str(base / 'features_and_partitions.mat'), {'trainIdxAll': cells})
    return 'grid', {'split_id': 5}


def _sensereid(d):
    for pid in (4, 1, 9):
        for cam in range(2):
            for sub in ('test_probe', 'test_gallery'):
                _touch(str(d / 'sensereid/SenseReID' / sub /
                           '{}_{}.jpg'.format(pid, cam)))
    return 'sensereid', {}


def _partial(name):
    def make(d):
        for pid in range(1, 5):
            for j in range(2):
                for sub in ('partial_body_images', 'whole_body_images'):
                    _touch(str(d / name / sub / '{:03d}_{}.jpg'.format(pid,
                                                                      j)))
        return {'Partial_REID': 'partial_reid',
                'Partial_iLIDS': 'partial_ilids'}[name], {}
    return make


def _pethz(d):
    for pid in range(1, 4):
        for j in range(2):
            for sub in ('occluded_body_images', 'whole_body_images'):
                _touch(str(d / 'P_ETHZ' / sub / str(pid) /
                           '{}_{:02d}.png'.format(pid, j)))
    return 'p_ETHZ', {}


def _cuhk03_extracted(d):
    """An extracted tree: the new-protocol labeled split and its PNGs."""
    root = d / 'cuhk03'
    split = {'train': [], 'query': [], 'gallery': []}
    for campid, pid, view, img in ((1, 1, 1, 1), (1, 1, 2, 6), (1, 2, 1, 2),
                                   (1, 2, 2, 7), (2, 3, 1, 1), (2, 3, 2, 8)):
        name = '{}_{:03d}_{}_{:02d}.png'.format(campid, pid, view, img)
        path = str(root / 'images_labeled' / name)
        _touch(path)
        if pid < 3:
            split['train'].append([path, pid - 1, view - 1])
        else:
            split['query' if view == 1 else 'gallery'].append(
                [path, pid, view - 1])
    (root / 'splits_new_labeled.json').write_text(json.dumps([split]))
    return 'cuhk03', {'cuhk03_labeled': True}


TREES = {'viper': _viper, 'ilids': _ilids, 'cuhk01': _cuhk01,
         'cuhk02': _cuhk02, 'cuhk03': _cuhk03_extracted, 'prid': _prid,
         'grid': _grid, 'sensereid': _sensereid,
         'partial_reid': _partial('Partial_REID'),
         'partial_ilids': _partial('Partial_iLIDS'), 'p_ETHZ': _pethz}


def _relative(obj, root):
    """Paths under ``root`` made relative, recursively."""
    if isinstance(obj, dict):
        return {k: _relative(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_relative(v, root) for v in obj]
    if isinstance(obj, str) and obj.startswith(root):
        return os.path.relpath(obj, root)
    return obj


def _parse(registry, name, root, kwargs):
    registry.clear_dataset_cache()
    random.seed(0)
    np.random.seed(0)
    ds = registry.init_image_dataset(name, root=root, mode='train',
                                     verbose=False, **kwargs)
    samples = {m: _relative(ds.data(m), root)
               for m in ('train', 'query', 'gallery')}
    splits = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith('.json'):
                with open(os.path.join(dirpath, f)) as fh:
                    splits[f] = _relative(json.load(fh), root)
    return ds, samples, splits


@pytest.mark.parametrize('name', sorted(TREES))
def test_parser_matches_jax(name, tmp_path):
    out = {}
    for side, registry in (('jax', jds), ('port', tds)):
        root = tmp_path / side
        ds_name, kwargs = TREES[name](root)
        out[side] = _parse(registry, ds_name, str(root), kwargs)
    (jds_, want, want_splits), (got_ds, got, got_splits) = \
        out['jax'], out['port']
    assert got == want
    assert got_splits == want_splits
    assert got['query'] and got['gallery']
    assert (got_ds.num_train_pids, got_ds.num_train_cams) == \
        (jds_.num_train_pids, jds_.num_train_cams)
    assert got_ds.eval_metric == jds_.eval_metric
    assert tds.get_dataset_nickname(name) == jds.get_dataset_nickname(name)


def _make_cuhk03_mat(path, ncamp=2, npids=3, nimgs=4):
    """cuhk-03.mat as MATLAB v7.3 stores it (h5py references, arrays
    transposed), as ``tests/test_cuhk03_extraction.py`` builds it, with
    seeded pixels."""
    import h5py
    rng = np.random.default_rng(3)
    with h5py.File(path, 'w') as f:
        counter = [0]

        def img_ref(empty=False):
            name = 'img{}'.format(counter[0])
            counter[0] += 1
            data = np.zeros((1, 1), np.uint8) if empty else rng.integers(
                0, 255, (3, 8, 16), dtype=np.uint8)
            return f.create_dataset(name, data=data).ref

        for image_type in ('detected', 'labeled'):
            camp_refs = []
            for c in range(ncamp):
                refs = np.empty((10, npids), dtype=h5py.ref_dtype)
                for p in range(npids):
                    for i in range(10):
                        refs[i, p] = img_ref(empty=i >= nimgs)
                camp_refs.append(f.create_dataset(
                    '{}_camp{}'.format(image_type, c), data=refs).ref)
            arr = np.empty((1, ncamp), dtype=h5py.ref_dtype)
            arr[0, :] = camp_refs
            f.create_dataset(image_type, data=arr)
        split = f.create_dataset('testset0', data=np.array([[1.0], [1.0]]))
        arr = np.empty((1, 1), dtype=h5py.ref_dtype)
        arr[0, 0] = split.ref
        f.create_dataset('testsets', data=arr)


def _new_protocol_mat(path, names):
    """A new-protocol split file over ``names`` (1-based indices)."""
    pids = np.array([int(n.split('_')[1]) for n in names])
    filelist = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        filelist[i, 0] = np.array([n])
    idx = np.arange(1, len(names) + 1)
    train = idx[pids <= 2]
    test = idx[pids > 2]
    savemat(path, {'labels': pids[:, None], 'filelist': filelist,
                   'train_idx': train[:, None], 'query_idx': test[:1, None],
                   'gallery_idx': test[1:, None]})


@pytest.mark.parametrize('classic, labeled', [(True, False), (False, True)],
                         ids=['classic_detected', 'new_labeled'])
def test_cuhk03_extraction_matches_jax(classic, labeled, tmp_path):
    out = {}
    for side, registry in (('jax', jds), ('port', tds)):
        d = tmp_path / side / 'cuhk03'
        d.mkdir(parents=True)
        _make_cuhk03_mat(str(d / 'cuhk-03.mat'))
        names = ['1_{:03d}_{}_{:02d}.png'.format(pid, 1 if i < 5 else 2,
                                                   i + 1)
                 for pid in (1, 2, 3) for i in (0, 1, 2, 3)]
        for tag in ('detected', 'labeled'):
            _new_protocol_mat(str(d / 'cuhk03_new_protocol_config_{}.mat'
                                  .format(tag)), names)
        out[side] = _parse(registry, 'cuhk03', str(tmp_path / side),
                           {'cuhk03_classic_split': classic,
                            'cuhk03_labeled': labeled})
    (jds_, want, want_splits), (got_ds, got, got_splits) = \
        out['jax'], out['port']
    assert got == want and got_splits == want_splits
    assert set(got_splits) == {'splits_classic_detected.json',
                               'splits_classic_labeled.json',
                               'splits_new_detected.json',
                               'splits_new_labeled.json'}
    assert got_ds.eval_metric == jds_.eval_metric == (
        'cuhk03' if classic else 'default')
    for sub in ('images_detected', 'images_labeled'):
        files = sorted(os.listdir(str(tmp_path / 'jax' / 'cuhk03' / sub)))
        assert files == sorted(os.listdir(str(tmp_path / 'port' / 'cuhk03'
                                              / sub)))
        assert len(files) == 2 * 3 * 4
        for f in files:
            a = read_image(str(tmp_path / 'port' / 'cuhk03' / sub / f))
            b = cv2.cvtColor(cv2.imread(str(tmp_path / 'jax' / 'cuhk03' /
                                            sub / f)), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(a, b)
    sample = got_ds.get('train', 0, 32, 16)
    assert sample['image'].shape == (32, 16, 3)


def test_cuhk03_extraction_names_h5py_when_missing(tmp_path, monkeypatch):
    """The card's machine has no h5py: the raw extraction says so; an
    extracted tree needs none (``test_parser_matches_jax[cuhk03]``)."""
    import builtins
    d = tmp_path / 'cuhk03'
    d.mkdir()
    (d / 'cuhk-03.mat').write_bytes(b'')
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == 'h5py':
            raise ImportError('No module named h5py')
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, '__import__', no_h5py)
    tds.clear_dataset_cache()
    with pytest.raises(ImportError, match='needs h5py'):
        tds.init_image_dataset('cuhk03', root=str(tmp_path), verbose=False)
