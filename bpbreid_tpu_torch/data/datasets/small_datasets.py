"""Small and split-based re-id dataset parsers (port of
bpbreid_tpu/data/datasets/small_datasets.py): VIPeR, iLIDS, CUHK01,
CUHK02, CUHK03, PRID, GRID, SenseReID, Partial-REID, Partial-iLIDS and
P-ETHZ.

Layouts, split protocols and file names are the JAX package's. Splits
are drawn from Python's and numpy's global generators, as there, and
written as the same ``splits*.json``, so either package reads the
other's splits. CUHK03's raw extraction reads the MATLAB v7.3 file
``cuhk-03.mat`` with ``h5py``, imported only there (the card's machine
has none; an extracted tree of JSON splits and PNGs needs none), and
writes its PNGs with the port's own encoder (``dataset.write_png``),
where JAX calls ``cv2.imwrite``: the pixels are the same, PNG being
lossless. GRID's and CUHK03's split files are read with
``scipy.io.loadmat``, imported where it is needed.
"""
import copy
import glob
import os
import os.path as osp
import random
from collections import defaultdict

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import ImageDataset, write_png
from bpbreid_tpu_torch.utils.tools import read_json, write_json

__all__ = ['VIPeR', 'iLIDS', 'CUHK01', 'CUHK02', 'CUHK03', 'PRID', 'GRID',
           'SenseReID', 'PartialREID', 'PartialiLIDS', 'PETHZ']


def _to_samples(items):
    return [{'img_path': p, 'pid': int(pid), 'camid': int(camid),
             'masks_path': None} for p, pid, camid in items]


class _SplitDataset(ImageDataset):
    """Base for datasets driven by a generated splits.json."""
    masks_suffix = None

    def _pick_split(self, split_id):
        splits = read_json(self.split_path)
        if split_id >= len(splits):
            raise ValueError('split_id exceeds range, received {}, but '
                             'expected between 0 and {}'.format(
                                 split_id, len(splits) - 1))
        return splits[split_id]


class VIPeR(_SplitDataset):
    """632 identities, one image per camera; 20 sub-splits
    (reference: image/viper.py:24-130)."""
    dataset_dir = 'viper'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.cam_a_dir = osp.join(self.dataset_dir, 'VIPeR', 'cam_a')
        self.cam_b_dir = osp.join(self.dataset_dir, 'VIPeR', 'cam_b')
        self.split_path = osp.join(self.dataset_dir, 'splits.json')
        self.check_before_run([self.dataset_dir, self.cam_a_dir,
                               self.cam_b_dir])
        self.prepare_split()
        split = self._pick_split(split_id)
        super().__init__(_to_samples(split['train']),
                         _to_samples(split['query']),
                         _to_samples(split['gallery']), **kwargs)

    def prepare_split(self):
        if osp.exists(self.split_path):
            return
        print('Creating 10 random splits of train ids and test ids')
        cam_a = sorted(glob.glob(osp.join(self.cam_a_dir, '*.bmp')))
        cam_b = sorted(glob.glob(osp.join(self.cam_b_dir, '*.bmp')))
        assert len(cam_a) == len(cam_b)
        num_pids = len(cam_a)
        num_train = num_pids // 2
        splits = []
        for _ in range(10):
            order = np.random.permutation(num_pids)
            train_idxs, test_idxs = order[:num_train], order[num_train:]
            train = []
            for pid, idx in enumerate(train_idxs):
                train += [(cam_a[idx], pid, 0), (cam_b[idx], pid, 1)]
            test_a = [(cam_a[idx], pid, 0)
                      for pid, idx in enumerate(test_idxs)]
            test_b = [(cam_b[idx], pid, 1)
                      for pid, idx in enumerate(test_idxs)]
            for q, g in ((test_a, test_b), (test_b, test_a)):
                splits.append({'train': train, 'query': q, 'gallery': g,
                               'num_train_pids': num_train,
                               'num_query_pids': num_pids - num_train,
                               'num_gallery_pids': num_pids - num_train})
        write_json(splits, self.split_path)


class iLIDS(_SplitDataset):
    """(reference: image/ilids.py:24-140)"""
    dataset_dir = 'ilids'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.data_dir = osp.join(self.dataset_dir,
                                 'i-LIDS_Pedestrian/Persons')
        self.split_path = osp.join(self.dataset_dir, 'splits.json')
        self.check_before_run([self.dataset_dir, self.data_dir])
        self.prepare_split()
        split = self._pick_split(split_id)
        train_names = split['train']
        pid2label = {int(n[:4]): i for i, n in enumerate(
            sorted({n[:4] for n in train_names}))}
        train = self._parse(train_names, pid2label)
        query = self._parse(split['query'])
        gallery = self._parse(split['gallery'])
        super().__init__(train, query, gallery, **kwargs)

    def _parse(self, img_names, pid2label=None):
        data = []
        for name in img_names:
            pid = int(name[:4])
            if pid2label is not None:
                pid = pid2label[pid]
            camid = int(name[4:7]) - 1
            data.append({'img_path': osp.join(self.data_dir, name),
                         'pid': pid, 'camid': camid, 'masks_path': None})
        return data

    def prepare_split(self):
        if osp.exists(self.split_path):
            return
        paths = glob.glob(osp.join(self.data_dir, '*.jpg'))
        img_names = [osp.basename(p) for p in paths]
        pid_dict = defaultdict(list)
        for n in img_names:
            pid_dict[int(n[:4])].append(n)
        pids = list(pid_dict.keys())
        num_train = int(len(pids) * 0.5)
        splits = []
        for _ in range(10):
            pids_copy = copy.deepcopy(pids)
            random.shuffle(pids_copy)
            train_pids = pids_copy[:num_train]
            test_pids = pids_copy[num_train:]
            train, query, gallery = [], [], []
            for pid in train_pids:
                train.extend(pid_dict[pid])
            for pid in test_pids:
                samples = random.sample(pid_dict[pid], 2)
                query.append(samples[0])
                gallery.append(samples[1])
            splits.append({'train': train, 'query': query,
                           'gallery': gallery})
        write_json(splits, self.split_path)


class CUHK01(_SplitDataset):
    """(reference: image/cuhk01.py:25-140)"""
    dataset_dir = 'cuhk01'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.campus_dir = osp.join(self.dataset_dir, 'campus')
        self.split_path = osp.join(self.dataset_dir, 'splits.json')
        self.check_before_run([self.dataset_dir, self.campus_dir])
        self.prepare_split()
        split = self._pick_split(split_id)
        super().__init__(_to_samples(split['train']),
                         _to_samples(split['query']),
                         _to_samples(split['gallery']), **kwargs)

    def prepare_split(self):
        if osp.exists(self.split_path):
            return
        img_paths = sorted(glob.glob(osp.join(self.campus_dir, '*.png')))
        img_list, pid_container = [], set()
        for p in img_paths:
            name = osp.basename(p)
            pid = int(name[:4]) - 1
            camid = (int(name[4:7]) - 1) // 2
            img_list.append((p, pid, camid))
            pid_container.add(pid)
        num_pids = len(pid_container)
        num_train = num_pids // 2
        splits = []
        for _ in range(10):
            order = np.random.permutation(num_pids)
            train_idxs = np.sort(order[:num_train])
            idx2label = {idx: i for i, idx in enumerate(train_idxs)}
            train, test_a, test_b = [], [], []
            for p, pid, camid in img_list:
                if pid in idx2label:
                    train.append((p, idx2label[pid], camid))
                elif camid == 0:
                    test_a.append((p, pid, camid))
                else:
                    test_b.append((p, pid, camid))
            for q, g in ((test_a, test_b), (test_b, test_a)):
                splits.append({'train': train, 'query': q, 'gallery': g,
                               'num_train_pids': num_train,
                               'num_query_pids': num_pids - num_train,
                               'num_gallery_pids': num_pids - num_train})
        write_json(splits, self.split_path)


class PRID(_SplitDataset):
    """Single-shot PRID2011 (reference: image/prid.py:25-120)."""
    dataset_dir = 'prid2011'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.cam_a_dir = osp.join(self.dataset_dir, 'prid_2011',
                                  'single_shot', 'cam_a')
        self.cam_b_dir = osp.join(self.dataset_dir, 'prid_2011',
                                  'single_shot', 'cam_b')
        self.split_path = osp.join(self.dataset_dir,
                                   'splits_single_shot.json')
        self.check_before_run([self.dataset_dir, self.cam_a_dir,
                               self.cam_b_dir])
        self.prepare_split()
        split = self._pick_split(split_id)
        train, query, gallery = self.process_split(split)
        super().__init__(train, query, gallery, **kwargs)

    def prepare_split(self):
        if osp.exists(self.split_path):
            return
        splits = []
        for _ in range(10):
            pids = list(range(1, 201))
            train_pids = sorted(random.sample(pids, 100))
            test_pids = [p for p in pids if p not in train_pids]
            splits.append({'train': train_pids, 'test': test_pids})
        write_json(splits, self.split_path)

    def process_split(self, split):
        train_pids, test_pids = split['train'], split['test']
        pid2label = {pid: i for i, pid in enumerate(train_pids)}
        train = []
        for pid in train_pids:
            name = 'person_' + str(pid).zfill(4) + '.png'
            train += [(osp.join(self.cam_a_dir, name), pid2label[pid], 0),
                      (osp.join(self.cam_b_dir, name), pid2label[pid], 1)]
        query, gallery = [], []
        for pid in test_pids:
            name = 'person_' + str(pid).zfill(4) + '.png'
            query.append((osp.join(self.cam_a_dir, name), pid, 0))
            gallery.append((osp.join(self.cam_b_dir, name), pid, 1))
        for pid in range(201, 750):
            name = 'person_' + str(pid).zfill(4) + '.png'
            gallery.append((osp.join(self.cam_b_dir, name), pid, 1))
        return (_to_samples(train), _to_samples(query), _to_samples(gallery))


class GRID(_SplitDataset):
    """(reference: image/grid.py:24-130)"""
    dataset_dir = 'grid'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.probe_path = osp.join(self.dataset_dir, 'underground_reid',
                                   'probe')
        self.gallery_path = osp.join(self.dataset_dir, 'underground_reid',
                                     'gallery')
        self.split_mat_path = osp.join(self.dataset_dir, 'underground_reid',
                                       'features_and_partitions.mat')
        self.split_path = osp.join(self.dataset_dir, 'splits.json')
        self.check_before_run([self.dataset_dir, self.probe_path,
                               self.gallery_path, self.split_mat_path])
        self.prepare_split()
        split = self._pick_split(split_id)
        super().__init__(_to_samples(split['train']),
                         _to_samples(split['query']),
                         _to_samples(split['gallery']), **kwargs)

    def prepare_split(self):
        if osp.exists(self.split_path):
            return
        from scipy.io import loadmat
        split_mat = loadmat(self.split_mat_path)
        train_idx_all = split_mat['trainIdxAll'][0]
        probe = sorted(glob.glob(osp.join(self.probe_path, '*.jpeg')))
        gallery = sorted(glob.glob(osp.join(self.gallery_path, '*.jpeg')))
        splits = []
        for split_idx in range(10):
            train_idxs = train_idx_all[split_idx][0][0][2][0].tolist()
            idx2label = {idx: i for i, idx in enumerate(train_idxs)}
            train, query, gall = [], [], []
            for img_path in probe:
                name = osp.basename(img_path)
                img_idx = int(name.split('_')[0])
                camid = int(name.split('_')[1]) - 1
                if img_idx in idx2label:
                    train.append((img_path, idx2label[img_idx], camid))
                else:
                    query.append((img_path, img_idx, camid))
            for img_path in gallery:
                name = osp.basename(img_path)
                img_idx = int(name.split('_')[0])
                camid = int(name.split('_')[1]) - 1
                if img_idx in idx2label:
                    train.append((img_path, idx2label[img_idx], camid))
                else:
                    gall.append((img_path, img_idx, camid))
            splits.append({'train': train, 'query': query, 'gallery': gall,
                           'num_train_pids': len(train_idxs),
                           'num_query_pids': len(train_idxs),
                           'num_gallery_pids': 900})
        write_json(splits, self.split_path)


class SenseReID(ImageDataset):
    """Test-only dataset (reference: image/sensereid.py:24-80)."""
    dataset_dir = 'sensereid'

    def __init__(self, root='', **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        query_dir = osp.join(self.dataset_dir, 'SenseReID', 'test_probe')
        gallery_dir = osp.join(self.dataset_dir, 'SenseReID', 'test_gallery')
        self.check_before_run([self.dataset_dir, query_dir, gallery_dir])
        query = self.process_dir(query_dir)
        gallery = self.process_dir(gallery_dir)
        # relabel
        g_pids = {s['pid'] for s in gallery}
        pid2label = {pid: i for i, pid in enumerate(sorted(g_pids))}
        for s in query:
            s['pid'] = pid2label[s['pid']]
        for s in gallery:
            s['pid'] = pid2label[s['pid']]
        super().__init__(copy.deepcopy(gallery), query, gallery, **kwargs)

    @staticmethod
    def process_dir(dir_path):
        data = []
        for img_path in sorted(glob.glob(osp.join(dir_path, '*.jpg'))):
            name = osp.splitext(osp.basename(img_path))[0]
            pid, camid = name.split('_')
            data.append({'img_path': img_path, 'pid': int(pid),
                         'camid': int(camid), 'masks_path': None})
        return data


class _PartialStyle(ImageDataset):
    """partial_body_images (query, cam 0) / whole_body_images (gallery,
    cam 1) layout."""
    img_glob = '*.jpg'
    nested = False

    def __init__(self, root='', **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        query_dir = osp.join(self.dataset_dir, 'partial_body_images')
        gallery_dir = osp.join(self.dataset_dir, 'whole_body_images')
        query = self.process_dir(query_dir, camid=0)
        gallery = self.process_dir(gallery_dir, camid=1)
        super().__init__([], query, gallery, **kwargs)

    def process_dir(self, dir_path, camid):
        pattern = osp.join(dir_path, '*', self.img_glob) if self.nested \
            else osp.join(dir_path, self.img_glob)
        data = []
        for img_path in sorted(glob.glob(pattern)):
            pid = int(osp.basename(img_path).split('_')[0])
            data.append({'img_path': img_path, 'pid': pid, 'camid': camid,
                         'masks_path': None})
        return data


class PartialREID(_PartialStyle):
    """(reference: image/partial_reid.py:17-60)"""
    dataset_dir = 'Partial_REID'


class PartialiLIDS(_PartialStyle):
    """(reference: image/partial_ilids.py:16-55)"""
    dataset_dir = 'Partial_iLIDS'


class PETHZ(_PartialStyle):
    """(reference: image/p_ETHZ.py:17-60); query = occluded, gallery =
    whole, nested per-identity folders of pngs."""
    dataset_dir = 'P_ETHZ'
    img_glob = '*.png'
    nested = True

    def __init__(self, root='', **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        query_dir = osp.join(self.dataset_dir, 'occluded_body_images')
        gallery_dir = osp.join(self.dataset_dir, 'whole_body_images')
        query = self.process_dir(query_dir, camid=0)
        gallery = self.process_dir(gallery_dir, camid=1)
        ImageDataset.__init__(self, [], query, gallery, **kwargs)


class CUHK02(ImageDataset):
    """Five camera pairs; P1-P5 dirs with cam1/cam2
    (reference: image/cuhk02.py). Last pair's identities form the test
    split; the rest train."""
    dataset_dir = 'cuhk02'
    cam_pairs = ['P1', 'P2', 'P3', 'P4', 'P5']
    test_cam_pair = 'P5'

    def __init__(self, root='', **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir,
                                    'Dataset')
        self.check_before_run([self.dataset_dir])
        train, query, gallery = self.get_data_list()
        super().__init__(train, query, gallery, **kwargs)

    def get_data_list(self):
        num_train_pids, camid = 0, 0
        train, query, gallery = [], [], []
        for cam_pair in self.cam_pairs:
            cam_pair_dir = osp.join(self.dataset_dir, cam_pair)
            cam1_dir = osp.join(cam_pair_dir, 'cam1')
            cam2_dir = osp.join(cam_pair_dir, 'cam2')
            impaths1 = sorted(glob.glob(osp.join(cam1_dir, '*.png')))
            impaths2 = sorted(glob.glob(osp.join(cam2_dir, '*.png')))
            if cam_pair == self.test_cam_pair:
                for impath in impaths1:
                    pid = int(osp.basename(impath).split('_')[0])
                    query.append({'img_path': impath, 'pid': pid,
                                  'camid': camid, 'masks_path': None})
                camid += 1
                for impath in impaths2:
                    pid = int(osp.basename(impath).split('_')[0])
                    gallery.append({'img_path': impath, 'pid': pid,
                                    'camid': camid, 'masks_path': None})
                camid += 1
            else:
                pids1 = [int(osp.basename(p).split('_')[0])
                         for p in impaths1]
                pids2 = [int(osp.basename(p).split('_')[0])
                         for p in impaths2]
                pid2label = {pid: i + num_train_pids for i, pid in
                             enumerate(sorted(set(pids1 + pids2)))}
                for impath, pid in zip(impaths1, pids1):
                    train.append({'img_path': impath,
                                  'pid': pid2label[pid], 'camid': camid,
                                  'masks_path': None})
                camid += 1
                for impath, pid in zip(impaths2, pids2):
                    train.append({'img_path': impath,
                                  'pid': pid2label[pid], 'camid': camid,
                                  'masks_path': None})
                camid += 1
                num_train_pids += len(pid2label)
        return train, query, gallery


class CUHK03(ImageDataset):
    """CUHK03: raw ``cuhk-03.mat`` extraction + classic (CVPR'14, 20
    single-shot splits) and new-protocol (CVPR'17) splits
    (reference: image/cuhk03.py:90-260)."""
    dataset_dir = 'cuhk03'
    eval_metric = 'cuhk03'

    def __init__(self, root='', split_id=0, cuhk03_labeled=False,
                 cuhk03_classic_split=False, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        mode_dir = 'images_labeled' if cuhk03_labeled else 'images_detected'
        tag = 'labeled' if cuhk03_labeled else 'detected'
        if cuhk03_classic_split:
            split_path = osp.join(self.dataset_dir,
                                  'splits_classic_{}.json'.format(tag))
            self.eval_metric = 'cuhk03'
        else:
            split_path = osp.join(self.dataset_dir,
                                  'splits_new_{}.json'.format(tag))
            self.eval_metric = 'default'
        self.imgs_dir = osp.join(self.dataset_dir, mode_dir)
        if not osp.exists(split_path):
            self.preprocess_split()
        if not osp.exists(split_path):
            raise RuntimeError(
                'CUHK03 split file "{}" not found and raw cuhk-03.mat not '
                'available for extraction.'.format(split_path))
        splits = read_json(split_path)
        if split_id >= len(splits):
            raise ValueError('split_id exceeds range')
        split = splits[split_id]
        super().__init__(_to_samples(split['train']),
                         _to_samples(split['query']),
                         _to_samples(split['gallery']), **kwargs)

    # ------------------------------------------------------------------
    def preprocess_split(self):
        """Extract PNGs from cuhk-03.mat and build the classic and the
        new-protocol splits (reference image/cuhk03.py:92-260)."""
        raw_mat = osp.join(self.dataset_dir, 'cuhk-03.mat')
        det_cfg = osp.join(self.dataset_dir,
                           'cuhk03_new_protocol_config_detected.mat')
        lab_cfg = osp.join(self.dataset_dir,
                           'cuhk03_new_protocol_config_labeled.mat')
        if not osp.exists(raw_mat):
            return
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                'extracting CUHK03 from {} (MATLAB v7.3) needs h5py, which '
                'is not installed; an extracted tree (splits_*.json and '
                'images_*/) needs none'.format(raw_mat)) from e
        from scipy.io import loadmat

        imgs_detected = osp.join(self.dataset_dir, 'images_detected')
        imgs_labeled = osp.join(self.dataset_dir, 'images_labeled')
        os.makedirs(imgs_detected, exist_ok=True)
        os.makedirs(imgs_labeled, exist_ok=True)
        print('Extracting image data from "{}"'.format(raw_mat))
        mat = h5py.File(raw_mat, 'r')

        def _deref(ref):
            return mat[ref][:].T

        def _process_images(img_refs, campid, pid, save_dir):
            img_paths = []
            for imgid, img_ref in enumerate(img_refs):
                img = _deref(img_ref)
                if img.size == 0 or img.ndim < 3:
                    continue
                viewid = 1 if imgid < 5 else 2
                name = '{:01d}_{:03d}_{:01d}_{:02d}.png'.format(
                    campid + 1, pid + 1, viewid, imgid + 1)
                path = osp.join(save_dir, name)
                if not osp.isfile(path):
                    write_png(path, img)
                img_paths.append(path)
            return img_paths

        def _extract_img(image_type, imgs_dir):
            meta = []
            for campid, camp_ref in enumerate(mat[image_type][0]):
                camp = _deref(camp_ref)
                for pid in range(camp.shape[0]):
                    img_paths = _process_images(camp[pid, :], campid, pid,
                                                imgs_dir)
                    assert img_paths, 'campid{}-pid{} empty'.format(campid,
                                                                    pid)
                    meta.append((campid + 1, pid + 1, img_paths))
            return meta

        meta_detected = _extract_img('detected', imgs_detected)
        meta_labeled = _extract_img('labeled', imgs_labeled)

        def _classic_split(meta_data, test_split):
            train, test = [], []
            n_train_pids = n_test_pids = 0
            for campid, pid, img_paths in meta_data:
                if [campid, pid] in test_split:
                    for p in img_paths:
                        camid = int(osp.basename(p).split('_')[2]) - 1
                        test.append((p, n_test_pids, camid))
                    n_test_pids += 1
                else:
                    for p in img_paths:
                        camid = int(osp.basename(p).split('_')[2]) - 1
                        train.append((p, n_train_pids, camid))
                    n_train_pids += 1
            return train, test, n_train_pids, n_test_pids

        print('Creating classic splits (# = 20)')
        classic_det, classic_lab = [], []
        for split_ref in mat['testsets'][0]:
            test_split = _deref(split_ref).tolist()
            for meta, out in ((meta_detected, classic_det),
                              (meta_labeled, classic_lab)):
                train, test, ntr, nte = _classic_split(meta, test_split)
                out.append({'train': train, 'query': test, 'gallery': test,
                            'num_train_pids': ntr, 'num_query_pids': nte,
                            'num_gallery_pids': nte})
        write_json(classic_det, osp.join(self.dataset_dir,
                                         'splits_classic_detected.json'))
        write_json(classic_lab, osp.join(self.dataset_dir,
                                         'splits_classic_labeled.json'))

        def _new_split(cfg_path, img_dir):
            split = loadmat(cfg_path)
            pids = split['labels'].flatten()
            train_idxs = split['train_idx'].flatten() - 1
            pid2label = {pid: i for i, pid in enumerate(
                sorted(set(pids[train_idxs])))}
            filelist = split['filelist'].flatten()

            def extract(idxs, relabel):
                out = []
                for idx in idxs:
                    name = filelist[idx][0]
                    camid = int(name.split('_')[2]) - 1
                    pid = int(pids[idx])
                    if relabel:
                        pid = pid2label[pid]
                    out.append((osp.join(img_dir, name), pid, camid))
                return out

            return [{
                'train': extract(train_idxs, True),
                'query': extract(split['query_idx'].flatten() - 1, False),
                'gallery': extract(split['gallery_idx'].flatten() - 1,
                                   False),
            }]

        if osp.exists(det_cfg):
            write_json(_new_split(det_cfg, imgs_detected),
                       osp.join(self.dataset_dir, 'splits_new_detected.json'))
        if osp.exists(lab_cfg):
            write_json(_new_split(lab_cfg, imgs_labeled),
                       osp.join(self.dataset_dir, 'splits_new_labeled.json'))
