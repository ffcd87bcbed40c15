"""Image re-id dataset parsers (port of
bpbreid_tpu/data/datasets/image_datasets.py).

Directory layouts, filename patterns and mask metadata are those of the
JAX package; only filesystem parsing lives here (decoding in the base
class, augmentation on the device). ``SyntheticDataset`` draws from
``np.random.default_rng`` in the JAX version's order, so both packages
give bit-equal samples.
"""
import glob
import os
import os.path as osp
import re

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import ImageDataset


class Market1501(ImageDataset):
    """Market-1501 (reference: image/market1501.py:11-106)."""
    _junk_pids = [0, -1]
    dataset_dir = 'Market-1501-v15.09.15'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.jpg.confidence_fields.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.npy'),
    }

    def __init__(self, root='', market1501_500k=False, masks_dir=None, **kwargs):
        self.masks_dir = masks_dir
        cfg = self.masks_dirs.get(masks_dir)
        self.masks_parts_numbers, self.has_background, self.masks_suffix = \
            cfg[:3] if cfg else (None, None, None)
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.train_dir = osp.join(self.dataset_dir, 'bounding_box_train')
        self.query_dir = osp.join(self.dataset_dir, 'query')
        self.gallery_dir = osp.join(self.dataset_dir, 'bounding_box_test')
        self.extra_gallery_dir = osp.join(self.dataset_dir, 'images')
        self.market1501_500k = market1501_500k
        required = [self.dataset_dir, self.train_dir, self.query_dir,
                    self.gallery_dir]
        if market1501_500k:
            required.append(self.extra_gallery_dir)
        self.check_before_run(required)
        train = self.process_dir(self.train_dir, relabel=True)
        query = self.process_dir(self.query_dir, relabel=False)
        gallery = self.process_dir(self.gallery_dir, relabel=False)
        if market1501_500k:
            gallery += self.process_dir(self.extra_gallery_dir, relabel=False)
        super().__init__(train, query, gallery, masks_dir=masks_dir, **kwargs)

    def process_dir(self, dir_path, relabel=False):
        img_paths = sorted(glob.glob(osp.join(dir_path, '*.jpg')))
        pattern = re.compile(r'([-\d]+)_c(\d)')
        pids = {int(pattern.search(p).group(1)) for p in img_paths
                if int(pattern.search(p).group(1)) != -1}
        pid2label = {pid: i for i, pid in enumerate(sorted(pids))}
        data = []
        for img_path in img_paths:
            pid, camid = map(int, pattern.search(img_path).groups())
            if pid == -1:
                continue
            camid -= 1
            if relabel:
                pid = pid2label[pid]
            data.append({'img_path': img_path, 'pid': pid, 'camid': camid,
                         'masks_path': self.infer_masks_path(img_path)
                         if self.masks_suffix else None})
        return data


class _DukeStyle(ImageDataset):
    """bounding_box_train/query/bounding_box_test layout with
    '<pid>_c<cam>' filenames (DukeMTMC family)."""
    max_camid = 8

    def __init__(self, root='', masks_dir=None, **kwargs):
        self.masks_dir = masks_dir
        cfg = self.masks_dirs.get(masks_dir)
        self.masks_parts_numbers, self.has_background, self.masks_suffix = \
            cfg[:3] if cfg else (None, None, None)
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.train_dir = osp.join(self.dataset_dir, 'bounding_box_train')
        self.query_dir = osp.join(self.dataset_dir, 'query')
        self.gallery_dir = osp.join(self.dataset_dir, 'bounding_box_test')
        self.check_before_run([self.dataset_dir, self.train_dir,
                               self.query_dir, self.gallery_dir])
        train = self.process_dir(self.train_dir, relabel=True)
        query = self.process_dir(self.query_dir, relabel=False)
        gallery = self.process_dir(self.gallery_dir, relabel=False)
        super().__init__(train, query, gallery, masks_dir=masks_dir, **kwargs)

    def process_dir(self, dir_path, relabel=False):
        img_paths = sorted(glob.glob(osp.join(dir_path, '*.jpg')))
        pattern = re.compile(r'([-\d]+)_c(\d)')
        pids = {int(pattern.search(p).group(1)) for p in img_paths}
        pid2label = {pid: i for i, pid in enumerate(sorted(pids))}
        data = []
        for img_path in img_paths:
            pid, camid = map(int, pattern.search(img_path).groups())
            camid -= 1
            if relabel:
                pid = pid2label[pid]
            data.append({'img_path': img_path, 'pid': pid, 'camid': camid,
                         'masks_path': self.infer_masks_path(img_path)
                         if self.masks_suffix else None})
        return data


class DukeMTMCreID(_DukeStyle):
    """(reference: image/dukemtmcreid.py)"""
    dataset_dir = 'DukeMTMC-reID'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.jpg.confidence_fields.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.npy'),
    }


class OccludedDuke(_DukeStyle):
    """(reference: image/occluded_dukemtmc.py:16-80). ``isp_6_parts``
    files carry their own background channel ahead of the five parts;
    its fourth entry names the parts, which the parsers skip (JAX's
    unpacks all four and raises: ROADMAP, "The JAX package at
    fault")."""
    dataset_dir = 'Occluded_Duke'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.jpg.confidence_fields.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.jpg.confidence_fields.npy'),
        'isp_6_parts': (5, True, '.jpg.confidence_fields.npy',
                        ['p{}'.format(p) for p in range(1, 6)]),
    }


class OccludedReID(ImageDataset):
    """Query = occluded crops, gallery = whole-body; no train split
    (reference: image/occluded_reid.py:16-90)."""
    dataset_dir = 'Occluded_REID'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.tif.confidence_fields.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.npy'),
    }

    def infer_masks_path(self, img_path):
        return os.path.join(
            self.dataset_dir, self.masks_base_dir, self.masks_dir,
            osp.basename(osp.dirname(osp.dirname(img_path))),
            osp.splitext(osp.basename(img_path))[0] + self.masks_suffix)

    def __init__(self, root='', masks_dir=None, **kwargs):
        self.masks_dir = masks_dir
        cfg = self.masks_dirs.get(masks_dir)
        self.masks_parts_numbers, self.has_background, self.masks_suffix = \
            cfg[:3] if cfg else (None, None, None)
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        self.query_dir = osp.join(self.dataset_dir, 'occluded_body_images')
        self.gallery_dir = osp.join(self.dataset_dir, 'whole_body_images')
        query = self.process_dir(self.query_dir, camid=0)
        gallery = self.process_dir(self.gallery_dir, camid=1)
        super().__init__([], query, gallery, masks_dir=masks_dir, **kwargs)

    def process_dir(self, dir_path, camid):
        img_paths = sorted(glob.glob(osp.join(dir_path, '*', '*.tif')))
        data = []
        for img_path in img_paths:
            pid = int(osp.basename(img_path).split('_')[0])
            data.append({'img_path': img_path, 'pid': pid, 'camid': camid,
                         'masks_path': self.infer_masks_path(img_path)
                         if self.masks_suffix else None})
        return data


class PDukemtmcReid(ImageDataset):
    """P-DukeMTMC: train has whole+occluded crops; query occluded,
    gallery whole (reference: image/p_dukemtmc_reid.py:17-100)."""
    dataset_dir = 'P-DukeMTMC-reID'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.jpg.confidence_fields.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.npy'),
    }

    def infer_masks_path(self, img_path):
        rel = osp.relpath(img_path, self.dataset_dir)
        return os.path.join(
            self.dataset_dir, self.masks_base_dir, self.masks_dir,
            osp.dirname(rel),
            osp.splitext(osp.basename(img_path))[0] + self.masks_suffix)

    def __init__(self, root='', masks_dir=None, **kwargs):
        self.masks_dir = masks_dir
        cfg = self.masks_dirs.get(masks_dir)
        self.masks_parts_numbers, self.has_background, self.masks_suffix = \
            cfg[:3] if cfg else (None, None, None)
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        train_dir = osp.join(self.dataset_dir, 'train')
        query_dir = osp.join(self.dataset_dir, 'test', 'occluded_body_images')
        gallery_dir = osp.join(self.dataset_dir, 'test', 'whole_body_images')
        train = self.process_train_dir(train_dir)
        query = self.process_dir(query_dir, camid=0)
        gallery = self.process_dir(gallery_dir, camid=1)
        super().__init__(train, query, gallery, masks_dir=masks_dir, **kwargs)

    def process_train_dir(self, dir_path):
        data = []
        pid_container = set()
        paths = (sorted(glob.glob(osp.join(dir_path, 'whole_body_images', '*', '*.jpg')))
                 + sorted(glob.glob(osp.join(dir_path, 'occluded_body_images', '*', '*.jpg'))))
        for p in paths:
            pid_container.add(int(osp.basename(p).split('_')[0]))
        pid2label = {pid: i for i, pid in enumerate(sorted(pid_container))}
        for camid, sub in ((1, 'whole_body_images'), (0, 'occluded_body_images')):
            for img_path in sorted(glob.glob(osp.join(dir_path, sub, '*', '*.jpg'))):
                pid = pid2label[int(osp.basename(img_path).split('_')[0])]
                data.append({'img_path': img_path, 'pid': pid, 'camid': camid,
                             'masks_path': self.infer_masks_path(img_path)
                             if self.masks_suffix else None})
        return data

    def process_dir(self, dir_path, camid):
        data = []
        for img_path in sorted(glob.glob(osp.join(dir_path, '*', '*.jpg'))):
            pid = int(osp.basename(img_path).split('_')[0])
            data.append({'img_path': img_path, 'pid': pid, 'camid': camid,
                         'masks_path': self.infer_masks_path(img_path)
                         if self.masks_suffix else None})
        return data


class MSMT17(ImageDataset):
    """MSMT17 V1/V2, list-file based (reference: image/msmt17.py:34-120)."""
    dataset_dir = 'msmt17'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.jpg.confidence_fields.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.npy'),
    }

    def __init__(self, root='', masks_dir=None, **kwargs):
        self.masks_dir = masks_dir
        cfg = self.masks_dirs.get(masks_dir)
        self.masks_parts_numbers, self.has_background, self.masks_suffix = \
            cfg[:3] if cfg else (None, None, None)
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, type(self).dataset_dir)
        if osp.exists(osp.join(self.dataset_dir, 'MSMT17_V1')):
            main_dir, train_d, test_d = 'MSMT17_V1', 'train', 'test'
        elif osp.exists(osp.join(self.dataset_dir, 'MSMT17_V2')):
            main_dir, train_d, test_d = 'MSMT17_V2', 'mask_train_v2', 'mask_test_v2'
        else:
            raise RuntimeError('Dataset folder msmt17/MSMT17_V1 or _V2 not found')
        base = osp.join(self.dataset_dir, main_dir)
        self.train_dir = osp.join(base, train_d)
        self.test_dir = osp.join(base, test_d)
        train = self.process_dir(self.train_dir, osp.join(base, 'list_train.txt'))
        train += self.process_dir(self.train_dir, osp.join(base, 'list_val.txt'))
        query = self.process_dir(self.test_dir, osp.join(base, 'list_query.txt'))
        gallery = self.process_dir(self.test_dir, osp.join(base, 'list_gallery.txt'))
        super().__init__(train, query, gallery, masks_dir=masks_dir, **kwargs)

    def process_dir(self, dir_path, list_path):
        with open(list_path) as f:
            lines = f.readlines()
        data = []
        for line in lines:
            img_rel, pid = line.split(' ')
            img_path = osp.join(dir_path, img_rel)
            camid = int(img_rel.split('_')[2]) - 1
            data.append({'img_path': img_path, 'pid': int(pid),
                         'camid': camid,
                         'masks_path': self.infer_masks_path(img_path)
                         if self.masks_suffix else None})
        return data


class SyntheticDataset(ImageDataset):
    """In-memory synthetic dataset for tests/smoke runs: random images and
    pifpaf-like gaussian confidence fields, deterministic per seed.
    Replaces the reference's need for downloaded data in CI."""
    dataset_dir = 'synthetic'
    masks_base_dir = 'masks'
    masks_dirs = {
        'pifpaf': (36, False, '.npy'),
        'pifpaf_maskrcnn_filtering': (36, False, '.npy'),
    }

    def __init__(self, root='', num_pids=8, num_cams=3, imgs_per_pid_cam=2,
                 height=64, width=32, seed=0, masks_dir=None, hard=False,
                 pattern_amp=45, color_lo=60, color_hi=180, noise=24,
                 **kwargs):
        rng = np.random.default_rng(seed)
        self.masks_parts_numbers, self.has_background, self.masks_suffix = \
            36, False, '.npy'

        def make_split(split_seed, relabel_offset=0):
            r = np.random.default_rng(split_seed)
            data = []
            for pid in range(num_pids):
                # identity signal must be consistent ACROSS splits (a
                # per-split draw makes query->gallery matching impossible
                # by construction and pins every eval at chance mAP):
                # key the base color on (dataset seed, pid) only
                pid_rng = np.random.default_rng(10_000 + seed * 100 + pid)
                base = pid_rng.integers(0, 200, size=3)
                # hard mode: the identity is a fixed low-res spatial
                # pattern (upsampled per-pid texture); the mean color is
                # per-IMAGE noise. Random-init embeddings rank by color
                # and score near chance, so retrieval quality measures
                # LEARNING, not init (the learning-gate test's dataset).
                pat = pid_rng.integers(-pattern_amp, pattern_amp + 1,
                                       (8, 4, 3))
                pattern = pat.repeat(height // 8, 0).repeat(width // 4, 1)
                for camid in range(num_cams):
                    for i in range(imgs_per_pid_cam):
                        if hard:
                            img = np.clip(
                                r.integers(color_lo, color_hi,
                                           size=3)[None, None, :]
                                + pattern
                                + r.integers(0, noise, (height, width, 3)),
                                0, 255).astype(np.uint8)
                        else:
                            img = (base[None, None, :]
                                   + r.integers(0, 56, (height, width, 3))
                                   ).astype(np.uint8)
                        # fields at ~1/8 of the image grid, like real
                        # pifpaf output (the loader ships them at this
                        # scale and the device pipeline upsamples)
                        fh = max(2, height // 8)
                        fw = max(2, width // 8)
                        masks = r.random((fh, fw, 36)).astype(np.float32) * 0.5
                        # concentrate some signal per body region
                        masks[:max(1, fh // 2), :, :5] += 0.5
                        data.append({'img': img, 'masks': masks,
                                     'img_path': 'synthetic://{}_{}_{}'.format(pid, camid, i),
                                     'masks_path': None,
                                     'pid': pid + relabel_offset,
                                     'camid': camid})
            return data

        train = make_split(seed)
        query = make_split(seed + 1)
        gallery = make_split(seed + 2) + make_split(seed + 3)
        super().__init__(train, query, gallery, masks_dir=masks_dir, **kwargs)


class SyntheticHardDataset(SyntheticDataset):
    """Hard variant of the synthetic set: identity = spatial pattern,
    color = per-image noise (see SyntheticDataset hard=True). Used by
    the learning-gate test — random-init features score near chance
    here, so eval mAP measures training progress."""
    dataset_dir = 'synthetic_hard'

    def __init__(self, **kwargs):
        kwargs['hard'] = True
        super().__init__(**kwargs)
