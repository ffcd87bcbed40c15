"""The video (tracklet) dataset parsers (port of
bpbreid_tpu/data/datasets/video_datasets.py): MARS, iLIDS-VID, PRID2011
(multi-shot) and DukeMTMC-VideoReID, registered in ``data/video.py``'s
registry as ``mars``, ``ilidsvid``, ``prid2011`` and
``dukemtmcvidreid``. Samples are tracklet dicts ``{img_paths: tuple,
pid: int, camid: int}``; the ``.mat`` metadata is read with
``scipy.io.loadmat``, imported where it is needed, and the cached splits
are the JAX package's JSON.
"""
import glob
import os.path as osp
import warnings

import numpy as np

from bpbreid_tpu_torch.data.video import VideoDataset, register_video_dataset
from bpbreid_tpu_torch.utils.tools import read_json, write_json

__all__ = ['Mars', 'ILIDSVID', 'PRID2011Video', 'DukeMTMCVidReID']


def _tracklet(img_paths, pid, camid):
    return {'img_paths': tuple(img_paths), 'pid': int(pid),
            'camid': int(camid)}


class Mars(VideoDataset):
    """MARS (reference: video/mars.py:9-133). Tracklet metadata comes
    from info/tracks_{train,test}_info.mat ([start, end, pid, camid]
    rows over the name lists) with query tracklets selected by
    query_IDX.mat; pid -1 rows are junk and dropped."""
    dataset_dir = 'mars'

    def __init__(self, root='', **kwargs):
        from scipy.io import loadmat
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        info = osp.join(self.dataset_dir, 'info')
        self.check_before_run([
            self.dataset_dir,
            osp.join(info, 'train_name.txt'),
            osp.join(info, 'test_name.txt'),
            osp.join(info, 'tracks_train_info.mat'),
            osp.join(info, 'tracks_test_info.mat'),
            osp.join(info, 'query_IDX.mat'),
        ])
        train_names = self._read_names(osp.join(info, 'train_name.txt'))
        test_names = self._read_names(osp.join(info, 'test_name.txt'))
        track_train = loadmat(
            osp.join(info, 'tracks_train_info.mat'))['track_train_info']
        track_test = loadmat(
            osp.join(info, 'tracks_test_info.mat'))['track_test_info']
        query_idx = np.atleast_1d(loadmat(
            osp.join(info, 'query_IDX.mat'))['query_IDX'].squeeze()) - 1
        gallery_idx = [i for i in range(track_test.shape[0])
                       if i not in set(query_idx.tolist())]
        train = self._parse(train_names, track_train, 'bbox_train',
                            relabel=True)
        query = self._parse(test_names, track_test[query_idx], 'bbox_test')
        gallery = self._parse(test_names, track_test[gallery_idx],
                              'bbox_test')
        super().__init__(train, query, gallery, **kwargs)

    @staticmethod
    def _read_names(path):
        with open(path) as f:
            return [line.rstrip() for line in f]

    def _parse(self, names, meta, home_dir, relabel=False, min_seq_len=0):
        pids = sorted(set(int(p) for p in meta[:, 2]))
        pid2label = {pid: i for i, pid in enumerate(pids)}
        tracklets = []
        for start, end, pid, camid in np.asarray(meta, dtype=np.int64):
            if pid == -1:
                continue                      # junk tracklet
            img_names = names[start - 1:end]
            if len(set(n[:4] for n in img_names)) != 1:
                raise ValueError('tracklet mixes persons')
            if len(set(n[5] for n in img_names)) != 1:
                raise ValueError('tracklet mixes cameras')
            paths = [osp.join(self.dataset_dir, home_dir, n[:4], n)
                     for n in img_names]
            if len(paths) >= min_seq_len:
                tracklets.append(_tracklet(
                    paths, pid2label[pid] if relabel else pid, camid - 1))
        return tracklets

    def combine_all(self):
        warnings.warn('combine_all has no effect on MARS (some query ids '
                      'are absent from the gallery)')


class _TwoCamSplitVideoDataset(VideoDataset):
    """Shared logic for iLIDS-VID / PRID2011: per-person directories
    under two camera roots, train/test person-name splits, camera-1
    queries vs camera-2 galleries."""

    def _build(self, split, cam1_dir, cam2_dir, pattern, **kwargs):
        train_dirs, test_dirs = split['train'], split['test']
        train = self._parse(train_dirs, cam1_dir, cam2_dir, pattern,
                            cam1=True, cam2=True)
        query = self._parse(test_dirs, cam1_dir, cam2_dir, pattern,
                            cam1=True, cam2=False)
        gallery = self._parse(test_dirs, cam1_dir, cam2_dir, pattern,
                              cam1=False, cam2=True)
        super().__init__(train, query, gallery, **kwargs)

    @staticmethod
    def _parse(dirnames, cam1_dir, cam2_dir, pattern, cam1, cam2):
        pid_map = {d: i for i, d in enumerate(dirnames)}
        tracklets = []
        for d in dirnames:
            for enabled, cam_dir, camid in ((cam1, cam1_dir, 0),
                                            (cam2, cam2_dir, 1)):
                if not enabled:
                    continue
                imgs = sorted(glob.glob(osp.join(cam_dir, d, pattern)))
                if not imgs:
                    raise RuntimeError('empty tracklet dir: {}'.format(
                        osp.join(cam_dir, d)))
                tracklets.append(_tracklet(imgs, pid_map[d], camid))
        return tracklets


class ILIDSVID(_TwoCamSplitVideoDataset):
    """iLIDS-VID (reference: video/ilidsvid.py:14-143). 10 splits are
    derived once from train_test_splits_ilidsvid.mat ('ls_set',
    [10, 300] person indices; second half trains) and cached as
    splits.json."""
    dataset_dir = 'ilids-vid'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        data_dir = osp.join(self.dataset_dir, 'i-LIDS-VID')
        cam1 = osp.join(data_dir, 'sequences/cam1')
        cam2 = osp.join(data_dir, 'sequences/cam2')
        self.check_before_run([self.dataset_dir, data_dir])
        split_path = osp.join(self.dataset_dir, 'splits.json')
        if not osp.exists(split_path):
            self._prepare_split(split_path, cam1, cam2)
        splits = read_json(split_path)
        if split_id >= len(splits):
            raise ValueError('split_id must be in [0, {})'.format(
                len(splits)))
        self._build(splits[split_id], cam1, cam2, '*.png', **kwargs)

    def _prepare_split(self, split_path, cam1, cam2):
        from scipy.io import loadmat
        mat = loadmat(osp.join(
            self.dataset_dir, 'train-test people splits',
            'train_test_splits_ilidsvid.mat'))['ls_set']
        n_splits, n_ids = mat.shape
        half = n_ids // 2
        persons = sorted(osp.basename(p)
                         for p in glob.glob(osp.join(cam1, '*')))
        if set(persons) != set(osp.basename(p)
                               for p in glob.glob(osp.join(cam2, '*'))):
            raise RuntimeError('cam1/cam2 person sets differ')
        splits = []
        for i in range(n_splits):
            train_idx = sorted(int(j) - 1 for j in mat[i, half:])
            test_idx = sorted(int(j) - 1 for j in mat[i, :half])
            splits.append({'train': [persons[j] for j in train_idx],
                           'test': [persons[j] for j in test_idx]})
        write_json(splits, split_path)


class PRID2011Video(_TwoCamSplitVideoDataset):
    """PRID2011 multi-shot (reference: video/prid2011.py:10-80)."""
    dataset_dir = 'prid2011'

    def __init__(self, root='', split_id=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        cam1 = osp.join(self.dataset_dir, 'prid_2011/multi_shot/cam_a')
        cam2 = osp.join(self.dataset_dir, 'prid_2011/multi_shot/cam_b')
        self.check_before_run([self.dataset_dir, cam1, cam2])
        splits = read_json(osp.join(self.dataset_dir,
                                    'splits_prid2011.json'))
        if split_id >= len(splits):
            raise ValueError('split_id must be in [0, {})'.format(
                len(splits)))
        self._build(splits[split_id], cam1, cam2, '*.png', **kwargs)


class DukeMTMCVidReID(VideoDataset):
    """DukeMTMC-VideoReID (reference: video/dukemtmcvidreid.py:16-128).
    train/query/gallery trees of <pid>/<tracklet>/ frame jpgs; frames
    are ordered by their F#### index; parses both old (0001C6F0099*)
    and new (0001_C6_F0099*) naming; split jsons are cached."""
    dataset_dir = 'dukemtmc-vidreid'

    def __init__(self, root='', min_seq_len=0, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        base = osp.join(self.dataset_dir, 'DukeMTMC-VideoReID')
        self.min_seq_len = min_seq_len
        self.check_before_run([self.dataset_dir, osp.join(base, 'train'),
                               osp.join(base, 'query'),
                               osp.join(base, 'gallery')])
        train = self._parse(osp.join(base, 'train'),
                            osp.join(self.dataset_dir, 'split_train.json'),
                            relabel=True)
        query = self._parse(osp.join(base, 'query'),
                            osp.join(self.dataset_dir, 'split_query.json'),
                            relabel=False)
        gallery = self._parse(osp.join(base, 'gallery'),
                              osp.join(self.dataset_dir,
                                       'split_gallery.json'),
                              relabel=False)
        super().__init__(train, query, gallery, **kwargs)

    def _parse(self, dir_path, json_path, relabel):
        if osp.exists(json_path):
            return [_tracklet(t[0], t[1], t[2]) if isinstance(t, (list,
                    tuple)) else t for t in read_json(json_path)['tracklets']]
        pdirs = sorted(glob.glob(osp.join(dir_path, '*')))
        pid2label = {int(osp.basename(p)): i for i, p in enumerate(pdirs)}
        tracklets = []
        for pdir in pdirs:
            pid = int(osp.basename(pdir))
            if relabel:
                pid = pid2label[pid]
            for tdir in sorted(glob.glob(osp.join(pdir, '*'))):
                raw = glob.glob(osp.join(tdir, '*.jpg'))
                if len(raw) < self.min_seq_len:
                    continue
                paths = []
                for idx in range(len(raw)):
                    hits = glob.glob(osp.join(
                        tdir, '*F{:04d}*.jpg'.format(idx + 1)))
                    if not hits:
                        warnings.warn('missing frame F{:04d} in {}'.format(
                            idx + 1, tdir))
                        continue
                    paths.append(hits[0])
                name = osp.basename(paths[0])
                # old: 0001C6F0099X30823.jpg / new: 0001_C6_F0099_X30823.jpg
                camid = int(name[5]) - 1 if '_' not in name \
                    else int(name[6]) - 1
                tracklets.append(_tracklet(paths, pid, camid))
        write_json({'tracklets': [[list(t['img_paths']), t['pid'],
                                   t['camid']] for t in tracklets]},
                   json_path)
        return tracklets


register_video_dataset('mars', Mars)
register_video_dataset('ilidsvid', ILIDSVID)
register_video_dataset('prid2011', PRID2011Video)
register_video_dataset('dukemtmcvidreid', DukeMTMCVidReID)
