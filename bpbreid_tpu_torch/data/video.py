"""Video (tracklet) re-id data (port of bpbreid_tpu/data/video.py).

A tracklet sample is a dict ``{img_paths: (...), pid, camid}`` (the
synthetic set holds its frames in ``imgs``); ``get`` samples
``seq_len`` of its frames ('evenly', 'random' or 'all'), resizes each
with ``resize_linear`` (JAX: ``cv2.resize``, which it equals on uint8
frames) and stacks them to ``[S, H, W, 3]``. Train batches are so
``[B, S, H, W, 3]``, which the video engines flatten to ``[B*S, ...]``
(``engine/video/``). There are no masks on this path.

JAX's 'random' draws from an unseeded ``np.random.default_rng()``, so
no two runs agree; here each dataset draws from a generator seeded with
``seed`` (ROADMAP, "Divergences kept on purpose").
"""
import numpy as np

from bpbreid_tpu_torch.data.datamanager import DataManager
from bpbreid_tpu_torch.data.datasets.dataset import (Dataset, read_image,
                                                     resize_linear)
from bpbreid_tpu_torch.data.loader import BatchLoader
from bpbreid_tpu_torch.data.sampler import build_train_sampler

__all__ = ['VideoDataset', 'SyntheticVideoDataset', 'VideoDataManager',
           'init_video_dataset', 'register_video_dataset']


class VideoDataset(Dataset):
    """A tracklet dataset; ``seq_len`` frames a sample by
    ``sample_method``, drawn from ``seed`` for 'random'."""

    def __init__(self, train, query, gallery, seq_len=15,
                 sample_method='evenly', seed=0, **kwargs):
        self.seq_len = seq_len
        self.sample_method = sample_method
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        super().__init__(train, query, gallery, **kwargs)

    def _sample_indices(self, num_imgs, rng=None):
        """The frame indices of a tracklet of ``num_imgs`` frames
        (reference: dataset.py:398-436): 'random' ``seq_len`` sorted
        draws, with replacement only when the tracklet is shorter;
        'evenly' ``seq_len`` evenly spaced frames, the last frame repeated
        on a short tracklet; 'all' every frame."""
        if self.sample_method == 'random':
            rng = rng or self.rng
            replace = num_imgs < self.seq_len
            return np.sort(rng.choice(np.arange(num_imgs), size=self.seq_len,
                                      replace=replace))
        if self.sample_method == 'evenly':
            if num_imgs >= self.seq_len:
                num = num_imgs - num_imgs % self.seq_len
                return np.arange(0, num, num / self.seq_len).astype(np.int64)
            idx = np.arange(num_imgs)
            pads = np.full(self.seq_len - num_imgs, num_imgs - 1)
            return np.concatenate([idx, pads]).astype(np.int64)
        if self.sample_method == 'all':
            return np.arange(num_imgs)
        raise ValueError('Unknown sample method: {}'.format(
            self.sample_method))

    def get(self, mode, index, height=None, width=None, mask_grid=None):
        """The sample dict with ``image`` ``[S, H, W, 3]`` uint8 (the
        loader's ``mask_grid`` is for image datasets; there are no masks
        here)."""
        del mask_grid
        sample = dict(self.data(mode)[index])
        frames = []
        for i in self._sample_indices(len(sample['img_paths'])):
            if 'imgs' in sample:
                img = sample['imgs'][int(i)]
            else:
                img = read_image(sample['img_paths'][int(i)])
            if height is not None and img.shape[:2] != (height, width):
                img = resize_linear(img, height, width)
            frames.append(img)
        sample['image'] = np.stack(frames)
        return sample

    def __add__(self, other):
        """The train tracklets of both, ``other``'s identities after
        ``self``'s; query and gallery are ``self``'s. (JAX's sum of video
        datasets is an ``ImageDataset``, whose ``get`` cannot read a
        tracklet: ROADMAP, "The JAX package at fault".)"""
        train = [dict(s) for s in self.train]
        train += [dict(s, pid=s['pid'] + self.num_train_pids)
                  for s in other.train]
        return VideoDataset(train, self.query, self.gallery,
                            seq_len=self.seq_len,
                            sample_method=self.sample_method, seed=self.seed,
                            mode=self.mode, verbose=False)


class SyntheticVideoDataset(VideoDataset):
    """In-memory tracklets of seeded noise: ``num_pids`` identities x
    ``num_cams`` cameras, one tracklet of ``tracklet_len`` frames each,
    in each split (the JAX set's draws)."""

    def __init__(self, root='', num_pids=4, num_cams=2, tracklet_len=6,
                 height=32, width=16, seed=0, **kwargs):
        def split(seed_):
            r = np.random.default_rng(seed_)
            data = []
            for pid in range(num_pids):
                for camid in range(num_cams):
                    imgs = [r.integers(0, 255, (height, width, 3),
                                       dtype=np.uint8)
                            for _ in range(tracklet_len)]
                    data.append({'imgs': imgs,
                                 'img_paths': ['v://{}'.format(j)
                                               for j in range(tracklet_len)],
                                 'pid': pid, 'camid': camid})
            return data

        super().__init__(split(seed), split(seed + 1), split(seed + 2),
                         **kwargs)


_video_datasets = {
    'synthetic_video': SyntheticVideoDataset,
}


def register_video_dataset(name, cls):
    _video_datasets[name] = cls


def init_video_dataset(name, mode='train', **kwargs):
    # the parsers register themselves (a module-level import would be
    # circular: they subclass VideoDataset)
    import bpbreid_tpu_torch.data.datasets.video_datasets  # noqa: F401
    if name not in _video_datasets:
        raise ValueError('Invalid video dataset name. Received "{}", '
                         'available: {}'.format(name,
                                                sorted(_video_datasets)))
    ds = _video_datasets[name](mode=mode, **kwargs)
    ds.mode = mode
    return ds


class VideoDataManager(DataManager):
    """Video data manager; the arguments are ``config.videodata_kwargs``
    (reference: datamanager.py:374-572). The train loader yields
    ``[B, S, H, W, 3]`` batches of ``train_sampler``'s tracklets, a query
    and a gallery loader per target the same at ``batch_size_test``. No
    masks: ``mask_chain_kwargs`` is None."""

    data_type = 'video'

    def __init__(self, root='', sources=None, targets=None, height=256,
                 width=128, transforms='random_flip', norm_mean=None,
                 norm_std=None, split_id=0, combineall=False,
                 batch_size_train=3, batch_size_test=3, workers=4,
                 num_instances=4, train_sampler='RandomSampler', seq_len=15,
                 sample_method='evenly', config=None, seed=0, **kwargs):
        super().__init__(sources, targets, height, width, transforms,
                         norm_mean, norm_std)
        self.cfg = config
        self.use_masks = False

        common = dict(root=root, split_id=split_id, seq_len=seq_len,
                      sample_method=sample_method, seed=seed)
        trainset = sum(
            (init_video_dataset(name, mode='train', combineall=combineall,
                                **common) for name in self.sources), 0)
        self._num_train_pids = trainset.num_train_pids
        self._num_train_cams = trainset.num_train_cams
        self.train_set = trainset
        sampler = build_train_sampler(trainset.train, train_sampler,
                                      batch_size=batch_size_train,
                                      num_instances=num_instances, seed=seed)
        self.train_loader = BatchLoader(trainset, 'train', batch_size_train,
                                        height, width, sampler=sampler,
                                        num_workers=workers, drop_last=True)
        self.test_loader = {}
        self.test_dataset = {}
        for name in self.targets:
            sets = {mode: init_video_dataset(name, mode=mode,
                                             combineall=combineall, **common)
                    for mode in ('query', 'gallery')}
            self.test_dataset[name] = sets
            self.test_loader[name] = {
                mode: BatchLoader(ds, mode, batch_size_test, height, width,
                                  num_workers=workers)
                for mode, ds in sets.items()}

    def mask_chain_kwargs(self):
        return None
