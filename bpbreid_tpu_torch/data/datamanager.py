"""Data manager (port of bpbreid_tpu/data/datamanager.py).

Resolves the source and target datasets, builds the train loader with
its sampler (P x K by default) and a query and a gallery loader per
target, and exposes ``num_train_pids`` and the settings the engine needs
(transforms, normalization, the mask chain). Loaders yield numpy
batches; augmentation and the mask chain run on the device
(``data/augment.py``), except the ``ro`` random occlusion, which runs on
the host in the train loader (``data/data_augmentation``). With
``load_train_targets`` a train loader of the targets is built too
(``train_loader_t``), as in JAX, where no engine reads it.
"""
from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
from bpbreid_tpu_torch.data.data_augmentation import RandomOcclusion
from bpbreid_tpu_torch.data.datasets import get_image_dataset, init_image_dataset
from bpbreid_tpu_torch.data.loader import BatchLoader
from bpbreid_tpu_torch.data.sampler import build_train_sampler

__all__ = ['DataManager', 'ImageDataManager']


class DataManager:
    """What the image and video managers share (JAX ``DataManager``): the
    source and target names, the crop size, the transforms and the
    normalization the engines read, and the train identities and
    cameras their subclass counts."""

    def __init__(self, sources=None, targets=None, height=256, width=128,
                 transforms='random_flip', norm_mean=None, norm_std=None):
        self.sources = [sources] if isinstance(sources, str) else sources
        if self.sources is None:
            raise ValueError('sources must not be None')
        self.targets = [targets] if isinstance(targets, str) else targets
        if self.targets is None:
            self.targets = self.sources
        self.height = height
        self.width = width
        self.transforms = [transforms] if isinstance(transforms, str) \
            else list(transforms or [])
        self.norm_mean = norm_mean or [0.485, 0.456, 0.406]
        self.norm_std = norm_std or [0.229, 0.224, 0.225]
        self._num_train_pids = self._num_train_cams = None

    @property
    def num_train_pids(self):
        return self._num_train_pids

    @property
    def num_train_cams(self):
        return self._num_train_cams

    def fetch_test_loaders(self, name):
        """The query and gallery datasets of target ``name`` (JAX
        :48)."""
        q = self.test_dataset[name]['query']
        g = self.test_dataset[name]['gallery']
        return q, g


class ImageDataManager(DataManager):
    """Image data manager; the arguments are ``config.imagedata_kwargs``.

    ``split_id`` and ``cuhk03_*`` go to the parsers that read them (the
    split-based small datasets, CUHK03). The ``ro`` transform (or
    ``random_occlusion``) takes its settings from ``config.data.ro`` and
    draws from ``seed``.
    """

    data_type = 'image'

    def __init__(self, config=None, root='', sources=None, targets=None,
                 height=256, width=128, transforms='random_flip',
                 norm_mean=None, norm_std=None, split_id=0,
                 combineall=False, load_train_targets=False,
                 batch_size_train=32, batch_size_test=32, workers=4,
                 num_instances=4, train_sampler='RandomIdentitySampler',
                 train_sampler_t='RandomIdentitySampler',
                 cuhk03_labeled=False, cuhk03_classic_split=False,
                 market1501_500k=False, use_masks=False, masks_dir=None,
                 seed=0, **kwargs):
        super().__init__(sources, targets, height, width, transforms,
                         norm_mean, norm_std)
        self.cfg = config
        self.use_masks = use_masks
        self.masks_dir = masks_dir

        common = dict(config=config, root=root, split_id=split_id,
                      cuhk03_labeled=cuhk03_labeled,
                      cuhk03_classic_split=cuhk03_classic_split,
                      market1501_500k=market1501_500k, use_masks=use_masks,
                      masks_dir=masks_dir)

        print('=> Loading train (source) dataset')
        trainset = sum(
            (init_image_dataset(name, mode='train', combineall=combineall,
                                **common) for name in self.sources), 0)
        self._num_train_pids = trainset.num_train_pids
        self._num_train_cams = trainset.num_train_cams
        sampler = build_train_sampler(
            trainset.train, train_sampler, batch_size=batch_size_train,
            num_instances=num_instances, seed=seed)
        # the random occlusion runs on the host (patch shapes vary per
        # draw); every other transform on the device
        host_transform = None
        lowered = [t.lower() for t in self.transforms]
        if ('ro' in lowered or 'random_occlusion' in lowered) \
                and config is not None:
            ro = config.data.ro
            host_transform = RandomOcclusion(
                path=ro.path, p=ro.p, n=ro.n, min_overlap=ro.min_overlap,
                max_overlap=ro.max_overlap, seed=seed)
        self.train_loader = BatchLoader(
            trainset, 'train', batch_size_train, height, width,
            sampler=sampler, num_workers=workers, drop_last=True,
            host_transform=host_transform)

        self.train_loader_t = None
        if load_train_targets:
            if set(self.sources) & set(self.targets):
                raise ValueError('sources={} and targets={} must not overlap'
                                 .format(self.sources, self.targets))
            print('=> Loading train (target) dataset')
            trainset_t = sum(
                (init_image_dataset(name, mode='train', combineall=False,
                                    **common) for name in self.targets), 0)
            sampler_t = build_train_sampler(
                trainset_t.train, train_sampler_t,
                batch_size=batch_size_train, num_instances=num_instances,
                seed=seed)
            self.train_loader_t = BatchLoader(
                trainset_t, 'train', batch_size_train, height, width,
                sampler=sampler_t, num_workers=workers, drop_last=True)

        print('=> Loading test (target) datasets')
        self.test_loader = {}
        self.test_dataset = {}
        for name in self.targets:
            sets = {mode: init_image_dataset(name, mode=mode,
                                             combineall=combineall, **common)
                    for mode in ('query', 'gallery')}
            self.test_dataset[name] = sets
            self.test_loader[name] = {
                mode: BatchLoader(ds, mode, batch_size_test, height, width,
                                  num_workers=workers)
                for mode, ds in sets.items()}

        print('\n  **************** Summary ****************')
        print('  source            : {}'.format(self.sources))
        print('  # source datasets : {}'.format(len(self.sources)))
        print('  # source ids      : {}'.format(self._num_train_pids))
        print('  # source images   : {}'.format(len(trainset.train)))
        print('  # source cameras  : {}'.format(self._num_train_cams))
        print('  target            : {}'.format(self.targets))
        print('  *****************************************\n')

    def mask_chain_kwargs(self):
        """The device mask chain's parameters from the config, or None
        without masks (``data.augment.mask_chain_kwargs``; the first
        source's ``masks_dirs`` entry says whether its files carry their
        own background channel)."""
        if not self.use_masks or self.cfg is None:
            return None
        ds_cfg = get_image_dataset(self.sources[0]).get_masks_config(
            self.masks_dir)
        return mask_chain_kwargs(self.cfg, has_background=bool(
            ds_cfg is not None and ds_cfg[1]))
