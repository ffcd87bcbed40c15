"""Dataset registry (port of bpbreid_tpu/data/datasets/__init__.py).

One parser run is shared by the train, query and gallery modes through
shallow copies with a mode override (``init_image_dataset``). Every
image dataset of the JAX package is registered, under the same name and
nickname; the video datasets have their own registry
(``data/video.py``).
"""
import copy

from bpbreid_tpu_torch.data.datasets.dataset import Dataset, ImageDataset
from bpbreid_tpu_torch.data.datasets.image_datasets import (
    MSMT17,
    DukeMTMCreID,
    Market1501,
    OccludedDuke,
    OccludedReID,
    PDukemtmcReid,
    SyntheticDataset,
    SyntheticHardDataset,
)
from bpbreid_tpu_torch.data.datasets.small_datasets import (
    CUHK01,
    CUHK02,
    CUHK03,
    GRID,
    PETHZ,
    PRID,
    PartialiLIDS,
    PartialREID,
    SenseReID,
    VIPeR,
    iLIDS,
)

__all__ = ['Dataset', 'ImageDataset', 'get_image_dataset',
           'get_dataset_nickname', 'init_image_dataset',
           'register_image_dataset', 'clear_dataset_cache']

_image_datasets = {
    'market1501': Market1501,
    'dukemtmcreid': DukeMTMCreID,
    'occluded_duke': OccludedDuke,
    'occluded_reid': OccludedReID,
    'p_dukemtmc_reid': PDukemtmcReid,
    'msmt17': MSMT17,
    'synthetic': SyntheticDataset,
    'synthetic_hard': SyntheticHardDataset,
    'viper': VIPeR,
    'ilids': iLIDS,
    'cuhk01': CUHK01,
    'cuhk02': CUHK02,
    'cuhk03': CUHK03,
    'prid': PRID,
    'grid': GRID,
    'sensereid': SenseReID,
    'partial_reid': PartialREID,
    'partial_ilids': PartialiLIDS,
    'p_ETHZ': PETHZ,
}

_datasets_nicknames = {
    'market1501': 'mk', 'dukemtmcreid': 'du', 'occluded_duke': 'od',
    'occluded_reid': 'or', 'p_dukemtmc_reid': 'pd', 'msmt17': 'ms',
    'synthetic': 'sy', 'synthetic_hard': 'sh', 'viper': 'vi', 'ilids': 'il',
    'cuhk01': 'c1', 'cuhk02': 'c2', 'cuhk03': 'c3', 'prid': 'pr',
    'grid': 'gr', 'sensereid': 'se', 'partial_reid': 'pa',
    'partial_ilids': 'pi', 'p_ETHZ': 'pe',
}

_dataset_cache = {}


def get_dataset_nickname(name):
    return _datasets_nicknames.get(name, name)


def get_image_dataset(name):
    if name not in _image_datasets:
        raise ValueError('Invalid dataset name. Received "{}", available: {}'
                         .format(name, sorted(_image_datasets)))
    return _image_datasets[name]


def init_image_dataset(name, mode='train', **kwargs):
    """Build (or fetch from the cache) a dataset and return a shallow copy
    bound to ``mode``."""
    cls = get_image_dataset(name)
    cache_key = (name, tuple(sorted(
        (k, str(v)) for k, v in kwargs.items() if k != 'mode')))
    if cache_key not in _dataset_cache:
        _dataset_cache[cache_key] = cls(mode=mode, **kwargs)
    ds = copy.copy(_dataset_cache[cache_key])
    ds.mode = mode
    return ds


def register_image_dataset(name, dataset_cls, nickname=None):
    """Register a new dataset class under ``name``."""
    if name in _image_datasets:
        raise ValueError('dataset {} already registered'.format(name))
    _image_datasets[name] = dataset_cls
    _datasets_nicknames[name] = nickname or name


def clear_dataset_cache():
    _dataset_cache.clear()
