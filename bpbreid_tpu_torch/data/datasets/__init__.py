"""Dataset registry (port of bpbreid_tpu/data/datasets/__init__.py).

One parser run is shared by the train, query and gallery modes through
shallow copies with a mode override (``init_image_dataset``). Only the
ported parsers are registered; the small datasets (``viper``, ``cuhk03``,
...) and the video datasets raise, naming ROADMAP Queue 1 item 9.
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

__all__ = ['Dataset', 'ImageDataset', 'get_image_dataset',
           'init_image_dataset', 'register_image_dataset',
           'clear_dataset_cache']

_image_datasets = {
    'market1501': Market1501,
    'dukemtmcreid': DukeMTMCreID,
    'occluded_duke': OccludedDuke,
    'occluded_reid': OccludedReID,
    'p_dukemtmc_reid': PDukemtmcReid,
    'msmt17': MSMT17,
    'synthetic': SyntheticDataset,
    'synthetic_hard': SyntheticHardDataset,
}

# registered in the JAX package, not ported yet
_NOT_PORTED = ('viper', 'ilids', 'cuhk01', 'cuhk02', 'cuhk03', 'prid', 'grid',
               'sensereid', 'partial_reid', 'partial_ilids', 'p_ETHZ',
               'mars', 'ilidsvid', 'prid2011', 'dukemtmcvidreid')

_dataset_cache = {}


def get_image_dataset(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            "dataset '{}' is not ported yet (ROADMAP Queue 1 item 9: the "
            "small and video datasets)".format(name))
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


def register_image_dataset(name, dataset_cls):
    """Register a new dataset class under ``name``."""
    if name in _image_datasets:
        raise ValueError('dataset {} already registered'.format(name))
    _image_datasets[name] = dataset_cls


def clear_dataset_cache():
    _dataset_cache.clear()
