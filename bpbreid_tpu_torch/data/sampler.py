"""Batch samplers (port of bpbreid_tpu/data/sampler.py).

Plain index generators: the P x K ``RandomIdentitySampler`` makes each
batch hold ``num_instances`` images of ``batch_size // num_instances``
identities, the structure batch-hard triplet mining needs. The draws
come from stdlib ``random.Random(seed)`` and numpy's generator, as in the
JAX package, so the index order is the same; a sampler's generator
carries on across epochs.
"""
import copy
import random
from collections import defaultdict

import numpy as np

__all__ = ['RandomIdentitySampler', 'RandomSampler', 'SequentialSampler',
           'build_train_sampler']


class RandomIdentitySampler:
    """P x K sampler."""

    def __init__(self, data_source, batch_size, num_instances, seed=0):
        if batch_size < num_instances:
            raise ValueError('batch_size={} must be >= num_instances={}'
                             .format(batch_size, num_instances))
        self.data_source = data_source
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.index_dic = defaultdict(list)
        for index, sample in enumerate(data_source):
            self.index_dic[sample['pid']].append(index)
        self.pids = list(self.index_dic.keys())
        if len(self.pids) < self.num_pids_per_batch:
            raise ValueError('dataset has {} pids but {} are required per '
                             'batch'.format(len(self.pids),
                                            self.num_pids_per_batch))
        self._rng = random.Random(seed)
        # the epoch length: every pid in whole groups of num_instances
        self.length = 0
        for pid in self.pids:
            num = len(self.index_dic[pid])
            num = max(num, self.num_instances)
            self.length += num - num % self.num_instances

    def __iter__(self):
        rng = self._rng
        batch_idxs_dict = defaultdict(list)
        for pid in self.pids:
            idxs = copy.copy(self.index_dic[pid])
            if len(idxs) < self.num_instances:
                idxs = [rng.choice(idxs)
                        for _ in range(self.num_instances)]
            rng.shuffle(idxs)
            batch_idxs = []
            for idx in idxs:
                batch_idxs.append(idx)
                if len(batch_idxs) == self.num_instances:
                    batch_idxs_dict[pid].append(batch_idxs)
                    batch_idxs = []
        avai_pids = copy.deepcopy(self.pids)
        final_idxs = []
        while len(avai_pids) >= self.num_pids_per_batch:
            selected = rng.sample(avai_pids, self.num_pids_per_batch)
            for pid in selected:
                final_idxs.extend(batch_idxs_dict[pid].pop(0))
                if not batch_idxs_dict[pid]:
                    avai_pids.remove(pid)
        return iter(final_idxs)

    def __len__(self):
        return self.length


class RandomSampler:
    def __init__(self, data_source, seed=0, **kwargs):
        self.n = len(data_source)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self._rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class SequentialSampler:
    def __init__(self, data_source, **kwargs):
        self.n = len(data_source)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


def build_train_sampler(data_source, train_sampler, batch_size=32,
                        num_instances=4, seed=0, **kwargs):
    """The train sampler named ``train_sampler``."""
    if train_sampler == 'RandomIdentitySampler':
        return RandomIdentitySampler(data_source, batch_size, num_instances,
                                     seed=seed)
    elif train_sampler == 'SequentialSampler':
        return SequentialSampler(data_source)
    elif train_sampler == 'RandomSampler':
        return RandomSampler(data_source, seed=seed)
    raise ValueError('Unknown sampler: {}'.format(train_sampler))
