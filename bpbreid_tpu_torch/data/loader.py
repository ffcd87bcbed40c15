"""Host-side batching loader (port of bpbreid_tpu/data/loader.py).

A thread pool decodes and resizes samples to fixed-size numpy arrays,
a bounded number of batches ahead; batches are assembled contiguously
and stay numpy (the engine copies them to the device, ``engine/engine.py
device_prefetch``, and augments them there, ``data/augment.py``).
Evaluation batches are padded to the batch size, with ``valid`` False on
the padding rows, so every eval step sees one shape.

A ``host_transform`` (the ``ro`` random occlusion, whose patch shapes
vary per draw) runs on the host on each image of a train batch. JAX
calls it on each sample in the worker threads, which share its
generator, so with more than one worker its draws follow the threads'
order. Here one more thread applies it to the assembled batches in
batch order and to their images in sample order: the draws are those of
JAX's loader with one worker, whatever ``num_workers`` is, and a run
repeats.
"""
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ['BatchLoader', 'MASK_GRID_SCALE']

# confidence fields ship at 1/8 of the image grid: they are stored near
# that resolution, and the device pipeline upsamples them
MASK_GRID_SCALE = 8


class BatchLoader:
    """Iterable over numpy batches of a dataset split.

    Yields dicts with keys: ``image`` [B,H,W,3] u8, ``pid``/``camid`` [B]
    i32, ``valid`` [B] bool, ``index`` [B] i32 (the sample's index in its
    split), and ``mask`` [B,h,w,C] f32 (``h, w`` the image grid over
    ``MASK_GRID_SCALE``) when the dataset carries masks. A short last
    batch is dropped (``drop_last``) or padded with copies of its last
    sample, ``valid`` False on them. ``host_transform`` maps one
    ``[H, W, 3]`` uint8 image to another (see the module docstring).
    """

    def __init__(self, dataset, mode, batch_size, height, width,
                 sampler=None, num_workers=4, drop_last=False,
                 host_transform=None):
        self.dataset = dataset
        self.mode = mode
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.mask_grid = (max(1, height // MASK_GRID_SCALE),
                          max(1, width // MASK_GRID_SCALE))
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.host_transform = host_transform

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None \
            else self.dataset.len(self.mode)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        return list(range(self.dataset.len(self.mode)))

    def _fetch(self, idx):
        return self.dataset.get(self.mode, idx, self.height, self.width,
                                mask_grid=self.mask_grid)

    def _assemble(self, samples, n_valid):
        b = len(samples)
        batch = {
            'image': np.stack([s['image'] for s in samples]),
            'pid': np.asarray([s['pid'] for s in samples], np.int32),
            'camid': np.asarray([s['camid'] for s in samples], np.int32),
            'valid': np.arange(b) < n_valid,
            'index': np.asarray([s.get('_index', -1) for s in samples],
                                np.int32),
        }
        if 'mask' in samples[0]:
            batch['mask'] = np.stack([s['mask'] for s in samples])
        return batch

    def __iter__(self):
        indices = self._indices()
        batches = []
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            n_valid = len(chunk)
            if n_valid < self.batch_size:
                if self.drop_last:
                    continue
                chunk = chunk + [chunk[-1]] * (self.batch_size - n_valid)
            batches.append((chunk, n_valid))

        def load_batch(args):
            chunk, n_valid = args
            samples = []
            for idx in chunk:
                s = self._fetch(idx)
                s['_index'] = idx
                samples.append(s)
            return self._assemble(samples, n_valid)

        def transformed(future):
            batch = future.result()
            batch['image'] = np.stack([self.host_transform(img)
                                       for img in batch['image']])
            return batch

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool, \
                ThreadPoolExecutor(max_workers=1) as ordered:

            def submit(args):
                future = pool.submit(load_batch, args)
                if self.host_transform is None:
                    return future
                # one thread, fed in batch order: the transform's draws
                # follow the samples' order
                return ordered.submit(transformed, future)

            # bounded prefetch of 2*workers batches
            it = iter(batches)
            futures = [submit(b)
                       for b in itertools.islice(it, 2 * self.num_workers)]
            while futures:
                fut = futures.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(submit(nxt))
                yield fut.result()
