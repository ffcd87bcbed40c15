"""Per-channel dataset statistics (port of
bpbreid_tpu/tools/compute_mean_std.py; the reference's
torchreid/tools/compute_mean_std.py)."""
import numpy as np

__all__ = ['compute_mean_std']


def compute_mean_std(dataset, mode='train', height=None, width=None,
                     max_samples=None):
    """Streaming float64 mean and std of the RGB values in [0, 1] over
    the images of a dataset split (the first ``max_samples`` of them
    when given), each decoded and resized by ``dataset.get``."""
    n_pix = 0
    s = np.zeros(3, np.float64)
    s2 = np.zeros(3, np.float64)
    total = dataset.len(mode)
    if max_samples:
        total = min(total, max_samples)
    for i in range(total):
        img = dataset.get(mode, i, height, width)['image'].astype(np.float64)
        img = img / 255.0
        flat = img.reshape(-1, 3)
        n_pix += flat.shape[0]
        s += flat.sum(axis=0)
        s2 += (flat ** 2).sum(axis=0)
    mean = s / n_pix
    std = np.sqrt(s2 / n_pix - mean ** 2)
    print('mean = {}, std = {}'.format(mean.tolist(), std.tolist()))
    return mean, std
