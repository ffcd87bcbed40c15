"""Keypoints -> gaussian heatmaps (port of bpbreid_tpu/utils/imagetools.py;
the reference's torchreid/utils/imagetools.py:5-69), in numpy."""
import numpy as np

__all__ = ['gaussian_heatmaps', 'build_gaussian_heatmaps']


def gaussian_heatmaps(keypoints, height, width, sigma=2.0):
    """[K, 3] (x, y, conf) keypoints -> [height, width, K] heatmaps; a
    keypoint of confidence <= 0 leaves its map at 0."""
    keypoints = np.asarray(keypoints, np.float32)
    k = keypoints.shape[0]
    yy = np.arange(height)[:, None]
    xx = np.arange(width)[None, :]
    maps = np.zeros((height, width, k), np.float32)
    for i, (x, y, conf) in enumerate(keypoints):
        if conf <= 0:
            continue
        g = np.exp(-(((yy - y) ** 2 + (xx - x) ** 2) / (2.0 * sigma ** 2)))
        maps[..., i] = g * conf
    return maps


def build_gaussian_heatmaps(keypoints_batch, height, width, sigma=2.0):
    """``gaussian_heatmaps`` of each sample, stacked: [N, height, width, K]."""
    return np.stack([gaussian_heatmaps(kp, height, width, sigma)
                     for kp in keypoints_batch])
