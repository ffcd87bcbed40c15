"""Spatial feature-map figures of a training batch (port of
bpbreid_tpu/utils/visualization/feature_maps.py): the PCA of each
sample's feature map as RGB beside the argmax of its part masks, the
debug dump of ``train.batch_debug_freq``.

The PCA is numpy's SVD on the host, as in JAX (a card's SVD may choose
other singular-vector signs, which would change the colours). Drawn
without matplotlib: one ``featuremap_<i>.png`` per sample, two panels
``GRID_SPACING`` pixels apart on a white canvas, each upscaled by the
nearest pixel to at least ``PANEL_MIN_HEIGHT`` rows; the parts panel
colours the argmax through matplotlib's ``tab10`` as ``imshow`` does.
The panel titles are ``tEXt`` chunks ``r0c0`` and ``r0c1`` (the strings
of the JAX version).
"""
import os
import os.path as osp

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import write_png
from bpbreid_tpu_torch.utils.visualization.imaging import TAB10, listed_colors
from bpbreid_tpu_torch.utils.visualization.rankings import GRID_SPACING

__all__ = ['featuremap_to_heatmap', 'display_feature_maps',
           'PANEL_MIN_HEIGHT']

PANEL_MIN_HEIGHT = 128


def featuremap_to_heatmap(feature_map):
    """[H, W, D] -> [H, W, 3] PCA projection to RGB in [0, 1]."""
    h, w, d = feature_map.shape
    x = np.asarray(feature_map, np.float32).reshape(-1, d)
    x = x - x.mean(axis=0, keepdims=True)
    _u, _s, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:3].T
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    proj = (proj - lo) / np.maximum(hi - lo, 1e-6)
    return proj.reshape(h, w, 3)


def _upscale(panel):
    f = max(1, -(-PANEL_MIN_HEIGHT // panel.shape[0]))
    return np.repeat(np.repeat(panel, f, axis=0), f, axis=1)


def display_feature_maps(embeddings_dict, spatial_features, parts_masks,
                         img_paths, pids, save_dir=None, max_samples=4):
    """Save the feature-map and part-argmax panels of the first
    ``max_samples`` samples; returns the paths (none without
    ``save_dir``).

    Args:
        embeddings_dict: unused (the JAX signature).
        spatial_features: ``[N, H, W, D]`` feature maps.
        parts_masks: ``[N, H, W, K]`` part masks.
        img_paths: unused (the JAX signature).
        pids: ``[N]`` ids.
    """
    del embeddings_dict, img_paths
    if save_dir is None:
        return []
    spatial_features = np.asarray(spatial_features)
    parts_masks = np.asarray(parts_masks)
    n = min(max_samples, spatial_features.shape[0])
    os.makedirs(save_dir, exist_ok=True)
    outs = []
    for i in range(n):
        heat = np.round(featuremap_to_heatmap(spatial_features[i]) * 255) \
            .astype(np.uint8)
        parts = listed_colors(np.argmax(parts_masks[i], axis=-1), TAB10)
        left, right = _upscale(heat), _upscale(parts)
        h = max(left.shape[0], right.shape[0])
        canvas = np.full((h, left.shape[1] + GRID_SPACING + right.shape[1],
                          3), 255, np.uint8)
        canvas[:left.shape[0], :left.shape[1]] = left
        canvas[:right.shape[0], left.shape[1] + GRID_SPACING:] = right
        out = osp.join(save_dir, 'featuremap_{}.png'.format(i))
        write_png(out, canvas, {
            'r0c0': 'features (pid {})'.format(int(np.asarray(pids)[i])),
            'r0c1': 'parts argmax'})
        outs.append(out)
    return outs
