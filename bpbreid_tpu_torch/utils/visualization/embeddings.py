"""Embedding-space projection of the query and gallery features (port of
bpbreid_tpu/utils/visualization/embeddings.py), the figure of
``test.vis_embedding_projection``.

``_project``: with ``method='auto'`` t-SNE when scikit-learn imports,
else PCA (numpy's SVD), as in JAX; it prints which one ran. The
subsampling draws from ``np.random.default_rng(seed)`` as JAX does, so
the points are JAX's. Drawn without matplotlib on a ``FIGURE_PX``
square canvas: gallery dots and query crosses coloured by ``pid % 20``
through matplotlib's ``tab20`` (each scatter scaled to its own min and
max, as ``scatter`` does), inside a black frame; the title and the
legend are ``tEXt`` chunks ``title`` and ``legend``.
"""
import os
import os.path as osp

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import write_png
from bpbreid_tpu_torch.utils.visualization.imaging import (TAB20, draw_marker,
                                                           fill_rect,
                                                           listed_colors)

__all__ = ['visualize_embeddings_projection', 'FIGURE_PX']

FIGURE_PX = 720
_MARGIN = 24


def _project(x, dim=2, method='auto'):
    if method in ('tsne', 'auto'):
        try:
            from sklearn.manifold import TSNE
        except ImportError:
            if method == 'tsne':
                raise
        else:
            print('Embedding projection: t-SNE (scikit-learn)')
            return TSNE(n_components=dim, init='pca',
                        perplexity=min(30, max(2, x.shape[0] // 4))
                        ).fit_transform(x)
    print('Embedding projection: PCA')
    x = x - x.mean(axis=0, keepdims=True)
    _u, _s, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:dim].T


def _to_pixels(points, lo, hi):
    """Canvas ``(y, x)`` of 2-D points, the box ``[lo, hi]`` filling the
    frame's inside (y grows upwards, as on matplotlib's axes)."""
    inner = FIGURE_PX - 2 * _MARGIN - 1
    span = np.where(hi > lo, hi - lo, 1.0)
    t = (points - lo) / span
    return (_MARGIN + (1 - t[:, 1]) * inner, _MARGIN + t[:, 0] * inner)


def visualize_embeddings_projection(qf, gf, q_pids, g_pids, save_dir,
                                    dataset_name='', max_points=500,
                                    method='auto', seed=0):
    """Scatter queries (crosses) and galleries (dots) coloured by identity
    into ``<save_dir>/embeddings_<dataset_name>.png``; returns the
    path."""
    qf = np.asarray(qf).reshape(len(q_pids), -1)
    gf = np.asarray(gf).reshape(len(g_pids), -1)
    rng = np.random.default_rng(seed)
    if len(g_pids) > max_points:
        sel = rng.choice(len(g_pids), max_points, replace=False)
        gf, g_pids = gf[sel], np.asarray(g_pids)[sel]
    if len(q_pids) > max_points:
        sel = rng.choice(len(q_pids), max_points, replace=False)
        qf, q_pids = qf[sel], np.asarray(q_pids)[sel]

    proj = np.asarray(_project(np.concatenate([qf, gf]), method=method),
                      np.float64)
    pq, pg = proj[:len(q_pids)], proj[len(q_pids):]
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    canvas = np.full((FIGURE_PX, FIGURE_PX, 3), 255, np.uint8)
    a, b = _MARGIN - 2, FIGURE_PX - _MARGIN + 1      # the frame, 1 px
    for y0, y1, x0, x1 in ((a, a + 1, a, b + 1), (b, b + 1, a, b + 1),
                           (a, b + 1, a, a + 1), (a, b + 1, b, b + 1)):
        fill_rect(canvas, y0, y1, x0, x1, 'black')
    for pts, pids, kind, radius, alpha in (
            (pg, g_pids, 'o', 2, 0.6), (pq, q_pids, 'x', 4, 1.0)):
        if not len(pts):
            continue
        colors = listed_colors(np.asarray(pids) % 20, TAB20)
        ys, xs = _to_pixels(pts, lo, hi)
        for y, x, rgb in zip(ys, xs, colors):
            draw_marker(canvas, y, x, rgb, kind, radius, alpha)
    os.makedirs(save_dir, exist_ok=True)
    out = osp.join(save_dir, 'embeddings_{}.png'.format(dataset_name))
    write_png(out, canvas, {
        'title': '{} embedding projection'.format(dataset_name),
        'legend': 'o gallery ({}) | x query ({})'.format(len(pg), len(pq))})
    return out
