"""Grids of the batch-hard triplets of a training batch (port of
bpbreid_tpu/utils/visualization/batch_triplets.py).

For the first ``max_triplets`` anchors of a batch, the anchor, its
hardest positive and its hardest negative with their distances. The
mining is JAX's, in numpy. Drawn without matplotlib: a ``rows x 3`` grid
of ``THUMB_HW`` thumbnails (``rankings._Figure``), each cell titled in a
``tEXt`` chunk ``r<row>c<col>`` (``anchor <pid>``, ``pos d=<x.xx>``,
``neg d=<x.xx>``).
"""
import os
import os.path as osp

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import resize_linear, write_png
from bpbreid_tpu_torch.utils.visualization.rankings import THUMB_HW, _Figure

__all__ = ['display_batch_triplets', 'mine_batch_hard']


def mine_batch_hard(embeddings, pids, max_triplets=8):
    """``(rows, dist)``: ``(anchor, hardest positive, hardest negative)``
    index triples of the first ``max_triplets`` anchors that have both a
    positive and a negative, and the ``[N, N]`` euclidean distances.
    ``embeddings`` is ``[N, D]`` or ``[N, K, D]`` (averaged over K)."""
    emb = np.asarray(embeddings, np.float32)
    if emb.ndim == 3:
        emb = emb.mean(axis=1)
    pids = np.asarray(pids)
    d2 = ((emb[:, None] - emb[None, :]) ** 2).sum(-1)
    dist = np.sqrt(np.maximum(d2, 0))
    same = pids[:, None] == pids[None, :]
    np.fill_diagonal(same, False)
    n = len(pids)
    rows = []
    for a in range(min(n, max_triplets)):
        if not same[a].any() or same[a].all():
            continue
        pos = np.where(same[a], dist[a], -np.inf).argmax()
        neg = np.where(~same[a] & (np.arange(n) != a), dist[a],
                       np.inf).argmin()
        rows.append((a, int(pos), int(neg)))
    return rows, dist


def display_batch_triplets(images, embeddings, pids, save_dir,
                           max_triplets=8, name='triplets'):
    """Mine batch-hard triplets on the host and save their grid as
    ``<save_dir>/<name>.png``; returns the path, or None when no anchor
    has both a positive and a negative.

    Args:
        images: ``[N, H, W, 3]`` uint8 batch.
        embeddings: ``[N, D]`` (or ``[N, K, D]``, averaged over K).
        pids: ``[N]`` ids.
    """
    pids = np.asarray(pids)
    rows, dist = mine_batch_hard(embeddings, pids, max_triplets)
    if not rows:
        return None
    fig = _Figure(len(rows), 3)
    for r, (a, p, ng) in enumerate(rows):
        for c, (idx, title) in enumerate(
                ((a, 'anchor {}'.format(pids[a])),
                 (p, 'pos d={:.2f}'.format(dist[a, p])),
                 (ng, 'neg d={:.2f}'.format(dist[a, ng])))):
            thumb = resize_linear(np.asarray(images[idx]).astype(np.uint8),
                                  *THUMB_HW)
            fig.cell(r, c, thumb, title=title)
    os.makedirs(save_dir, exist_ok=True)
    out = osp.join(save_dir, '{}.png'.format(name))
    write_png(out, fig.canvas, fig.text)
    return out
