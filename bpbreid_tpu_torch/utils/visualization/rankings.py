"""Query-gallery ranking grids (port of
bpbreid_tpu/utils/visualization/rankings.py), drawn without matplotlib
or OpenCV.

For each selected query, a ``(topk+1) x (P+1)`` grid: rows are [query |
ranked gallery matches], columns are [image | one column per test
embedding stream]. Column 0 has the blue query border, the green/red
match border and the "visibility % | distance" title of each gallery
row; each stream column overlays that stream's attention map on the
thumbnail as a jet heatmap, with a border coloured by the stream's
visibility (matplotlib's ``hsv`` at ``v / 3``, red to green) and the
title "visibility % | part distance" (bold for the row's min and max
part). The suptitle holds the query, mAP and rank-1 and one summary per
stream (visible count, min/mean/max distance). Without the per-part
inputs (``bp_distmat``), the legacy layout: one row of ``topk+1`` cells
with the parts masks overlaid in ``tab10`` colours.

Divergence kept on purpose: the card's machine has no font renderer, so
no glyph is drawn. The figure is a numpy canvas of thumbnail cells
(128x64, a 3-pixel border in the edge colour, none where matplotlib
draws no spines), ``GRID_SPACING`` pixels apart, written by
``data/datasets/dataset.py write_png``. Each title is a PNG ``tEXt``
chunk, keyword ``r<row>c<col>``; the suptitle's keyword is
``suptitle`` (it is also printed), and ``bold`` lists the cells whose
title is bold. The strings are the JAX version's. Output: one
``ranking_<dataset>_q<idx>.png`` per query under ``save_dir``.
"""
import os
import os.path as osp

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import (read_image,
                                                     resize_linear, write_png)
from bpbreid_tpu_torch.utils.visualization.imaging import (
    JET, TAB10, hsv_colormap, resize_cubic, resize_nearest, to_uint8_rgb)

__all__ = ['visualize_ranking_grid', 'GRID_SPACING', 'THUMB_HW', 'BORDER']

GRID_SPACING = 2
THUMB_HW = (128, 64)
BORDER = 3
_WHITE = 255


def _load_thumb(sample, height=THUMB_HW[0], width=THUMB_HW[1]):
    img = sample['img'] if 'img' in sample else read_image(sample['img_path'])
    return resize_linear(img, height, width)


def _overlay_masks(img, parts_masks, alpha=0.4):
    """Colour-code part masks over the thumbnail (tab10)."""
    if parts_masks is None:
        return img
    k = parts_masks.shape[-1]
    labels = np.argmax(parts_masks, axis=-1)        # [h, w]
    strength = np.max(parts_masks, axis=-1)
    colors = np.asarray([TAB10[i % 10] for i in range(k)]) * 255
    overlay = colors[labels].astype(np.uint8)
    h, w = img.shape[:2]
    overlay = resize_nearest(overlay, h, w)
    strength = resize_linear(strength.astype(np.float32)[..., None], h,
                             w)[..., 0][..., None]
    out = img.astype(np.float32) * (1 - alpha * strength) \
        + overlay.astype(np.float32) * (alpha * strength)
    return out.astype(np.uint8)


def _overlay_heatmap(img, mask, alpha=0.55):
    """Overlay one spatial attention map as a jet heatmap (cubic
    upsampling, as the reference's mask overlay)."""
    m = np.asarray(mask, np.float32)
    m = m / max(float(m.max()), 1e-6)
    m = resize_cubic(m, img.shape[0], img.shape[1])
    m = np.clip(m, 0.0, 1.0)
    heat = JET[(m * 255).astype(np.uint8)]
    out = img.astype(np.float32) * (1 - alpha * m[..., None]) \
        + heat.astype(np.float32) * (alpha * m[..., None])
    return out.astype(np.uint8)


def _vis_border_color(v):
    """Red -> green ramp of a visibility score in [0, 1]: matplotlib's
    ``hsv`` colormap at ``v / 3``."""
    return hsv_colormap(float(np.clip(v, 0, 1)) / 3.0)


def _select_queries(q_idx_list, count, num_q, seed):
    rng = np.random.default_rng(seed)
    q_idx_list = [q for q in list(q_idx_list or []) if q < num_q]
    while len(q_idx_list) < min(count, num_q):
        cand = int(rng.integers(0, num_q))
        if cand not in q_idx_list:
            q_idx_list.append(cand)
    return q_idx_list


def _topk_valid(indices_row, q, gallery_samples, distrow, topk):
    """Ranked gallery indices with the junk filter (same pid+camid) and
    invalid (negative-distance) entries removed."""
    out = []
    for g_idx in indices_row:
        g = gallery_samples[g_idx]
        if g['pid'] == q['pid'] and g['camid'] == q['camid']:
            continue
        if distrow[g_idx] < 0:
            continue
        out.append(int(g_idx))
        if len(out) >= topk:
            break
    return out


class _Figure:
    """A ``rows x cols`` grid of thumbnail cells and their titles."""

    def __init__(self, rows, cols):
        ch, cw = THUMB_HW[0] + 2 * BORDER, THUMB_HW[1] + 2 * BORDER
        self.pitch = (ch + GRID_SPACING, cw + GRID_SPACING)
        self.canvas = np.full((rows * ch + (rows - 1) * GRID_SPACING,
                               cols * cw + (cols - 1) * GRID_SPACING, 3),
                              _WHITE, np.uint8)
        self.text, self.bold = {}, []

    def cell(self, r, c, img=None, border=None, title=None, bold=False):
        """Draw ``img`` (``THUMB_HW``, RGB uint8) in cell (r, c) inside a
        ``BORDER``-pixel frame of colour ``border`` (None: no frame)."""
        y, x = r * self.pitch[0], c * self.pitch[1]
        h, w = THUMB_HW
        if border is not None:
            self.canvas[y:y + h + 2 * BORDER, x:x + w + 2 * BORDER] = \
                to_uint8_rgb(border)
        self.canvas[y + BORDER:y + BORDER + h, x + BORDER:x + BORDER + w] = \
            _WHITE if img is None else img
        if title:
            self.text['r{}c{}'.format(r, c)] = title
            if bold:
                self.bold.append('r{}c{}'.format(r, c))

    def save(self, path, suptitle):
        print(suptitle)
        text = dict(self.text, suptitle=suptitle)
        if self.bold:
            text['bold'] = ' '.join(self.bold)
        write_png(path, self.canvas, text)
        return path


def visualize_ranking_grid(distmat, query_samples, gallery_samples,
                           save_dir, topk=10, q_idx_list=None, count=10,
                           q_parts_masks=None, g_parts_masks=None,
                           mAP=None, rank1=None, dataset_name='',
                           seed=0, bp_distmat=None, q_vis=None, g_vis=None,
                           masks_fn=None):
    """Save one ranking-grid png per selected query; returns the paths.

    Args:
        distmat: [Q, G] numpy distances.
        query_samples / gallery_samples: lists of sample dicts (``img``
            or ``img_path``, ``pid``, ``camid``).
        q_idx_list: explicit query indices; filled with random picks up
            to ``count``.
        bp_distmat: optional [P, Q, G] per-stream distances: the per-part
            layout.
        q_vis / g_vis: optional [Q, P] / [G, P] stream visibility scores.
        masks_fn: optional callable ``(sample_indices, kind)``, kind in
            {'query', 'gallery'}, returning [M, Hf, Wf, P] attention
            maps of the selected samples.
    """
    num_q = distmat.shape[0]
    q_idx_list = _select_queries(q_idx_list, count, num_q, seed)
    os.makedirs(save_dir, exist_ok=True)
    indices = np.argsort(distmat, axis=1)

    if bp_distmat is None:
        return _legacy_grid(distmat, indices, query_samples, gallery_samples,
                            save_dir, topk, q_idx_list, q_parts_masks,
                            g_parts_masks, mAP, rank1, dataset_name)

    bp_distmat = np.asarray(bp_distmat)
    P = bp_distmat.shape[0]
    if q_vis is None:
        q_vis = np.ones((num_q, P), np.float32)
    if g_vis is None:
        g_vis = np.ones((len(gallery_samples), P), np.float32)

    paths = []
    for q_idx in q_idx_list:
        q = query_samples[q_idx]
        g_idxs = _topk_valid(indices[q_idx], q, gallery_samples,
                             distmat[q_idx], topk)
        if not g_idxs:
            print('Skip ranking plot of query id {}: '
                  'no valid gallery available'.format(q_idx))
            continue
        qmasks = gmasks = None
        if masks_fn is not None:
            qmasks = np.asarray(masks_fn([q_idx], 'query'))[0]
            gmasks = np.asarray(masks_fn(g_idxs, 'gallery'))
        paths.append(_part_grid(
            q_idx, q, g_idxs, gallery_samples, distmat, bp_distmat,
            q_vis, g_vis, qmasks, gmasks, save_dir, mAP, rank1,
            dataset_name))
    return paths


def _part_grid(q_idx, q, g_idxs, gallery_samples, distmat, bp_distmat,
               q_vis, g_vis, qmasks, gmasks, save_dir, mAP, rank1,
               dataset_name):
    P = bp_distmat.shape[0]
    rows = len(g_idxs) + 1
    fig = _Figure(rows, P + 1)

    # row 0: the query
    qthumb = _load_thumb(q)
    fig.cell(0, 0, qthumb, border='blue',
             title='query pid {}\nvisible {}/{}'.format(
                 q['pid'], int((q_vis[q_idx] > 0).sum()), P))
    for p in range(P):
        overlay = qthumb if qmasks is None else \
            _overlay_heatmap(qthumb, qmasks[..., p])
        fig.cell(0, p + 1, overlay, border=_vis_border_color(q_vis[q_idx, p]),
                 title='bp {}\n{:.0%}'.format(p, q_vis[q_idx, p]))

    # gallery rows
    for r, g_idx in enumerate(g_idxs, start=1):
        g = gallery_samples[g_idx]
        gthumb = _load_thumb(g)
        match = g['pid'] == q['pid']
        bp_d = bp_distmat[:, q_idx, g_idx]
        vis_score = float(np.sqrt(np.clip(
            q_vis[q_idx] * g_vis[g_idx], 0, None)).sum() / P)
        fig.cell(r, 0, gthumb, border='green' if match else 'red',
                 title='#{} pid {}\n{:.0%} | {:.2f}'.format(
                     r, g['pid'], vis_score, distmat[q_idx, g_idx]))
        lo, hi = int(bp_d.argmin()), int(bp_d.argmax())
        for p in range(P):
            overlay = gthumb if gmasks is None else \
                _overlay_heatmap(gthumb, gmasks[r - 1][..., p])
            fig.cell(r, p + 1, overlay,
                     border=_vis_border_color(g_vis[g_idx, p]),
                     title='{:.0%} | {:.2f}'.format(g_vis[g_idx, p], bp_d[p]),
                     bold=p in (lo, hi))

    # per-part summary: visible count + min/mean/max of the column's
    # distances
    summary = []
    for p in range(P):
        d = bp_distmat[p, q_idx, g_idxs]
        n_vis = int((q_vis[q_idx, p] > 0)
                    + (np.asarray(g_vis)[g_idxs, p] > 0).sum())
        summary.append('bp{}: {}/{} vis, d=[{:.2f};{:.2f};{:.2f}]'.format(
            p, n_vis, rows, d.min(), d.mean(), d.max()))
    title = 'q{} pid {}'.format(q_idx, q['pid'])
    if mAP is not None:
        title += '  (mAP {:.1%}, r1 {:.1%})'.format(mAP, rank1 or 0)
    return fig.save(osp.join(save_dir, 'ranking_{}_q{}.png'.format(
        dataset_name, q_idx)), title + '\n' + ' | '.join(summary))


def _legacy_grid(distmat, indices, query_samples, gallery_samples, save_dir,
                 topk, q_idx_list, q_parts_masks, g_parts_masks, mAP, rank1,
                 dataset_name):
    """One row of ``topk + 1`` cells per query: the query without a
    frame, then the ranked gallery (junk skipped) with green/red frames;
    cells left empty keep a black frame, as matplotlib's empty axes."""
    paths = []
    for q_idx in q_idx_list:
        q = query_samples[q_idx]
        fig = _Figure(1, topk + 1)
        thumb = _load_thumb(q)
        if q_parts_masks is not None:
            thumb = _overlay_masks(thumb, q_parts_masks[q_idx])
        fig.cell(0, 0, thumb, title='query\npid {}'.format(q['pid']))
        shown = 0
        for g_idx in indices[q_idx]:
            g = gallery_samples[g_idx]
            if g['pid'] == q['pid'] and g['camid'] == q['camid']:
                continue  # junk
            thumb = _load_thumb(g)
            if g_parts_masks is not None:
                thumb = _overlay_masks(thumb, g_parts_masks[g_idx])
            fig.cell(0, shown + 1, thumb,
                     border='green' if g['pid'] == q['pid'] else 'red',
                     title='{:.2f}'.format(distmat[q_idx, g_idx]))
            shown += 1
            if shown >= topk:
                break
        for c in range(shown + 1, topk + 1):
            fig.cell(0, c, border='black')
        title = 'q{}'.format(q_idx)
        if mAP is not None:
            title += ' (mAP {:.1%}, r1 {:.1%})'.format(mAP, rank1 or 0)
        paths.append(fig.save(osp.join(save_dir, 'ranking_{}_q{}.png'.format(
            dataset_name, q_idx)), title))
    return paths
