"""The ranking grids of bpbreid_tpu_torch (``test.visrank``), drawn
without matplotlib or OpenCV, against what the JAX package draws with
them.

- OpenCV's jet table at all 256 levels, exactly; matplotlib's ``hsv``
  ramp at 1,001 points within 1e-6 and ``tab10`` exactly;
- the cubic resize against ``cv2.resize(INTER_CUBIC)`` within 1e-4, the
  nearest one exactly;
- the heatmap and mask overlays within one uint8 level of JAX's, the
  thumbnails bit-equal;
- the PNG encoder read back by ``read_image`` and ``cv2.imread``
  exactly, its ``tEXt`` chunks by ``read_png_text``;
- both layouts against JAX's ``visualize_ranking_grid`` run here with
  matplotlib (``set_title``, ``suptitle``, the spines' edge colours and
  ``savefig`` captured): the same files, the same titles in the same
  cells, bold where JAX's are, and each cell's frame in JAX's edge
  colour (none where JAX hides the spines);
- ``evaluate`` with ``visrank`` on the smoke config writes the grids, and
  skips them on the chunked path."""
import os

import cv2
import matplotlib
import matplotlib.axes
import matplotlib.figure
import matplotlib.pyplot as plt
import matplotlib.spines
import numpy as np
import pytest
import torch

from bpbreid_tpu.utils.visualization import rankings as jrank
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.data.datasets.dataset import (read_image,
                                                     read_png_text, write_png)
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.visualization import rankings
from bpbreid_tpu_torch.utils.visualization.imaging import (
    JET, TAB10, hsv_colormap, resize_cubic, resize_nearest)
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

matplotlib.use('Agg')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')
CELL = (rankings.THUMB_HW[0] + 2 * rankings.BORDER,
        rankings.THUMB_HW[1] + 2 * rankings.BORDER)


def test_colormaps_match_opencv_and_matplotlib():
    levels = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(
        JET, cv2.applyColorMap(levels, cv2.COLORMAP_JET)[:, 0, ::-1])
    hsv = matplotlib.colormaps['hsv']
    for x in np.linspace(0, 1, 1001):
        np.testing.assert_allclose(hsv_colormap(x), hsv(x)[:3], atol=1e-6)
    tab10 = matplotlib.colormaps['tab10']
    assert [tuple(c) for c in TAB10] == [tab10(i)[:3] for i in range(10)]


@pytest.mark.parametrize('src, dst', [((16, 8), (128, 64)),
                                      ((48, 16), (128, 64)),
                                      ((7, 5), (20, 33)), ((30, 20), (10, 7))])
def test_resizes_match_opencv(src, dst):
    rng = np.random.default_rng(0)
    m = rng.random(src).astype(np.float32)
    np.testing.assert_allclose(
        resize_cubic(m, *dst),
        cv2.resize(m, dst[::-1], interpolation=cv2.INTER_CUBIC), atol=1e-4)
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        resize_nearest(img, *dst),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_overlays_and_thumbnails_match_jax():
    rng = np.random.default_rng(1)
    sample = {'img': rng.integers(0, 256, (96, 40, 3)).astype(np.uint8)}
    thumb = rankings._load_thumb(sample)
    np.testing.assert_array_equal(thumb, jrank._load_thumb(sample))
    for hw in ((16, 8), (48, 16)):
        mask = rng.random(hw).astype(np.float32)
        got = rankings._overlay_heatmap(thumb, mask).astype(int)
        want = jrank._overlay_heatmap(thumb, mask).astype(int)
        assert np.abs(got - want).max() <= 1
    parts = rng.random((16, 8, 5)).astype(np.float32)
    got = rankings._overlay_masks(thumb, parts).astype(int)
    assert np.abs(got - jrank._overlay_masks(thumb, parts).astype(int)) \
        .max() <= 1


def test_png_encoder_round_trips(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (37, 23, 3)) \
        .astype(np.uint8)
    path = str(tmp_path / 'a.png')
    text = {'r0c0': 'query pid 3\nvisible 4/6', 'suptitle': 'q0 | 50%'}
    write_png(path, img, text)
    np.testing.assert_array_equal(read_image(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    assert read_png_text(path) == text


def _inputs():
    rng = np.random.default_rng(3)
    q_n, g_n, p = 3, 12, 3

    def samples(n, offset):
        return [{'img': rng.integers(0, 256, (48, 24, 3)).astype(np.uint8),
                 'pid': (i + offset) % 4, 'camid': i % 2} for i in range(n)]
    query, gallery = samples(q_n, 0), samples(g_n, 1)
    distmat = rng.random((q_n, g_n)).astype(np.float32)
    distmat[1, 3] = -1.0                       # an invalid entry
    bp = rng.random((p, q_n, g_n)).astype(np.float32)
    q_vis = rng.random((q_n, p)).astype(np.float32) * (rng.random((q_n, p))
                                                       > 0.3)
    g_vis = rng.random((g_n, p)).astype(np.float32) * (rng.random((g_n, p))
                                                       > 0.3)
    maps = rng.random((q_n + g_n, 8, 4, p)).astype(np.float32)

    def masks_fn(idxs, kind):
        return maps[[i + (0 if kind == 'query' else q_n) for i in idxs]]
    parts = rng.random((q_n + g_n, 8, 4, 4)).astype(np.float32)
    return dict(distmat=distmat, query_samples=query, gallery_samples=gallery,
                topk=4, q_idx_list=[2], count=3, mAP=0.5, rank1=0.25,
                dataset_name='toy'), \
        dict(bp_distmat=bp, q_vis=q_vis, g_vis=g_vis, masks_fn=masks_fn), \
        dict(q_parts_masks=parts[:q_n], g_parts_masks=parts[q_n:])


def _capture_jax(monkeypatch, save_dir, kw):
    """JAX's figures as ``{file name: {'titles': {(r, c): (title, bold)},
    'edges': {(r, c): rgb uint8 or None}, 'suptitle': str}}``."""
    figs, axes_of = {}, {}
    subplots = plt.subplots

    def record_subplots(*args, **kwargs):
        fig, axes = subplots(*args, **kwargs)
        grid = np.asarray(axes, dtype=object).reshape(args[0], -1)
        for (r, c), ax in np.ndenumerate(grid):
            axes_of[id(ax)] = (fig, (r, c))
        figs[id(fig)] = {'titles': {}, 'edges': {(r, c): 'default'
                                                 for (r, c), _ in
                                                 np.ndenumerate(grid)}}
        return fig, axes

    def record(ax, key, value):
        # calls while subplots builds the axes set matplotlib's defaults
        if id(ax) in axes_of:
            fig, rc = axes_of[id(ax)]
            figs[id(fig)][key][rc] = value

    def set_title(ax, label, *args, **kwargs):
        record(ax, 'titles', (label, kwargs.get('fontweight') == 'bold'))

    def set_edgecolor(spine, color):
        if id(spine.axes) in axes_of:
            record(spine.axes, 'edges', np.round(np.asarray(
                matplotlib.colors.to_rgb(color)) * 255).astype(np.uint8))

    def set_visible(spine, visible):
        if not visible:
            record(spine.axes, 'edges', None)

    def axis(ax, arg):
        record(ax, 'edges', None)

    def suptitle(fig, t, **kwargs):
        figs[id(fig)]['suptitle'] = t

    def savefig(fig, path, **kwargs):
        figs[id(fig)]['path'] = os.path.basename(path)

    monkeypatch.setattr(plt, 'subplots', record_subplots)
    monkeypatch.setattr(matplotlib.axes.Axes, 'set_title', set_title)
    monkeypatch.setattr(matplotlib.axes.Axes, 'axis', axis)
    monkeypatch.setattr(matplotlib.spines.Spine, 'set_edgecolor',
                        set_edgecolor)
    monkeypatch.setattr(matplotlib.spines.Spine, 'set_visible', set_visible)
    monkeypatch.setattr(matplotlib.figure.Figure, 'suptitle', suptitle)
    monkeypatch.setattr(matplotlib.figure.Figure, 'savefig', savefig)
    paths = jrank.visualize_ranking_grid(save_dir=save_dir, **kw)
    monkeypatch.undo()
    out = {rec['path']: rec for rec in figs.values()}
    plt.close('all')
    assert sorted(out) == sorted(os.path.basename(p) for p in paths)
    return out


@pytest.mark.parametrize('layout', ['parts', 'legacy'])
def test_ranking_grid_matches_jax(layout, tmp_path, monkeypatch):
    common, parts_kw, legacy_kw = _inputs()
    kw = dict(common, **(parts_kw if layout == 'parts' else legacy_kw))
    want = _capture_jax(monkeypatch, str(tmp_path / 'jax'), kw)
    paths = rankings.visualize_ranking_grid(save_dir=str(tmp_path / 'port'),
                                            **kw)
    assert sorted(os.path.basename(p) for p in paths) == sorted(want)
    assert len(paths) == 3                     # [2] + two seeded picks
    for path in paths:
        rec = want[os.path.basename(path)]
        text = read_png_text(path)
        img = read_image(path)
        rows = 1 + max(r for r, _ in rec['edges'])
        cols = 1 + max(c for _, c in rec['edges'])
        gap = rankings.GRID_SPACING
        assert img.shape == (rows * CELL[0] + (rows - 1) * gap,
                             cols * CELL[1] + (cols - 1) * gap, 3)
        assert text.pop('suptitle') == rec['suptitle']
        bold = set(text.pop('bold', '').split())
        assert text == {'r{}c{}'.format(r, c): t
                        for (r, c), (t, _) in rec['titles'].items()}
        assert bold == {'r{}c{}'.format(r, c)
                        for (r, c), (_, b) in rec['titles'].items() if b}
        for (r, c), edge in rec['edges'].items():
            frame = img[r * (CELL[0] + gap), c * (CELL[1] + gap)]
            if edge is None:
                assert (frame == 255).all(), (path, r, c)
            elif isinstance(edge, str):        # matplotlib's default spines
                assert (frame == 0).all(), (path, r, c)
            else:
                np.testing.assert_array_equal(frame, edge,
                                              err_msg=str((path, r, c)))


def test_evaluate_draws_the_grids_and_skips_them_when_chunked(tmp_path,
                                                              capsys):
    clear_dataset_cache()
    argv = ['--config-file', SMOKE, '--save_dir', str(tmp_path), '--job-id',
            '1', 'use_gpu', 'False', 'model.compute_dtype', 'float32',
            'test.evaluate', 'True', 'test.visrank', 'True',
            'test.visrank_topk', '4', 'test.visrank_count', '3',
            'test.visrank_q_idx_list', '[0]']
    engine, _ = cli.main(argv)
    out_dir = tmp_path / '1' / 'visrank_synthetic'
    files = sorted(os.listdir(out_dir))
    assert len(files) == 3 and all(f.startswith('ranking_synthetic_q')
                                   for f in files)
    streams = 1 + engine.model.parts_num      # bn_foreg + the parts
    img = read_image(str(out_dir / files[0]))
    gap = rankings.GRID_SPACING
    assert img.shape == (5 * CELL[0] + 4 * gap,
                         (streams + 1) * CELL[1] + streams * gap, 3)
    assert 'r4c{}'.format(streams) in read_png_text(str(out_dir / files[0]))
    loaders = engine.datamanager.test_loader['synthetic']
    engine.device_ranking_threshold = 1
    capsys.readouterr()
    res = engine.evaluate(loaders['query'], loaders['gallery'],
                          visrank=True, visrank_dir=str(tmp_path / 'big'))
    assert res['visrank_paths'] == [] and not (tmp_path / 'big').exists()
    assert 'visrank skipped' in capsys.readouterr().out
    assert torch.isfinite(torch.as_tensor(res['mAP']))
