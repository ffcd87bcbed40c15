"""The debug and test figures of bpbreid_tpu_torch, drawn without
matplotlib, against what the JAX package draws with it (JAX's matplotlib
calls captured with monkeypatch), on the CPU.

- ``listed_colors`` is matplotlib's ``tab10`` / ``tab20`` lookup as
  ``imshow`` and ``scatter`` do it, exactly;
- ``featuremap_to_heatmap`` within 1e-6 of JAX's; ``display_feature_maps``
  draws JAX's heatmap (rounded to uint8) and its part argmax in the
  colours matplotlib gives it, with JAX's titles;
- the batch-hard triplets: the same anchor, positive and negative images
  as JAX's grid, the same titles, the distances within 1e-5 of JAX's
  triplet loss's distance matrix;
- ``_project(method='pca')`` within 1e-5 of JAX's; the figure puts JAX's
  subsampled queries where JAX's scatter does, in JAX's colours; t-SNE
  only runs (it is unseeded in JAX);
- the writer's barplots draw the ``qg_stats`` values (the bar heights and
  the ``tEXt`` values), which equal what JAX's ``ax.bar`` gets;
- ``train.batch_debug_freq`` and ``test.vis_embedding_projection``
  through the port's CLI (smoke config, one epoch) write their files;
  ``materialize_spatial`` gives the multires model its concatenated map
  without changing its outputs.
"""
import os

import matplotlib
import matplotlib.axes
import matplotlib.colors
import matplotlib.figure
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from bpbreid_tpu.losses.triplet import part_based_pairwise_distance_matrix
from bpbreid_tpu.utils import writer as jwriter
from bpbreid_tpu.utils.visualization import batch_triplets as jtriplets
from bpbreid_tpu.utils.visualization import embeddings as jembeddings
from bpbreid_tpu.utils.visualization import feature_maps as jfeature_maps
from bpbreid_tpu_torch.config import get_default_config
from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
from bpbreid_tpu_torch.data.datasets.dataset import read_image, read_png_text
from bpbreid_tpu_torch.scripts import main as cli
from bpbreid_tpu_torch.utils.logging import Logger
from bpbreid_tpu_torch.utils.visualization import batch_triplets
from bpbreid_tpu_torch.utils.visualization import embeddings
from bpbreid_tpu_torch.utils.visualization import feature_maps
from bpbreid_tpu_torch.utils.visualization.imaging import (TAB10, TAB20,
                                                           listed_colors)
from bpbreid_tpu_torch.utils.visualization.rankings import (BORDER,
                                                            GRID_SPACING,
                                                            THUMB_HW)
from bpbreid_tpu_torch.utils.writer import (BAR_HEIGHT_PX, BAR_MARGINS,
                                            Writer, barplot)
from tests.torch_port_helpers import SMALL_W32, limit_torch_threads

limit_torch_threads()

matplotlib.use('Agg')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, 'configs/bpbreid/bpbreid_synthetic_smoke.yaml')


def _capture(monkeypatch, names):
    """Record JAX's calls of the matplotlib ``Axes`` methods ``names``
    (``(method, args, kwargs)``, in order) instead of drawing, and its
    ``savefig`` paths."""
    calls = []
    for name in names:
        monkeypatch.setattr(
            matplotlib.axes.Axes, name,
            lambda ax, *a, _n=name, **kw: calls.append((_n, a, kw)))
    monkeypatch.setattr(matplotlib.figure.Figure, 'savefig',
                        lambda fig, path, **kw: calls.append(
                            ('savefig', (path,), kw)))
    return calls


def _mpl_colors(values, cmap):
    """What matplotlib maps ``values`` to through ``cmap``, as uint8."""
    rgba = matplotlib.colormaps[cmap](matplotlib.colors.Normalize()(
        np.asarray(values, np.float64)))
    return np.round(np.asarray(rgba)[..., :3] * 255).astype(np.uint8)


@pytest.mark.parametrize('table, cmap', [(TAB10, 'tab10'), (TAB20, 'tab20')])
def test_listed_colors_match_matplotlib(table, cmap):
    assert [tuple(c) for c in table] == \
        [matplotlib.colormaps[cmap](i)[:3] for i in range(len(table))]
    rng = np.random.default_rng(0)
    for values in (rng.integers(0, 6, (7, 5)), rng.integers(3, 40, 50) % 20,
                   np.full(4, 3), np.arange(2)):
        np.testing.assert_array_equal(listed_colors(values, table),
                                      _mpl_colors(values, cmap))


@pytest.mark.parametrize('shape', [(6, 4, 16), (16, 8, 64), (5, 3, 3)])
def test_featuremap_to_heatmap_matches_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = feature_maps.featuremap_to_heatmap(x)
    want = jfeature_maps.featuremap_to_heatmap(x)
    assert got.shape == shape[:2] + (3,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_display_feature_maps_draws_jax_panels(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    spatial = rng.normal(size=(3, 12, 4, 32)).astype(np.float32)
    masks = rng.random((3, 12, 4, 5)).astype(np.float32)
    pids = np.array([7, 3, 9])
    calls = _capture(monkeypatch, ['imshow', 'set_title', 'axis'])
    jfeature_maps.display_feature_maps({}, spatial, masks, [''] * 3, pids,
                                       save_dir=str(tmp_path / 'jax'),
                                       max_samples=2)
    monkeypatch.undo()
    plt.close('all')
    shows = [c for c in calls if c[0] == 'imshow']
    titles = [c[1][0] for c in calls if c[0] == 'set_title']
    paths = feature_maps.display_feature_maps(
        {}, spatial, masks, [''] * 3, pids, save_dir=str(tmp_path / 'port'),
        max_samples=2)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(c[1][0]) for c in calls if c[0] == 'savefig']
    f = -(-feature_maps.PANEL_MIN_HEIGHT // 12)
    for i, path in enumerate(paths):
        img = read_image(path)
        heat, parts = shows[2 * i][1][0], shows[2 * i + 1][1][0]
        assert shows[2 * i + 1][2]['cmap'] == 'tab10'
        left = img[:12 * f, :4 * f][::f, ::f]
        np.testing.assert_array_equal(
            left, np.round(heat * 255).astype(np.uint8))
        right = img[:12 * f, 4 * f + GRID_SPACING:][::f, ::f]
        np.testing.assert_array_equal(right, _mpl_colors(parts, 'tab10'))
        text = read_png_text(path)
        assert [text['r0c0'], text['r0c1']] == titles[2 * i:2 * i + 2]
    assert feature_maps.display_feature_maps({}, spatial, masks, [], pids) \
        == []


def test_batch_triplets_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, 32, 16, 3), dtype=np.uint8)
    emb = rng.normal(size=(8, 3, 6)).astype(np.float32)
    pids = np.array([0, 0, 1, 1, 2, 2, 2, 3])    # id 3: no positive
    calls = _capture(monkeypatch, ['imshow', 'set_title', 'axis'])
    jtriplets.display_batch_triplets(images, emb, pids, str(tmp_path / 'j'))
    monkeypatch.undo()
    plt.close('all')
    shown = [next(i for i in range(len(images))
                  if np.array_equal(c[1][0], images[i]))
             for c in calls if c[0] == 'imshow']
    titles = [c[1][0] for c in calls if c[0] == 'set_title']
    rows, dist = batch_triplets.mine_batch_hard(emb, pids)
    assert [i for row in rows for i in row] == shown
    want = np.asarray(part_based_pairwise_distance_matrix(
        emb.mean(axis=1)[None]))[0]
    np.testing.assert_allclose(dist, want, atol=1e-5)
    path = batch_triplets.display_batch_triplets(images, emb, pids,
                                                 str(tmp_path / 'port'))
    text = read_png_text(path)
    assert [text['r{}c{}'.format(r, c)] for r in range(len(rows))
            for c in range(3)] == titles
    img = read_image(path)
    cell = THUMB_HW[0] + 2 * BORDER + GRID_SPACING
    assert img.shape[0] == len(rows) * cell - GRID_SPACING
    assert batch_triplets.display_batch_triplets(
        images[:2], emb[:2], np.array([0, 1]), str(tmp_path / 'none')) is None


def test_pca_projection_and_scatter_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(30, 12))
    np.testing.assert_allclose(embeddings._project(x, method='pca'),
                               jembeddings._project(x, method='pca'),
                               atol=1e-5)
    qf = rng.normal(size=(14, 3, 4)).astype(np.float32)
    gf = rng.normal(size=(40, 3, 4)).astype(np.float32)
    q_pids, g_pids = rng.integers(0, 30, 14), rng.integers(0, 30, 40)
    calls = _capture(monkeypatch, ['scatter', 'legend', 'set_title'])
    jembeddings.visualize_embeddings_projection(
        qf, gf, q_pids, g_pids, str(tmp_path / 'j'), dataset_name='toy',
        max_points=10, method='pca', seed=3)
    monkeypatch.undo()
    plt.close('all')
    (_, (gx, gy), gkw), (_, (qx, qy), qkw) = \
        [c for c in calls if c[0] == 'scatter']
    path = embeddings.visualize_embeddings_projection(
        qf, gf, q_pids, g_pids, str(tmp_path / 'port'), dataset_name='toy',
        max_points=10, method='pca', seed=3)
    assert os.path.basename(path) == 'embeddings_toy.png'
    assert read_png_text(path)['title'] == \
        [c[1][0] for c in calls if c[0] == 'set_title'][0]
    img = read_image(path)
    pts = np.stack([np.concatenate([qx, gx]), np.concatenate([qy, gy])], 1)
    ys, xs = embeddings._to_pixels(np.stack([qx, qy], 1), pts.min(0),
                                   pts.max(0))
    colors = _mpl_colors(qkw['c'], 'tab20')
    assert qkw['marker'] == 'x' and gkw['marker'] == 'o'
    hits = [np.array_equal(img[int(round(y)), int(round(x))], c)
            for y, x, c in zip(ys, xs, colors)]
    assert sum(hits) >= len(hits) - 1      # a later cross may cover one
    gys, gxs = embeddings._to_pixels(np.stack([gx, gy], 1), pts.min(0),
                                     pts.max(0))
    assert all((img[int(round(y)), int(round(x))] != 255).any()
               for y, x in zip(gys, gxs))


def test_tsne_projection_runs(tmp_path):
    pytest.importorskip('sklearn')
    rng = np.random.default_rng(5)
    path = embeddings.visualize_embeddings_projection(
        rng.normal(size=(12, 8)), rng.normal(size=(20, 8)),
        rng.integers(0, 5, 12), rng.integers(0, 5, 20), str(tmp_path),
        dataset_name='t', method='tsne')
    assert read_image(path).shape == (embeddings.FIGURE_PX,) * 2 + (3,)


@pytest.mark.parametrize('values', [[0.25, 1.0, 0.5], [0.0, 2.0],
                                    [0.1 * i for i in range(9)]])
def test_barplot_heights_are_the_values(values):
    canvas, bars = barplot([values])
    top, bottom = BAR_MARGINS[:2]
    plot_h = BAR_HEIGHT_PX - top - bottom
    ymax = max(1.0, max(values))
    for v, (y0, y1, x0, x1) in zip(values, bars[0]):
        assert y1 - y0 == int(round(v / ymax * plot_h))
        col = canvas[:, (x0 + x1) // 2]
        blue = (col == np.round(np.asarray(TAB10[0]) * 255)).all(axis=1)
        assert blue.sum() == y1 - y0


def test_writer_barplots_draw_the_qg_stats(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    d = rng.random((5, 7)).astype(np.float32)
    bp = rng.random((4, 5, 7)).astype(np.float32)
    bp[bp < 0.3] = -1
    q_vis = rng.random((5, 4)) > 0.3
    g_vis = rng.random((7, 4)) > 0.4
    cfg = get_default_config()
    logger = Logger(cfg, save_dir=str(tmp_path))
    stats = Writer(cfg, logger=logger).qg_pairwise_dist_statistics(
        torch.as_tensor(d), torch.as_tensor(bp), torch.as_tensor(q_vis),
        torch.as_tensor(g_vis))
    fig_dir = tmp_path / 'figures'
    pairs = read_png_text(str(
        fig_dir / 'Query-gallery body part pairs availability barplot_0.png'))
    vis = read_png_text(str(
        fig_dir / 'Query-gallery body part availability barplot_0.png'))
    np.testing.assert_array_equal(
        [float(v) for v in pairs['values'].split()],
        stats['part_pair_availability'])
    np.testing.assert_array_equal([float(v) for v in vis['query'].split()],
                                  stats['q_part_visibility'])
    np.testing.assert_array_equal([float(v) for v in vis['gallery'].split()],
                                  stats['g_part_visibility'])
    assert (pairs['xlabel'], pairs['ylabel']) == ('Body part index',
                                                  'Availability')
    # JAX's ax.bar gets the same values
    calls = _capture(monkeypatch, ['bar', 'set_title'])

    class _Logger:
        def add_scalar(self, *args):
            pass

        def add_figure(self, name, fig):
            calls.append(('add_figure', (name,), {}))
    jw = jwriter.Writer(logger=_Logger())
    jw.qg_pairwise_dist_statistics(d, bp, q_vis, g_vis)
    monkeypatch.undo()
    plt.close('all')
    bars = [c[1][1] for c in calls if c[0] == 'bar']
    np.testing.assert_allclose(bars[0], stats['part_pair_availability'],
                               atol=1e-12)
    np.testing.assert_allclose(bars[1], stats['q_part_visibility'],
                               atol=1e-12)
    np.testing.assert_allclose(bars[2], stats['g_part_visibility'],
                               atol=1e-12)
    assert [c[1][0] for c in calls if c[0] == 'set_title'] == \
        [pairs['title'], vis['title']]


def test_logger_figures_need_save_disk(tmp_path):
    canvas = np.zeros((4, 6, 3), np.uint8)
    assert Logger(save_dir=str(tmp_path)).add_figure('a', canvas) is None
    cfg = get_default_config()
    path = Logger(cfg, save_dir=str(tmp_path)).add_image('x/y', canvas, 3)
    assert os.path.basename(path) == 'x_y_3.png'
    np.testing.assert_array_equal(read_image(path), canvas)
    cfg.project.logger.save_disk = False
    assert Logger(cfg, save_dir=str(tmp_path)).add_figure('b', canvas) \
        is None


def test_materialize_spatial_keeps_the_multires_outputs():
    from bpbreid_tpu_torch.models.bpbreid import BPBreID
    torch.manual_seed(0)
    model = BPBreID(num_classes=7, parts_num=5, backbone='hrnet32',
                    backbone_stages=SMALL_W32, dim_reduce_output=32).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(2, 3, 64, 32)
    with torch.no_grad():
        plain = model(x)
        got = model(x, materialize_spatial=True)
        backbone = model.backbone_appearance_feature_extractor
        want = backbone.concat(backbone.forward_branches(x))
    assert plain[4] is None
    assert torch.equal(got[4], want)
    for k, v in plain[0].items():
        assert torch.equal(got[0][k], v), k


def test_debug_and_projection_figures_through_the_cli(tmp_path):
    clear_dataset_cache()
    argv = ['--config-file', SMOKE, '--save_dir', str(tmp_path),
            '--job-id', '1', 'use_gpu', 'False', 'model.compute_dtype',
            'float32', 'train.batch_debug_freq', '2',
            'test.vis_embedding_projection', 'True']
    engine, _ = cli.main(argv)
    run = tmp_path / '1'
    maps = sorted(p.name for p in (run / 'debug_feature_maps').iterdir())
    assert maps == ['featuremap_{}.png'.format(i) for i in range(4)]
    text = read_png_text(str(run / 'debug_feature_maps' / maps[0]))
    assert text['r0c0'].startswith('features (pid ') and \
        text['r0c1'] == 'parts argmax'
    triplets = read_png_text(str(run / 'debug_triplets' / 'triplets.png'))
    assert triplets['r0c0'].startswith('anchor ')
    assert triplets['r0c1'].startswith('pos d=')
    assert triplets['r0c2'].startswith('neg d=')
    proj = run / 'embeddings_synthetic' / 'embeddings_synthetic.png'
    assert read_png_text(str(proj))['title'] == \
        'synthetic embedding projection'
    assert sorted(p.name for p in (run / 'figures').iterdir()) == [
        'Query-gallery body part availability barplot_0.png',
        'Query-gallery body part pairs availability barplot_0.png']
    # the hook on its own: the model goes back to train mode
    batch = next(iter(engine.datamanager.train_loader))
    engine.model.train()
    paths = engine._debug_visualize_batch(batch)
    assert engine.model.training and len(paths) == 5
