"""Writer: the metrics hub that listens to the engine state (port of
bpbreid_tpu/utils/writer.py).

Phase timers and their table at the end of a run, the eval results,
the query-gallery distance statistics of each test with their two
barplots, and the train scalars through the ``Logger``.
``ProfilerTrace`` wraps ``torch.profiler`` where the JAX package wraps
``jax.profiler``.
"""
import os

import numpy as np
import torch

from bpbreid_tpu_torch.utils.avgmeter import TimeMeter
from bpbreid_tpu_torch.utils.engine_state import EngineStateListener
from bpbreid_tpu_torch.utils.visualization.imaging import TAB10, fill_rect

__all__ = ['Writer', 'ProfilerTrace', 'barplot']

# a barplot canvas: 100 px per bar slot (at least 6 slots) x 300 px, the
# axes inside these margins (top, bottom, left, right)
BAR_SLOT_PX, BAR_HEIGHT_PX = 100, 300
BAR_MARGINS = (30, 40, 60, 20)


def barplot(series, width=0.7):
    """A bar chart on a white canvas, as the JAX writer's
    ``ax.bar`` calls draw it: ``series`` is a list of value arrays of one
    length, drawn side by side in each slot in matplotlib's colour cycle
    (``C0``, ``C1``, ...), each bar ``width / len(series)`` of a slot
    wide; the y axis runs from 0 to ``max(1, max value)``. Returns
    ``(canvas, bars)``: ``bars[s][i]`` is the ``(top, bottom, left,
    right)`` pixel box of bar i of series s (height ``round(v / ymax *
    axes height)``)."""
    series = [np.asarray(v, np.float64) for v in series]
    n = len(series[0])
    top, bottom, left, right = BAR_MARGINS
    w = max(6, n) * BAR_SLOT_PX
    canvas = np.full((BAR_HEIGHT_PX, w, 3), 255, np.uint8)
    y_axis, plot_h = BAR_HEIGHT_PX - bottom, BAR_HEIGHT_PX - bottom - top
    slot = (w - left - right) / max(n, 1)
    ymax = max([1.0] + [float(v.max()) for v in series if v.size])
    bar_w = width / len(series)
    bars = []
    for s, values in enumerate(series):
        boxes = []
        for i, v in enumerate(values):
            centre = left + (i + 0.5 + (s - (len(series) - 1) / 2) * bar_w) \
                * slot
            h = int(round(max(v, 0.0) / ymax * plot_h))
            box = (y_axis - h, y_axis, int(round(centre - bar_w * slot / 2)),
                   int(round(centre + bar_w * slot / 2)))
            fill_rect(canvas, *box, TAB10[s % len(TAB10)])
            boxes.append(box)
        bars.append(boxes)
    fill_rect(canvas, y_axis, y_axis + 1, left, w - right, 'black')
    fill_rect(canvas, top, y_axis + 1, left - 1, left, 'black')
    return canvas, bars


class Writer(EngineStateListener):
    """Listens to ``engine_state`` when one is given."""

    def __init__(self, config=None, logger=None, engine_state=None):
        self.cfg = config
        self.logger = logger
        self.total_run_timer = TimeMeter('total run')
        self.epoch_timer = TimeMeter('epoch')
        self.batch_timer = TimeMeter('batch')
        self.data_loading_timer = TimeMeter('data loading')
        self.eval_results = {}
        self.qg_stats = {}
        if engine_state is not None:
            engine_state.add_listener(self)

    def qg_pairwise_dist_statistics(self, pairwise_dist, bp_dist, q_vis,
                                    g_vis, subsample=False):
        """Query-gallery distance and visibility statistics of a test
        (JAX writer.py:71; reference writer.py:172-186): the valid-pair
        distance mean and std, the invalid-pair share (distance -1), the
        share of queries with no comparable gallery sample, and per part
        the pair availability, the distance mean and std over valid pairs
        and the query and gallery visibility. Kept in ``self.qg_stats``
        (floats and float64 arrays), logged as ``eval/<name>`` scalars
        (``eval/<name>/part_<i>`` for the per-part values) and printed.

        The reductions run in float64 on the device the tensors lie on;
        ``[K, Nq, Ng]`` part distances are reduced one part at a time.
        ``subsample`` labels the print when the matrices are a
        big-gallery subsample. With a logger, the two barplots of
        ``_qg_figures`` are drawn too. Unlike the JAX writer, errors are
        raised, not swallowed.
        """
        f64 = torch.float64
        d = torch.as_tensor(pairwise_dist)
        valid = d != -1
        n_valid = int(valid.sum())
        mean = std = 0.0
        if n_valid:
            vals = d[valid].to(f64)
            mean = float(vals.mean())
            std = float(((vals - mean) ** 2).mean().sqrt())
        stats = {
            'qg_dist_mean': mean, 'qg_dist_std': std,
            'qg_invalid_frac': float((~valid).to(f64).mean()),
            'qg_uncomparable_queries_frac':
                float((~valid.any(dim=1)).to(f64).mean())
                if d.numel() else 0.0,
            'q_vis_mean': float(torch.as_tensor(q_vis).to(f64).mean())
                          if q_vis is not None else 1.0,
            'g_vis_mean': float(torch.as_tensor(g_vis).to(f64).mean())
                          if g_vis is not None else 1.0,
        }
        if bp_dist is not None:
            bp = torch.as_tensor(bp_dist)
            avail, mu, sd = [], [], []
            for part in bp:                # [Nq, Ng], float64 one at a time
                ok = part != -1
                cnt = max(int(ok.sum()), 1)
                x = torch.where(ok, part.to(f64), 0.0)
                m = float(x.sum()) / cnt
                var = float(torch.where(ok, (x - m) ** 2, 0.0).sum()) / cnt
                avail.append(float(ok.to(f64).mean()))
                mu.append(m)
                sd.append(np.sqrt(var))
            stats['part_pair_availability'] = np.asarray(avail, np.float64)
            stats['part_dist_mean'] = np.asarray(mu, np.float64)
            stats['part_dist_std'] = np.asarray(sd, np.float64)
        for key, v in (('q_part_visibility', q_vis),
                       ('g_part_visibility', g_vis)):
            if v is not None:
                stats[key] = torch.as_tensor(v).to(f64).mean(dim=0) \
                    .cpu().numpy()
        self.qg_stats = stats
        if self.logger is not None:
            for k, v in stats.items():
                if np.ndim(v) == 0:
                    self.logger.add_scalar('eval/{}'.format(k), v)
                else:
                    for i, vi in enumerate(np.asarray(v).ravel()):
                        self.logger.add_scalar(
                            'eval/{}/part_{}'.format(k, i), float(vi))
            self._qg_figures(stats)
        print('Query-gallery distance stats{}: mean {qg_dist_mean:.4f} '
              'std {qg_dist_std:.4f} invalid {qg_invalid_frac:.2%} '
              'uncomparable queries {qg_uncomparable_queries_frac:.2%}'
              .format(' (gallery subsample)' if subsample else '', **stats))
        if 'part_pair_availability' in stats:
            print('Per-part pair availability: [{}]'.format(' '.join(
                '{:.0%}'.format(a) for a in stats['part_pair_availability'])))
        return stats

    def _qg_figures(self, stats):
        """The reference's eval barplots (JAX writer.py:144-183): the
        per-part pair availability, and the query and gallery part
        visibility side by side, through ``Logger.add_figure``. The
        labels, the legend and the plotted values (``repr`` of each
        float) are ``tEXt`` chunks. Returns the paths written."""
        paths = []
        labels = {'xlabel': 'Body part index', 'ylabel': 'Availability'}

        def values(v):
            return ' '.join(repr(float(x)) for x in v)
        if 'part_pair_availability' in stats:
            a = stats['part_pair_availability']
            canvas, _ = barplot([a])
            paths.append(self.logger.add_figure(
                'Query-gallery body part pairs availability barplot', canvas,
                text={'title': 'Query-gallery body part pairs availability',
                      **labels, 'values': values(a)}))
        if 'q_part_visibility' in stats and 'g_part_visibility' in stats:
            q, g = stats['q_part_visibility'], stats['g_part_visibility']
            canvas, _ = barplot([q, g])
            paths.append(self.logger.add_figure(
                'Query-gallery body part availability barplot', canvas,
                text={'title': 'Query-gallery body parts availability',
                      **labels, 'legend': 'C0 Query | C1 Gallery',
                      'query': values(q), 'gallery': values(g)}))
        return [p for p in paths if p is not None]

    def report_eval(self, dataset_name, cmc, mAP, ssmd):
        self.eval_results[dataset_name] = {
            'r1': float(cmc[0]), 'mAP': float(mAP), 'ssmd': float(ssmd)}
        if self.logger is not None:
            self.logger.add_scalar('Test/{}/rank1'.format(dataset_name),
                                   float(cmc[0]))
            self.logger.add_scalar('Test/{}/mAP'.format(dataset_name),
                                   float(mAP))

    def report_performance(self, cmc, mAP, ssmd, pxl_acc):
        print('** Final performance: r1 {:.2%}, mAP {:.2%}, ssmd {:.3f} **'
              .format(float(cmc[0]), float(mAP), float(ssmd)))

    def report_global_step(self, loss_summary, lr):
        if self.logger is not None:
            for group, metrics in loss_summary.items():
                for k, v in metrics.items():
                    self.logger.add_scalar(
                        'Train/{}_{}'.format(group, k), float(v))
            self.logger.add_scalar('Train/lr', float(lr))

    def run_completed(self):
        timers = [self.total_run_timer, self.epoch_timer, self.batch_timer,
                  self.data_loading_timer]
        print('\nPhase timing summary:')
        print('{:<28} {:>10} {:>10} {:>8}'.format(
            'phase', 'total(s)', 'avg(s)', 'count'))
        for t in timers:
            if t.meter.count:
                print('{:<28} {:>10.2f} {:>10.4f} {:>8}'.format(
                    t.name, t.meter.sum, t.avg, t.meter.count))


class ProfilerTrace:
    """``torch.profiler`` over a phase (CPU and, where there is one, the
    CUDA device), its Chrome trace written to
    ``<save_dir>/trace.json``."""

    def __init__(self, save_dir, enabled=True):
        self.save_dir = save_dir
        self.enabled = enabled
        self.profile = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.save_dir, exist_ok=True)
            self.profile = profile(activities=activities)
            self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self.profile is not None:
            self.profile.__exit__(*exc)
            self.profile.export_chrome_trace(
                os.path.join(self.save_dir, 'trace.json'))
            self.profile = None
        return False
