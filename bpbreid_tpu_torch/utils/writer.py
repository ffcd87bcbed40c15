"""Writer: the metrics hub that listens to the engine state (port of
bpbreid_tpu/utils/writer.py).

Phase timers and their table at the end of a run, the eval results, and
the train scalars through the ``Logger``. The query-gallery distance
statistics and their figures are not ported (ROADMAP Queue 1 item 4)
and raise. ``ProfilerTrace`` wraps ``torch.profiler`` where the JAX
package wraps ``jax.profiler``.
"""
import os

from bpbreid_tpu_torch.utils.avgmeter import TimeMeter
from bpbreid_tpu_torch.utils.engine_state import EngineStateListener

__all__ = ['Writer', 'ProfilerTrace']


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
        if engine_state is not None:
            engine_state.add_listener(self)

    def qg_pairwise_dist_statistics(self, *args, **kwargs):
        raise NotImplementedError(
            'query-gallery distance statistics are not ported yet (ROADMAP '
            'Queue 1 item 4)')

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
