"""Meters (port of bpbreid_tpu/utils/avgmeter.py: ``AverageMeter``,
``MetricsSummary``, ``TimeMeter``).

``MetricsSummary`` keeps the train step's loss terms as device tensors
and reads them back lazily, all pending values in one copy, at the next
read (a print or a log) or every ``_MAX_PENDING`` steps: a readback per
step would make the host wait for the device every step.
"""
import time
from collections import defaultdict

import torch

__all__ = ['AverageMeter', 'MetricsSummary', 'TimeMeter']


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricsSummary:
    """Nested dict of AverageMeters keyed by (group, name), fed with
    ``{group: {name: scalar}}`` summaries (tensors or numbers)."""

    _MAX_PENDING = 64

    def __init__(self):
        self.meters = defaultdict(lambda: defaultdict(AverageMeter))
        self._pending = []

    def update(self, summary, n=1):
        self._pending.append((summary, n))
        if len(self._pending) >= self._MAX_PENDING:
            self._drain()

    def _drain(self):
        entries = [(group, name, value, n)
                   for summary, n in self._pending
                   for group, metrics in summary.items()
                   for name, value in metrics.items()]
        self._pending.clear()
        tensors = [e[2] for e in entries if isinstance(e[2], torch.Tensor)]
        # one device-to-host copy for every pending tensor
        read = iter(torch.stack([t.detach().float().reshape(())
                                 for t in tensors]).tolist()) \
            if tensors else iter(())
        for group, name, value, n in entries:
            if isinstance(value, torch.Tensor):
                value = next(read)
            self.meters[group][name].update(value, n)

    def summary_str(self):
        self._drain()
        parts = []
        for group in self.meters:
            inner = ' '.join('{} {:.3f}'.format(k, m.avg)
                             for k, m in self.meters[group].items())
            parts.append('{}: [{}]'.format(group, inner))
        return ' | '.join(parts)

    def avg(self, group, name):
        self._drain()
        return self.meters[group][name].avg


class TimeMeter:
    """Host wall clock of a phase. On the card the step is asynchronous:
    a phase that must include the device's work ends in a readback or a
    synchronize before ``stop``."""

    def __init__(self, name=''):
        self.name = name
        self.meter = AverageMeter()
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is None:
            return
        self.meter.update(time.perf_counter() - self._start)
        self._start = None

    @property
    def avg(self):
        return self.meter.avg
