"""The end-to-end statistics on synthetic timestamps with a stall: a rate
is all the work of the window over all of its seconds, and the p90 is
taken over every request of the window."""
import types

import pytest

from benchmark import core
from benchmark.traffic import embed, train


class Clock:
    """A fake ``time.perf_counter`` that the fake engines move."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _ctx(kind, workload):
    cell = types.SimpleNamespace(config={}, workload=workload, kind=kind)
    return types.SimpleNamespace(cell=cell, device='cpu', seed=1)


def test_train_rate_counts_the_stall(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(train.time, 'perf_counter', clock)
    steps = iter([1.0, 1.0, 6.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])

    class Engine:
        def forward_backward_multi(self, group):
            clock.now += next(steps)

    tr = train.Traffic(_ctx('train', {'steps_per_dispatch': 8}))
    tr.engine = Engine()
    tr.pool = [{'pid': types.SimpleNamespace(shape=(8, 64))}]
    w = tr.window(10.0)
    # groups of 1, 1, 6 (a stall), 1, 1 s: the window ends on the group
    # that crosses 10 s, at 10 s, with 5 groups of 8 steps of 64 images
    assert w['steps'] == 40 and w['images'] == 40 * 64
    assert w['seconds'] == pytest.approx(10.0)
    assert w['metrics']['train_images_per_s'] == pytest.approx(256.0)


def test_embed_rate_and_p90_over_all_requests(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(embed.time, 'perf_counter', clock)
    lat = [0.25] * 9 + [3.0] + [0.25] * 10     # one stalled request

    tr = embed.Traffic(_ctx('embed', {'batches_per_request': 8}))
    tr.crops = 512
    calls = iter(lat)

    def request(i):
        clock.now += next(calls)
        return None, None
    tr._request = request
    w = tr.window(sum(lat) - 0.01)
    assert w['requests'] == 20
    assert w['seconds'] == pytest.approx(sum(lat))
    assert w['metrics']['embed_images_per_s'] == pytest.approx(
        20 * 512 / sum(lat))
    # nearest rank: the 18th of 20 sorted latencies
    assert w['metrics']['embed_ms_p90'] == pytest.approx(250.0)
    lat2 = [0.25] * 8 + [3.0, 3.0]
    assert core.percentile(lat2, 90) == 3.0
    assert core.percentile(list(range(1, 101)), 90) == 90
    assert core.percentile([5.0], 90) == 5.0
