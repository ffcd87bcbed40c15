"""The port's query-chunked large-gallery eval vs the JAX engine's
``_chunked_device_eval`` and vs the port's own host path.

The JAX method reads only ``dist_combine_strat``,
``batch_size_pairwise_dist_matrix`` and ``detailed_ranking`` from its
engine, so it runs on a ``types.SimpleNamespace`` and no model is built.
Both get the same numpy features: ``[N, 6, 16]`` L2-normalized with
planted identities, binary visibility with about 20 % of the parts
invisible. CMC, mAP and the per-part rows within 1e-5 (f32 sums in
another order), pair statistics within 1e-5, the host subsample equal to
f32 rounding; the chunked path against the host path: CMC and mAP 1e-5,
SSMD 1e-4 (f32 device sums against the host's f64 pass)."""
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu.engine.part_based import ImagePartBasedEngine as JEngine
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

K, D, N_IDS = 6, 16, 9


def _features(seed, n, camid0):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(123).normal(size=(N_IDS, K, D))
    pids = rng.integers(0, N_IDS, n)
    f = centers[pids] + 0.9 * rng.normal(size=(n, K, D))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    vis = rng.uniform(size=(n, K)) > 0.2
    vis[:, 0] = True                     # the foreground stream is visible
    camids = camid0 + rng.integers(0, 3, n)
    return f.astype(np.float32), vis, pids, camids


@pytest.fixture(scope='module')
def data():
    return _features(0, 35, 0), _features(1, 60, 1)


def _engine():
    return ImagePartBasedEngine(torch.nn.Identity(), device='cpu',
                                dist_combine_strat='mean',
                                batch_size_pairwise_dist_matrix=25,
                                detailed_ranking=True)


@pytest.mark.parametrize('budget', [1, 2 << 30])
def test_chunked_eval_matches_jax(data, budget):
    """budget 1: chunks of 16, the last one 3 real queries + 13 padded."""
    (qf, qv, qp, qc), (gf, gv, gp, gc) = data
    ns = types.SimpleNamespace(dist_combine_strat='mean',
                               batch_size_pairwise_dist_matrix=25,
                               detailed_ranking=True)
    want = JEngine._chunked_device_eval(ns, qf, gf, qv, gv, qp, gp, qc, gc,
                                        'euclidean', None,
                                        part_bytes_budget=budget)
    got = _engine()._chunked_device_eval(
        torch.from_numpy(qf), torch.from_numpy(gf), torch.from_numpy(qv),
        torch.from_numpy(gv), qp, gp, qc, gc, 'euclidean',
        part_bytes_budget=budget)
    (cmc, mAP, sub_d, sub_bp, n_host, sub_gp, sub_gc, rows, stats) = got
    assert n_host == want[4] == (16 if budget == 1 else 35)
    np.testing.assert_allclose(cmc, want[0], atol=1e-5)
    assert mAP == pytest.approx(want[1], abs=1e-5)
    np.testing.assert_allclose(sub_d, want[2], atol=1e-5)
    np.testing.assert_allclose(sub_bp, want[3], atol=1e-5)
    np.testing.assert_array_equal(sub_gp, want[5])
    np.testing.assert_array_equal(sub_gc, want[6])
    np.testing.assert_allclose(np.asarray(rows), np.asarray(want[7]),
                               atol=1e-5)
    np.testing.assert_allclose(stats, want[8], atol=1e-5)


def test_chunked_evaluate_matches_host_path(data):
    """``evaluate`` above the threshold (forced to 1, several chunks)
    against the same engine's host path."""
    (qf, qv, qp, qc), (gf, gv, gp, gc) = data
    loaders = {'q': (torch.from_numpy(qf), torch.from_numpy(qv.astype(
        np.float32)), qp, qc, 0.0), 'g': (torch.from_numpy(gf),
                                          torch.from_numpy(gv.astype(
                                              np.float32)), gp, gc, 0.0)}
    engine = _engine()
    engine.feature_extraction = loaders.__getitem__
    host = engine.evaluate('q', 'g', normalize_feature=False)
    engine.device_ranking_threshold = 1
    calls = []
    chunked = engine._chunked_device_eval
    engine._chunked_device_eval = lambda *a, **k: (
        calls.append(1), chunked(*a, **k, part_bytes_budget=1))[1]
    dev = engine.evaluate('q', 'g', normalize_feature=False)
    assert calls and dev['distmat'].shape == (16, 60)
    assert host['distmat'].shape == (35, 60)
    np.testing.assert_allclose(dev['cmc'], host['cmc'], atol=1e-5)
    assert dev['mAP'] == pytest.approx(host['mAP'], abs=1e-5)
    assert dev['ssmd'] == pytest.approx(host['ssmd'], abs=1e-4)
    assert [r[0] for r in dev['parts_ranking']] == \
        [r[0] for r in host['parts_ranking']] == \
        ['foreground', 'p1', 'p2', 'p3', 'p4', 'p5']
    np.testing.assert_allclose([r[1:] for r in dev['parts_ranking']],
                               [r[1:] for r in host['parts_ranking']],
                               atol=1e-3)          # percent: 1e-5 of 1
    # the CUHK03 protocol has no chunked form: it stays on the host
    calls.clear()
    cuhk = engine.evaluate('q', 'g', normalize_feature=False,
                           use_metric_cuhk03=True)
    assert not calls and cuhk['distmat'].shape == (35, 60)
