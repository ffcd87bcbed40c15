"""The test options of bpbreid_tpu_torch's engine vs the JAX engine, on
the CPU: k-reciprocal re-ranking (``utils/rerank.py``), ``_evaluate``
with ``rerank`` and ``save_features``, and the writer's query-gallery
distance statistics.

``_evaluate`` runs on both sides from the same features (a
``feature_extraction`` that hands them over: no model is built):
``[N, 6, 16]`` with planted identities, float visibility. CMC and mAP to
1e-6, the saved arrays equal (the L2-normalized features to 1e-6), the
statistics to 1e-6 (the port reduces in float64, JAX partly in
float32)."""
import types

import numpy as np
import pytest
import torch

from bpbreid_tpu.config import get_default_config as j_default_config
from bpbreid_tpu.engine.part_based import ImagePartBasedEngine as JEngine
from bpbreid_tpu.utils.rerank import re_ranking as j_re_ranking
from bpbreid_tpu.utils.writer import Writer as JWriter
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.utils.logging import Logger
from bpbreid_tpu_torch.utils.rerank import re_ranking
from bpbreid_tpu_torch.utils.writer import Writer
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

K, D, N_IDS = 6, 16, 7


def _random_rerank_inputs(rng, nq, ng):
    pts = rng.normal(size=(nq + ng, 8)).astype(np.float32)
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    return d[:nq, nq:], d[:nq, :nq], d[nq:, nq:]


@pytest.mark.parametrize('nq,ng,k1,k2', [
    (5, 12, 4, 2),
    (20, 60, 20, 6),
    (15, 40, 11, 1),   # odd k1 (banker's-rounded half level), k2=1 (no QE)
])
def test_re_ranking_matches_jax(nq, ng, k1, k2):
    """The cases of tests/test_utils_misc.py, whose oracle is the
    reference's per-sample loop."""
    qg, qq, gg = _random_rerank_inputs(np.random.default_rng(4), nq, ng)
    got = re_ranking(qg, qq, gg, k1=k1, k2=k2)
    assert got.shape == (nq, ng)
    np.testing.assert_allclose(got, j_re_ranking(qg, qq, gg, k1=k1, k2=k2),
                               atol=1e-5)


def _features(seed, n, camid0):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(11).normal(size=(N_IDS, K, D))
    pids = rng.integers(0, N_IDS, n)
    f = (centers[pids] + 0.9 * rng.normal(size=(n, K, D))).astype(np.float32)
    vis = (rng.uniform(size=(n, K)) * (rng.uniform(size=(n, K)) > 0.2)) \
        .astype(np.float32)
    vis[:, 0] = 1.0                      # the foreground stream is visible
    return f, vis, pids, camid0 + rng.integers(0, 3, n)


def _jax_engine(features, writer):
    """The JAX engine's ``_evaluate`` reads these attributes only."""
    eng = object.__new__(JEngine)
    cfg = j_default_config()
    eng.__dict__.update(
        state=object(), config=cfg, datamanager=None, writer=writer,
        mask_filtering_testing=True, dist_combine_strat='mean',
        batch_size_pairwise_dist_matrix=25, detailed_ranking=True,
        device_ranking_threshold=int(2e8), parts_names=[],
        test_embeddings=['bn_foreg', 'parts'])
    sets = iter(features)
    eng._feature_extraction = lambda loader: (*next(sets), 0.0)
    return eng


def _port_engine(features, writer):
    eng = ImagePartBasedEngine(torch.nn.Identity(), device='cpu',
                               batch_size_pairwise_dist_matrix=25,
                               detailed_ranking=True, writer=writer)
    sets = iter(features)

    def feature_extraction(loader):
        f, v, p, c = next(sets)
        return torch.from_numpy(f), torch.from_numpy(v), p, c, 0.0
    eng.feature_extraction = feature_extraction
    return eng


@pytest.mark.parametrize('rerank', [False, True])
@pytest.mark.parametrize('normalize', [False, True])
def test_evaluate_test_options_match_jax(rerank, normalize, tmp_path,
                                         capsys):
    features = [_features(0, 30, 0), _features(1, 70, 1)]
    jwriter = JWriter(j_default_config())
    j_cmc, j_map, j_ssmd, _ = _jax_engine(features, jwriter)._evaluate(
        0, dataset_name='synthetic', normalize_feature=normalize,
        rerank=rerank, save_features=True, save_dir=str(tmp_path / 'jax'))
    j_out = capsys.readouterr().out

    logger = Logger(save_dir=str(tmp_path))
    writer = Writer(logger=logger)
    cmc, mAP, ssmd, _ = _port_engine(features, writer)._evaluate(
        0, dataset_name='synthetic', normalize_feature=normalize,
        rerank=rerank, save_features=True, save_dir=str(tmp_path / 'port'))
    out = capsys.readouterr().out

    np.testing.assert_allclose(cmc[:len(j_cmc)], j_cmc, atol=1e-6)
    assert mAP == pytest.approx(j_map, abs=1e-6)
    assert ssmd == pytest.approx(j_ssmd, rel=1e-4)

    j_npz = np.load(tmp_path / 'jax/features_synthetic/features.npz')
    npz = np.load(tmp_path / 'port/features_synthetic/features.npz')
    assert sorted(npz.files) == sorted(j_npz.files) == sorted(
        ['qf', 'gf', 'q_vis', 'g_vis', 'q_pids', 'g_pids', 'q_camids',
         'g_camids'])
    for k in npz.files:
        assert npz[k].dtype == j_npz[k].dtype, k
        if normalize and k in ('qf', 'gf'):
            np.testing.assert_allclose(npz[k], j_npz[k], atol=1e-6)
        else:
            np.testing.assert_array_equal(npz[k], j_npz[k], err_msg=k)

    want = jwriter.qg_stats
    assert sorted(writer.qg_stats) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(writer.qg_stats[k], v, atol=1e-6,
                                   err_msg=k)
    for line in ('Query-gallery distance stats', 'Per-part pair availability'):
        got_line = next(s for s in out.splitlines() if s.startswith(line))
        assert got_line == next(s for s in j_out.splitlines()
                                if s.startswith(line))
    names = {s['name'] for s in logger.scalars}
    assert {'eval/qg_dist_mean', 'eval/part_dist_std/part_5',
            'eval/g_part_visibility/part_0'} <= names


def test_writer_statistics_of_invalid_pairs():
    """Distances of -1 (pairs with no comparable part) are left out; a
    query with none comparable counts as uncomparable. Against the JAX
    writer, and on numpy inputs (the chunked path's subsample)."""
    rng = np.random.default_rng(3)
    d = rng.uniform(size=(5, 8)).astype(np.float32)
    bp = rng.uniform(size=(3, 5, 8)).astype(np.float32)
    d[1] = -1
    d[3, :4] = -1
    bp[:, 1] = -1
    bp[2, :, :2] = -1
    q_vis = rng.uniform(size=(5, 3)).astype(np.float32)
    g_vis = rng.uniform(size=(8, 3)).astype(np.float32)
    jwriter = JWriter(j_default_config())
    jwriter.qg_pairwise_dist_statistics(d, bp, q_vis, g_vis, subsample=True)
    got = Writer().qg_pairwise_dist_statistics(d, torch.from_numpy(bp),
                                               q_vis, torch.from_numpy(g_vis),
                                               subsample=True)
    assert got['qg_uncomparable_queries_frac'] == pytest.approx(0.2)
    for k, v in jwriter.qg_stats.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)
