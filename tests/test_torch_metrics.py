"""bpbreid_tpu_torch part-based distance and CMC/mAP vs bpbreid_tpu.

Distances: f32, 1e-5 (matmul sums in another order). Ranking: equal
CMC and mAP, including tied distances, which the port's stable sort
breaks by gallery index (as the JAX package's native ranker does)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.metrics.distance import \
    compute_distance_matrix_using_bp_features as j_distance
from bpbreid_tpu.metrics.rank import eval_market1501 as j_eval_market1501
from bpbreid_tpu.metrics.rank import evaluate_rank as j_evaluate_rank
from bpbreid_tpu_torch.metrics.distance import \
    compute_distance_matrix_using_bp_features as t_distance
from bpbreid_tpu_torch.metrics.rank import evaluate_rank as t_evaluate_rank
from tests.rank_oracles import eval_market1501_loop
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def _features(nq, ng, k, d, seed):
    rng = np.random.default_rng(seed)
    qf = rng.normal(size=(nq, k, d)).astype(np.float32)
    gf = rng.normal(size=(ng, k, d)).astype(np.float32)
    qv = rng.uniform(size=(nq, k)).astype(np.float32)
    gv = rng.uniform(size=(ng, k)).astype(np.float32)
    qv[0] = 0.0                                  # a query that sees nothing
    return qf, gf, qv, gv


@pytest.mark.parametrize('vis', ['bool', 'float', 'none'])
@pytest.mark.parametrize('strat', ['mean', 'max'])
@pytest.mark.parametrize('chunk', [0, 7])
def test_bp_distance_matches_jax(vis, strat, chunk):
    qf, gf, qv, gv = _features(6, 17, 4, 16, 0)
    if vis == 'bool':
        qv, gv = qv > 0.5, gv > 0.5
    jv = (None, None) if vis == 'none' else (jnp.asarray(qv), jnp.asarray(gv))
    tv = (None, None) if vis == 'none' else (torch.from_numpy(qv),
                                             torch.from_numpy(gv))
    want, want_p = j_distance(jnp.asarray(qf), jnp.asarray(gf), *jv, strat,
                              chunk)
    got, got_p = t_distance(torch.from_numpy(qf), torch.from_numpy(gf), *tv,
                            strat, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)


def test_bp_distance_cosine_matches_jax():
    qf, gf, qv, gv = _features(5, 9, 3, 8, 1)
    args = (qv > 0.3, gv > 0.3, 'mean', 4)
    want, _ = j_distance(jnp.asarray(qf), jnp.asarray(gf),
                         *map(jnp.asarray, args[:2]), *args[2:],
                         metric='cosine')
    got, _ = t_distance(torch.from_numpy(qf), torch.from_numpy(gf),
                        *map(torch.from_numpy, args[:2]), *args[2:],
                        metric='cosine')
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _rank_case(seed, nq=12, ng=40, ties=True):
    rng = np.random.default_rng(seed)
    distmat = rng.uniform(size=(nq, ng)).astype(np.float32)
    if ties:
        # quantize -> many ties, plus whole rows of the max+1 sentinel
        distmat = np.round(distmat * 4) / 4
        distmat[1, :] = 2.0
        distmat[2, ::3] = 2.0
    q_pids = rng.integers(0, 6, nq)
    g_pids = rng.integers(0, 6, ng)
    q_camids = rng.integers(0, 2, nq)
    g_camids = rng.integers(0, 3, ng)
    return distmat, q_pids, g_pids, q_camids, g_camids


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('ties', [True, False])
def test_evaluate_rank_matches_jax_and_oracle(seed, ties):
    case = _rank_case(seed, ties=ties)
    got = t_evaluate_rank(*case, max_rank=10)
    # ties break by gallery index: JAX's numpy ranker on the stable rank
    # of each distance (tie-free) gives the same ordering
    stable_rank = np.argsort(np.argsort(case[0], axis=1, kind='stable'),
                             axis=1).astype(np.float32)
    want = j_eval_market1501(stable_rank, *case[1:], max_rank=10)
    np.testing.assert_allclose(got['cmc'], want['cmc'], atol=1e-7)
    assert got['mAP'] == pytest.approx(want['mAP'], abs=1e-9)
    if not ties:        # the loop oracle's argsort is not stable
        oracle = eval_market1501_loop(*case, max_rank=10)
        np.testing.assert_allclose(got['cmc'], oracle['cmc'], atol=1e-6)
        assert got['mAP'] == pytest.approx(oracle['mAP'], abs=1e-9)
        want = j_evaluate_rank(*case, max_rank=10)
        np.testing.assert_allclose(got['cmc'], want['cmc'], atol=1e-7)
        assert got['mAP'] == pytest.approx(want['mAP'], abs=1e-9)


def test_evaluate_rank_rejects_unported_protocol():
    """An unknown protocol raises as in JAX; 'cuhk03' is ported and equals
    JAX's to the bit (same default sort and fixed-seed stream)."""
    case = _rank_case(0, ties=False)
    with pytest.raises(ValueError):
        t_evaluate_rank(*case, eval_metric='viper')
    got = t_evaluate_rank(*case, max_rank=10, eval_metric='cuhk03')
    want = j_evaluate_rank(*case, max_rank=10, eval_metric='cuhk03')
    np.testing.assert_array_equal(got['cmc'], want['cmc'])
    assert got['mAP'] == want['mAP']
