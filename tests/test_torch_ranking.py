"""bpbreid_tpu_torch device rankers and the CUHK03 protocol vs bpbreid_tpu.

``cmc_map`` and ``cmc_map_counting`` on CPU tensors against the jitted
JAX functions on the same numpy inputs (the cases of tests/test_rank.py):
CMC and mAP within 1e-6 (f32 sums in another order), counts equal.
``eval_cuhk03`` against JAX's with the same ``rng``: bit-equal."""
import numpy as np
import pytest
import torch

from bpbreid_tpu.metrics.rank import eval_cuhk03 as j_eval_cuhk03
from bpbreid_tpu.ops import ranking as j_ranking
from bpbreid_tpu_torch.metrics.rank import eval_cuhk03
from bpbreid_tpu_torch.ops.ranking import cmc_map, cmc_map_counting
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def _case(seed, num_q, num_g, num_pid, num_cam=5, ties=False):
    rng = np.random.default_rng(seed)
    distmat = rng.random((num_q, num_g)).astype(np.float32)
    if ties:
        distmat = np.round(distmat * 8) / 8.0          # many exact ties
    return (distmat, rng.integers(0, num_pid, num_q),
            rng.integers(0, num_pid, num_g), rng.integers(0, num_cam, num_q),
            rng.integers(0, num_cam, num_g))


def _torch(case):
    return (torch.from_numpy(case[0]),) + tuple(
        torch.from_numpy(a) for a in case[1:])


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind in 'iu':
            assert int(g) == int(w)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)


# (name, case args, max_rank, max_matches, block)
CASES = [
    ('random0', (0, 40, 500, 25), 20, 64, 128),
    ('random1', (1, 40, 500, 25), 20, 64, 128),
    ('ties', (5, 30, 300, 15, 5, True), 15, 64, 64),
    ('overflow', (9, 6, 60, 2, 4), 10, 8, 32),
    ('small_gallery', (3, 7, 12, 4, 3), 20, 64, 8192),
    ('tiny_block', (2, 33, 700, 20, 5, True), 50, 64, 1),
]


@pytest.mark.parametrize('name,args,max_rank,max_matches,block', CASES,
                         ids=[c[0] for c in CASES])
def test_counting_ranker_matches_jax(name, args, max_rank, max_matches,
                                     block):
    case = _case(*args)
    want = j_ranking.cmc_map_counting(*case, max_rank=max_rank,
                                      max_matches=max_matches, block=block)
    got = cmc_map_counting(*_torch(case), max_rank=max_rank,
                           max_matches=max_matches, block=block)
    assert got[2].dtype == got[3].dtype == torch.int32
    _close(got, want)
    if name == 'overflow':
        assert int(got[3]) > 0
    else:
        # no query overflows: the counting ranker equals the full sort
        assert int(got[3]) == 0
        _close(got[:3], j_ranking.cmc_map(*case, max_rank=max_rank))


@pytest.mark.parametrize('name,args,max_rank,max_matches,block', CASES,
                         ids=[c[0] for c in CASES])
def test_full_sort_ranker_matches_jax(name, args, max_rank, max_matches,
                                      block):
    del name, max_matches, block
    case = _case(*args)
    _close(cmc_map(*_torch(case), max_rank=max_rank),
           j_ranking.cmc_map(*case, max_rank=max_rank))


def test_counting_ranker_ignores_topk_tie_order():
    """All match distances of a query tied: whatever order ``topk`` returns
    them in, the index tie-break and the sort of the match ranks give the
    stable-sort result."""
    case = list(_case(4, 12, 90, 3, 3))
    case[0] = np.where(case[2][None, :] == case[1][:, None], 0.5,
                       case[0]).astype(np.float32)
    want = j_ranking.cmc_map(*case, max_rank=10)
    got = cmc_map_counting(*_torch(case), max_rank=10, max_matches=64)
    assert int(got[3]) == 0
    _close(got[:3], want)


@pytest.mark.parametrize('seed', [0, 5])
def test_eval_cuhk03_bit_equal_to_jax(seed):
    distmat, q_pids, g_pids, q_camids, g_camids = _case(seed, 20, 120, 12)
    distmat = distmat.astype(np.float64)
    for kwargs in ({}, {'num_repeats': 7}):
        want = j_eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, 10,
                             rng=np.random.default_rng(1), **kwargs)
        got = eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, 10,
                          rng=np.random.default_rng(1), **kwargs)
        np.testing.assert_array_equal(got['cmc'], want['cmc'])
        assert got['mAP'] == want['mAP']
    # the fixed default stream
    want = j_eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, 10)
    got = eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, 10)
    np.testing.assert_array_equal(got['cmc'], want['cmc'])
