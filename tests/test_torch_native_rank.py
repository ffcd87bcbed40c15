"""The native C++ ranker of bpbreid_tpu_torch (``native/rank.py``,
``native/rank.cpp``) against the port's numpy ranker and the JAX
package's rankers, on the CPU.

- Market-1501 protocol: the port's native ranker, the port's numpy path
  and JAX's native ranker (JAX's default) agree on CMC and mAP to 1e-6,
  with tied distances and queries without a match in the gallery, at 2
  threads; JAX's numpy path too where no distances tie (its argsort is
  not stable, so under ties it orders the gallery otherwise);
- CUHK03: the port's native CMC equals JAX's native ranker's bit for bit
  for the same seed (the same counter-based stream), at any thread count;
  its mAP equals the numpy path's (1e-6);
- ``evaluate_rank`` dispatches as JAX's does: Market-1501 to the native
  ranker unless ``use_native=False``, CUHK03 to numpy;
- a failed build raises with the compiler's output; nothing falls back.
"""
import numpy as np
import pytest

from bpbreid_tpu.metrics import rank as jrank
from bpbreid_tpu.native import rank as jnative
from bpbreid_tpu_torch.metrics import rank as trank
from bpbreid_tpu_torch.native import rank as native
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()


def _case(seed, num_q=40, num_g=300, n_ids=25, levels=None):
    """Seeded distances and ids; ``levels`` quantizes the distances so
    that many tie. Ids 0-4 of the queries are absent from the gallery
    (queries without a match)."""
    rng = np.random.default_rng(seed)
    distmat = rng.random((num_q, num_g)).astype(np.float32)
    if levels:
        distmat = np.round(distmat * levels) / levels
    q_pids = rng.integers(0, n_ids, num_q)
    g_pids = rng.integers(5, n_ids, num_g)
    return (distmat, q_pids, g_pids, rng.integers(0, 5, num_q),
            rng.integers(0, 5, num_g))


@pytest.mark.parametrize('seed, levels, max_rank', [
    (0, None, 30), (1, 4, 50), (2, 16, 400), (3, 1, 10), (4, None, 1),
    (5, 2, 300)])
def test_native_market1501_matches_numpy_and_jax(seed, levels, max_rank):
    args = _case(seed, levels=levels)
    got = native.eval_market1501(*args, max_rank, num_threads=2)
    refs = [trank.eval_market1501(*args, max_rank),
            jnative.eval_market1501(*args, max_rank, num_threads=2)]
    if levels is None:
        refs.append(jrank.eval_market1501(*args, max_rank))
    assert got['cmc'].dtype == np.float32
    assert len(got['cmc']) == min(max_rank, args[0].shape[1])
    for ref in refs:
        np.testing.assert_allclose(got['cmc'], ref['cmc'], atol=1e-6)
        assert got['mAP'] == pytest.approx(ref['mAP'], abs=1e-6)


def test_native_market1501_ties_keep_gallery_order():
    """All distances equal: the stable sort keeps gallery index order, so
    the first kept match's position decides rank-1."""
    distmat = np.zeros((2, 4), np.float32)
    q_pids, g_pids = np.array([1, 2]), np.array([3, 1, 2, 2])
    q_cam, g_cam = np.array([0, 0]), np.array([1, 1, 0, 1])
    got = native.eval_market1501(distmat, q_pids, g_pids, q_cam, g_cam, 4,
                                 num_threads=2)
    want = trank.eval_market1501(distmat, q_pids, g_pids, q_cam, g_cam, 4)
    np.testing.assert_array_equal(got['cmc'], want['cmc'])
    np.testing.assert_array_equal(got['cmc'], [0.0, 0.5, 1.0, 1.0])
    assert got['mAP'] == pytest.approx(want['mAP'], abs=1e-12)


@pytest.mark.parametrize('seed', [0, 3])
def test_native_cuhk03_equals_jax_native_bit_for_bit(seed):
    args = _case(seed, num_q=30, num_g=200, n_ids=12)
    a = native.eval_cuhk03(*args, 15, num_repeats=10, seed=7, num_threads=2)
    b = native.eval_cuhk03(*args, 15, num_repeats=10, seed=7, num_threads=5)
    want = jnative.eval_cuhk03(*args, 15, num_repeats=10, seed=7,
                               num_threads=2)
    np.testing.assert_array_equal(a['cmc'], want['cmc'])
    np.testing.assert_array_equal(b['cmc'], want['cmc'])
    assert a['mAP'] == want['mAP'] == b['mAP']
    numpy_path = trank.eval_cuhk03(*args, 15)
    assert a['mAP'] == pytest.approx(numpy_path['mAP'], abs=1e-6)


def test_evaluate_rank_dispatches_as_jax(monkeypatch):
    args = _case(5, num_q=10, num_g=60, n_ids=8)
    calls = []
    real = native.eval_market1501

    def recording(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)
    monkeypatch.setattr(native, 'eval_market1501', recording)
    out = trank.evaluate_rank(*args, max_rank=10)
    assert calls == [10]
    plain = trank.evaluate_rank(*args, max_rank=10, use_native=False)
    assert calls == [10]
    want = jrank.evaluate_rank(*args, max_rank=10, use_native=False)
    for got in (out, plain):
        np.testing.assert_allclose(got['cmc'], want['cmc'], atol=1e-6)
        assert got['mAP'] == pytest.approx(want['mAP'], abs=1e-6)
    cuhk = trank.evaluate_rank(*args, max_rank=10, eval_metric='cuhk03')
    want = jrank.evaluate_rank(*args, max_rank=10, eval_metric='cuhk03')
    assert calls == [10]
    np.testing.assert_array_equal(cuhk['cmc'], want['cmc'])
    assert cuhk['mAP'] == pytest.approx(want['mAP'], abs=1e-12)
    with pytest.raises(ValueError, match='eval_metric'):
        trank.evaluate_rank(*args, eval_metric='market')


def test_native_refuses_bad_operands_and_rankless_galleries():
    args = _case(0, num_q=4, num_g=20)
    with pytest.raises(ValueError, match=r'\[Nq, Ng\]'):
        native.eval_market1501(args[0][0], *args[1:], 5)
    with pytest.raises(ValueError, match='do not fit'):
        native.eval_market1501(args[0], args[1][:3], *args[2:], 5)
    distmat, q_pids, g_pids, q_cam, g_cam = args
    with pytest.raises(RuntimeError, match='do not appear'):
        native.eval_market1501(distmat, q_pids * 0 + 99, g_pids, q_cam,
                               g_cam, 5)


def test_library_is_keyed_by_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith('librank-')
    monkeypatch.setattr(native, 'CXX_FLAGS', native.CXX_FLAGS + ('-g',))
    assert native.library_path() != path


@pytest.mark.parametrize('what', ['missing compiler', 'failing compile'])
def test_failed_build_raises(monkeypatch, tmp_path, what):
    """No fallback to numpy: the build's failure reaches the caller, with
    what the compiler said."""
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
    if what == 'missing compiler':
        monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-g++'))
        match = 'cannot run'
    else:
        monkeypatch.setattr(native, 'CXX_FLAGS',
                            native.CXX_FLAGS + ('-fno-such-rank-flag',))
        match = 'exit [1-9]'
    args = _case(0, num_q=4, num_g=20)
    with pytest.raises(RuntimeError, match=match) as err:
        trank.evaluate_rank(*args, max_rank=5)
    if what == 'failing compile':
        assert 'no-such-rank-flag' in str(err.value).split('\n', 1)[1]
    assert not list(tmp_path.glob('librank-*.so'))
