"""Gallery-sharded retrieval, the collectives and the cross-rank batch
norm of bpbreid_tpu_torch (``parallel/``) on the CPU: 2 gloo ranks (one
spawn for every check) against JAX's sharded functions on the 8-device
CPU mesh and against the port's unsharded path.

- ``pad_to_multiple`` equals JAX's on arrays and keeps tensors tensors;
- ``sharded_bp_distance`` on a gallery of 21 (which neither 2 nor 8
  divides), with boolean, continuous and no visibility and both
  combination strategies: to 1e-5 relative of the port's and JAX's
  unsharded distances and of JAX's sharded ones (relative to the
  features' squared norm where it exceeds the distances: the formula
  rounds at that scale). The incomparable-pair
  sentinel (``max + 1``) is taken over the real columns, as the unsharded
  path takes it: on features whose distances stay below their norms,
  JAX's sharded function takes it over its zero-padded gallery too and
  gives another sentinel (``..._fault_in_jax``);
- ``sharded_cmc_map`` on padded and odd galleries, tied distances and a
  query over ``max_matches`` (the full-sort fallback): CMC and mAP to
  1e-6 of JAX's sharded function and of the port's ``cmc_map``;
- the gathers (f32, bf16, bool, int64) equal the global tensor bit for
  bit; a live gather's gradient is the rank's slice of the weight; the
  differentiable mean over the ranks and its gradient; the dropout mask
  drawn under the mesh is the rank's slice of the one-process mask;
- ``bn_apply_sums`` (its plain path: ``bn_finalize_reference`` then
  ``bn_apply_reference``) on the summed sums of two halves, the summed
  copies of ``bn_grad_local_sums`` and ``bn_dx_reference`` with the global
  count, against JAX's batch norm (``_bn_train`` and its VJP) on the whole
  batch: to 1e-6 relative; and against the port's one-process batch norm
  (``bn_stats``, ``bn_apply``) on the whole batch: statistics, output and
  running statistics to 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpbreid_tpu.metrics.distance import \
    compute_distance_matrix_using_bp_features as j_distance
from bpbreid_tpu.models.common import _bn_train
from bpbreid_tpu.parallel import make_mesh as j_make_mesh
from bpbreid_tpu.parallel import pad_to_multiple as j_pad_to_multiple
from bpbreid_tpu.parallel import sharded_bp_distance as j_sharded_distance
from bpbreid_tpu.parallel import sharded_cmc_map as j_sharded_cmc_map
from bpbreid_tpu_torch.metrics.distance import \
    compute_distance_matrix_using_bp_features
from bpbreid_tpu_torch.models.common import GeneratorDropout
from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_apply, bn_apply_sums,
                                                  bn_dx_reference,
                                                  bn_grad_local_sums,
                                                  bn_local_sums, bn_stats)
from bpbreid_tpu_torch.ops.ranking import cmc_map
from bpbreid_tpu_torch.parallel import pad_to_multiple
from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import limit_torch_threads

limit_torch_threads()

NQ, NG, K, D = 6, 21, 3, 16


def _features(seed, near=False):
    rng = np.random.default_rng(seed)
    if near:
        # every feature near one point of norm ~3: distances well below
        # the norms, so a zero-feature gallery column is the farthest
        centre = 3.0 * rng.standard_normal((1, K, D)) / np.sqrt(D)
        qf = centre + 0.05 * rng.standard_normal((NQ, K, D))
        gf = centre + 0.05 * rng.standard_normal((NG, K, D))
    else:
        qf = rng.random((NQ, K, D))
        gf = rng.random((NG, K, D))
    return qf.astype(np.float32), gf.astype(np.float32), rng


def _distance_cases():
    cases = {}
    qf, gf, rng = _features(0)
    qv, gv = rng.random((NQ, K)) > 0.2, rng.random((NG, K)) > 0.2
    qv[0] = False                 # a query comparable with nothing
    for strat in ('mean', 'max'):
        cases['bool_' + strat] = (qf, gf, qv, gv, strat)
    qf, gf, rng = _features(1)
    qc, gc = rng.random((NQ, K)).astype(np.float32), \
        rng.random((NG, K)).astype(np.float32)
    qc[0] = 0.0
    cases['continuous'] = (qf, gf, qc, gc, 'mean')
    cases['no_visibility'] = (qf, gf, None, None, 'mean')
    qf, gf, rng = _features(2, near=True)
    qc, gc = rng.random((NQ, K)).astype(np.float32), \
        rng.random((NG, K)).astype(np.float32)
    qc[1] = 0.0
    cases['sentinel'] = (qf, gf, qc, gc, 'mean')
    return cases


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _cmc_cases():
    rng = np.random.default_rng(3)
    out = {}
    nq, ng = 10, 50
    distmat = rng.random((nq, ng)).astype(np.float32)
    ids = (rng.integers(0, 10, nq), rng.integers(0, 10, ng),
           rng.integers(0, 3, nq), rng.integers(0, 3, ng))
    out['padded'] = (distmat, ids, 1e9, 128)
    out['odd'] = (distmat[:, :37], (ids[0], ids[1][:37], ids[2],
                                    ids[3][:37]), None, 128)
    # ties: distances on 5 levels
    out['ties'] = (np.round(distmat * 4) / 4, ids, None, 128)
    # queries with more true matches than max_matches: the full sort
    out['overflow'] = (distmat, ids, None, 2)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    # the ranks start up while this process makes their input
    started = ranks.start(ranks.retrieval_checks, 2,
                          tmp_path_factory.mktemp('parallel_retrieval'))
    dcases, ccases = _distance_cases(), _cmc_cases()
    rng = np.random.default_rng(4)
    gather_input = torch.as_tensor(rng.standard_normal((6, 5)),
                                   dtype=torch.float32)
    payload = {
        'distance_cases': {
            name: {'args': (_t(qf), _t(gf), _t(qv), _t(gv)),
                   'kw': {'dist_combine_strat': strat}}
            for name, (qf, gf, qv, gv, strat) in dcases.items()},
        'cmc_cases': {},
        'gather_input': gather_input,
        'gather_weight': torch.as_tensor(rng.standard_normal((6, 5)),
                                         dtype=torch.float32),
        'seed': 7}
    for name, (distmat, ids, pad_value, max_matches) in ccases.items():
        d = distmat
        if pad_value is not None:
            d, _ = pad_to_multiple(distmat, 2, axis=1, value=pad_value)
            d = np.pad(d, ((0, 0), (0, 2)), constant_values=pad_value)
        payload['cmc_cases'][name] = {
            'args': (torch.as_tensor(d),) + ids,
            'kw': {'n_gallery': distmat.shape[1], 'max_rank': 20,
                   'max_matches': max_matches}}
    started.send(payload)
    # JAX while the ranks run
    mesh = j_make_mesh()
    jax_out = {}
    for name, (qf, gf, qv, gv, strat) in dcases.items():
        d, bp, ng = j_sharded_distance(mesh, qf, gf, qv, gv, strat)
        d_ref, bp_ref = j_distance(qf, gf, qv, gv, strat)
        jax_out[name] = {'sharded': (np.asarray(d)[:, :ng],
                                     np.asarray(bp)[..., :ng]),
                         'unsharded': (np.asarray(d_ref), np.asarray(bp_ref))}
    for name, (distmat, ids, pad_value, max_matches) in ccases.items():
        d = distmat
        if pad_value is not None:
            d, _ = j_pad_to_multiple(distmat, 8, axis=1, value=pad_value)
        jax_out[name] = j_sharded_cmc_map(
            mesh, d, *ids, n_gallery=distmat.shape[1], max_rank=20,
            max_matches=max_matches)
    return {'dcases': dcases, 'ccases': ccases, 'payload': payload,
            'jax': jax_out, 'ranks': started.results()}


def test_pad_to_multiple_matches_jax():
    x = np.arange(21 * 3, dtype=np.float32).reshape(21, 3)
    for axis, multiple, value in ((0, 8, 0.0), (1, 2, 1e9), (0, 7, 0.0)):
        got, n = pad_to_multiple(x, multiple, axis, value)
        want, n_want = j_pad_to_multiple(x, multiple, axis, value)
        assert n == n_want and np.array_equal(got, np.asarray(want))
        t, n_t = pad_to_multiple(torch.as_tensor(x), multiple, axis, value)
        assert isinstance(t, torch.Tensor) and n_t == n
        assert np.array_equal(t.numpy(), np.asarray(want))


def _rel_close(got, want, tol=1e-5, scale=0.0):
    """Within ``tol`` of the larger of ``want``'s largest magnitude and
    ``scale``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), scale,
                                                 1e-30)


@pytest.mark.parametrize('case', ['bool_mean', 'bool_max', 'continuous',
                                  'no_visibility', 'sentinel'])
def test_sharded_distance_matches_unsharded_and_jax(runs, case):
    qf, gf, qv, gv, strat = runs['dcases'][case]
    want_d, want_bp = compute_distance_matrix_using_bp_features(
        _t(qf), _t(gf), _t(qv), _t(gv), strat)
    j_d, j_bp = runs['jax'][case]['unsharded']
    # the distances are sqrt(|q|^2 - 2 q.g + |g|^2): they round at the
    # scale of the squared norms, above the distances in the near case
    close = functools.partial(_rel_close,
                              scale=float((qf ** 2).sum(-1).max()))
    for rank_out in runs['ranks']:
        d, bp, ng = rank_out[case]
        assert ng == NG and d.shape[1] == bp.shape[2] == NG + 1
        close(d[:, :ng], want_d)
        close(bp[..., :ng], want_bp)
        close(d[:, :ng], j_d)
        close(bp[..., :ng], j_bp)
        # JAX's sharded function: the same part distances; the combined
        # ones too but in the rows of the pairs that no part compares,
        # which take its other sentinel under continuous visibility
        # (test_sharded_distance_sentinel_fault_in_jax)
        rows = np.ones(NQ, bool)
        if qv is not None and qv.dtype != bool:
            rows = qv.sum(axis=1) > 0
        close(d[:, :ng][rows], runs['jax'][case]['sharded'][0][rows])
        close(bp[..., :ng], runs['jax'][case]['sharded'][1])
    assert torch.equal(runs['ranks'][0][case][0], runs['ranks'][1][case][0])


def test_sharded_distance_sentinel_fault_in_jax(runs):
    """JAX's ``sharded_bp_distance`` takes the ``max + 1`` sentinel over
    the padded gallery (bpbreid_tpu/parallel/retrieval.py:82-87): with
    continuous visibility its zero-feature columns keep their distances,
    here the largest, so the pairs no part compares get another sentinel
    than JAX's own unsharded path gives. The port's sharded path gives the
    unsharded one."""
    j_sharded, _ = runs['jax']['sentinel']['sharded']
    j_unsharded, _ = runs['jax']['sentinel']['unsharded']
    qf, gf = runs['dcases']['sentinel'][:2]
    row = 1                               # the query that sees no part
    real_max = np.asarray(j_unsharded)[row].max()
    assert np.allclose(np.asarray(j_unsharded)[row], real_max)
    assert j_sharded[row].max() > real_max + 1.0   # a padded column's
    assert not np.allclose(j_sharded[row], j_unsharded[row])
    got = runs['ranks'][0]['sentinel'][0][:, :NG].numpy()
    _rel_close(got[row], j_unsharded[row])
    assert not np.allclose(got[row], j_sharded[row])


@pytest.mark.parametrize('case', ['padded', 'odd', 'ties', 'overflow'])
def test_sharded_cmc_map_matches_jax_and_cmc_map(runs, case):
    distmat, ids, _pad, _m = runs['ccases'][case]
    want_cmc, want_map, want_n = cmc_map(torch.as_tensor(distmat), *ids,
                                         max_rank=20)
    j_cmc, j_map, j_n = runs['jax'][case]
    for rank_out in runs['ranks']:
        cmc, mAP, n_valid = rank_out[case]
        assert n_valid == int(want_n) == j_n
        np.testing.assert_allclose(cmc, want_cmc.numpy(), atol=1e-6)
        np.testing.assert_allclose(cmc, j_cmc, atol=1e-6)
        assert mAP == pytest.approx(float(want_map), abs=1e-6)
        assert mAP == pytest.approx(j_map, abs=1e-6)


def test_gathers_mean_and_dropout(runs):
    x = runs['payload']['gather_input']
    w = runs['payload']['gather_weight']
    drop = GeneratorDropout(0.5)
    drop.generator = torch.Generator().manual_seed(runs['payload']['seed'])
    drop.train()
    want_drop = drop(x)
    for r, out in enumerate(runs['ranks']):
        rows = slice(3 * r, 3 * r + 3)
        for dt, g in out['gather'].items():
            assert g.dtype == dt and torch.equal(g, x.to(dt)), dt
        assert torch.equal(out['gather_live_grad'], w[rows])
        halves = torch.stack([x[:3].mean(0), x[3:].mean(0)])
        torch.testing.assert_close(out['mean'], halves.mean(0), rtol=0,
                                   atol=1e-7)
        # d(sum over ranks of mean . w[r]) / d(rank's mean) = mean of w[r]
        torch.testing.assert_close(out['mean_grad'], (w[0] + w[1]) / 2,
                                   rtol=0, atol=1e-7)
        assert torch.equal(out['dropout'], want_drop[rows])


@pytest.mark.parametrize('shape, channel_dim', [((8, 5, 3, 2), 1),
                                                ((8, 7), -1)])
def test_cross_rank_bn_plain_versions_match_jax(shape, channel_dim):
    """Two halves' sums added, finalized with the global count, applied and
    differentiated with the global sums: JAX's batch norm on the whole
    batch (forward and VJP)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    dy = rng.standard_normal(shape).astype(np.float32)
    c = shape[channel_dim]
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    eps = 1e-5
    # JAX: channels last
    to_last = (lambda a: np.moveaxis(a, 1, -1)) if channel_dim == 1 \
        else (lambda a: a)
    (y_j, mean_j, var_j), vjp = jax.vjp(
        lambda a, s, b: _bn_train(a, s, b, eps), jnp.asarray(to_last(x)),
        jnp.asarray(weight), jnp.asarray(bias))
    dx_j, dscale_j, dbias_j = vjp((jnp.asarray(to_last(dy)),
                                   jnp.zeros(c), jnp.zeros(c)))
    xt, dyt, wt, bt = (torch.as_tensor(a) for a in (x, dy, weight, bias))
    halves = (slice(0, 4), slice(4, 8))
    sums = sum(bn_local_sums(xt[h], wt, eps, channel_dim) for h in halves)
    m = x.size // c
    out = []
    for h in halves:
        rm, rv = torch.zeros(c), torch.ones(c)
        out.append(bn_apply_sums(xt[h], sums, m, wt, bt, eps, channel_dim,
                                 running_mean=rm, running_var=rv)
                   + (rm, rv))
    (y0, stats, rm, rv), (y1, stats1, rm1, rv1) = out
    for a, b in zip(stats + (rm, rv), stats1 + (rm1, rv1)):
        assert torch.equal(a, b)
    mean, var, rstd, scale = stats
    _rel_close(mean, mean_j, 1e-6)
    _rel_close(var, var_j, 1e-6)
    _rel_close(rm, 0.1 * np.asarray(mean_j), 1e-6)
    _rel_close(rv, 0.9 + 0.1 * np.asarray(var_j), 1e-6)
    y = torch.cat([y0, y1])
    _rel_close(to_last(y.numpy()), y_j, 1e-6)
    grads = [bn_grad_local_sums(dyt[h], xt[h], mean, rstd, channel_dim)
             for h in halves]
    for g in grads:
        assert torch.equal(g[2], torch.stack(g[:2]))
    # the copies summed, as the all-reduce sums them in place
    g_dy, g_dy_xhat = grads[0][2] + grads[1][2]
    _rel_close(g_dy, dbias_j, 1e-6)
    _rel_close(g_dy_xhat, dscale_j, 1e-6)
    dx = torch.cat([bn_dx_reference(dyt[h], xt[h], mean, rstd, scale, g_dy,
                                    g_dy_xhat, channel_dim, m=m)
                    for h in halves])
    _rel_close(to_last(dx.numpy()), dx_j, 1e-6)
    # the local count would be wrong by the world size
    dx_local = bn_dx_reference(dyt[:4], xt[:4], mean, rstd, scale, g_dy,
                               g_dy_xhat, channel_dim)
    assert not np.allclose(dx_local.numpy(), dx[:4].numpy(), atol=1e-4)


@pytest.mark.parametrize('shape, channel_dim, dtype', [
    ((8, 5, 3, 2), 1, torch.float32), ((8, 7), -1, torch.float32),
    ((6, 4, 5, 3), 1, torch.bfloat16)])
def test_apply_sums_on_two_halves_is_the_one_process_batch_norm(
        shape, channel_dim, dtype):
    """``bn_apply_sums`` on each half with the halves' summed sums and the
    global count: the one-process ``bn_stats`` + ``bn_apply`` on the whole
    batch; statistics, output and running statistics to 1e-6 (one bf16
    ulp more for a bf16 output)."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 1.5
                        + 0.3).to(dtype)
    c = shape[channel_dim]
    weight = torch.as_tensor(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.as_tensor(rng.standard_normal(c).astype(np.float32))
    eps, n = 1e-5, shape[0]
    rm, rv = torch.full((c,), 0.2), torch.full((c,), 1.5)
    rm1, rv1 = rm.clone(), rv.clone()
    want = bn_stats(x, weight, eps, channel_dim, rm1, rv1)
    y_want = bn_apply(x, want[0], want[2], weight, bias, channel_dim)
    halves = (slice(0, n // 2), slice(n // 2, n))
    sums = sum(bn_local_sums(x[h], weight, eps, channel_dim) for h in halves)
    m = x.numel() // c
    ys = []
    for h in halves:
        rm2, rv2 = rm.clone(), rv.clone()
        y, stats = bn_apply_sums(x[h], sums, m, weight, bias, eps,
                                 channel_dim, running_mean=rm2,
                                 running_var=rv2)
        assert y.dtype == dtype
        ys.append(y)
        for a, b in zip(stats + (rm2, rv2), want + (rm1, rv1)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (torch.cat(ys).float() - y_want.float()).abs()
    assert (err <= ulp * y_want.float().abs() + 1e-6).all()
