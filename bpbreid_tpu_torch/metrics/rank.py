"""CMC / mAP ranking on the host (port of bpbreid_tpu/metrics/rank.py:
``eval_market1501`` :34, ``eval_cuhk03`` :71, ``evaluate_rank`` :162).

``evaluate_rank`` ranks the Market-1501 protocol with the native C++
ranker (``native/rank.py``) by default, as JAX does; its build failing
raises, and only ``use_native=False`` takes the numpy path, which stays
here as the plain version.

Vectorized over all queries: junk removal and the cumulative statistics
are masked cumsums over the sorted gallery axis. The Market-1501 sort is
stable, so tied distances keep gallery index order (as the JAX package's
native ranker does); the ``max + 1`` sentinel of incomparable pairs makes
ties. The CUHK03 path is a copy of the JAX one, its default sort and its
fixed-seed sampling stream included, so its CMC is the same to the bit.
"""
import numpy as np

__all__ = ['evaluate_rank', 'eval_market1501', 'eval_cuhk03']


def eval_market1501(distmat, q_pids, g_pids, q_camids, g_camids, max_rank):
    """Market-1501 protocol: same-(pid, camid) gallery entries are junk."""
    num_q, num_g = distmat.shape
    max_rank = min(max_rank, num_g)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    indices = np.argsort(distmat, axis=1, kind='stable')
    matches = g_pids[indices] == q_pids[:, None]
    keep = ~(matches & (g_camids[indices] == q_camids[:, None]))

    mk = matches & keep                                     # kept true matches
    pos = np.cumsum(keep, axis=1) - 1                       # rank among kept
    cum_matches = np.cumsum(mk, axis=1)
    num_rel = cum_matches[:, -1]
    valid_q = num_rel > 0
    if not np.any(valid_q):
        raise RuntimeError(
            'Error: all query identities do not appear in gallery')

    with np.errstate(invalid='ignore', divide='ignore'):
        prec = np.where(mk, cum_matches / (pos + 1.0), 0.0)
        ap = prec.sum(axis=1) / np.maximum(num_rel, 1)

    first_match = np.where(mk, pos, num_g).min(axis=1)      # [Q]
    ranks = np.arange(max_rank)[None, :]
    cmc_per_q = (first_match[:, None] <= ranks).astype(np.float32)
    cmc = cmc_per_q[valid_q].sum(axis=0) / valid_q.sum()
    mAP = float(ap[valid_q].mean())
    return {'cmc': cmc.astype(np.float32), 'mAP': mAP}


def eval_cuhk03(distmat, q_pids, g_pids, q_camids, g_camids, max_rank,
                num_repeats=10, rng=None):
    """CUHK03 protocol: single-gallery-shot CMC, resampled ``num_repeats``
    times; AP over the full kept gallery.

    The kept entries are laid out contiguously by (query, pid) group with
    one sort of composite integer keys; each repeat then draws one
    uniform member per group and counts, per query, the groups whose pick
    precedes the pick of its true group. ``rng`` defaults to
    ``np.random.default_rng(0)``, so repeated evaluations agree.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    num_q, num_g = distmat.shape
    max_rank = min(max_rank, num_g)

    # dense pid ids so (query, pid, position) packs into one int64 key
    uq_pids = np.unique(g_pids)
    num_p = len(uq_pids)
    g_pid_dense = np.searchsorted(uq_pids, g_pids)

    indices = np.argsort(distmat, axis=1)
    pd_sorted = g_pid_dense[indices]
    matches = uq_pids[pd_sorted] == q_pids[:, None]
    keep = ~(matches & (g_camids[indices] == q_camids[:, None]))

    mk = matches & keep
    valid_q = mk.any(axis=1)
    if not np.any(valid_q):
        raise RuntimeError(
            'Error: all query identities do not appear in gallery')

    # AP: the full kept set, the same cumsums as eval_market1501
    pos = np.cumsum(keep, axis=1, dtype=np.int32) - 1
    cum_matches = np.cumsum(mk, axis=1, dtype=np.int32)
    num_rel = cum_matches[:, -1]
    with np.errstate(invalid='ignore', divide='ignore'):
        prec = np.where(mk, cum_matches / (pos + 1.0), 0.0)
    ap = prec.sum(axis=1) / np.maximum(num_rel, 1)

    # CMC: kept entries laid out by (query, pid) group, via one sort of
    # (q·P + pid)·G + j keys
    qk, jk = np.nonzero(keep)
    key = (qk * num_p + pd_sorted[qk, jk]) * num_g + jk
    key = np.sort(key, kind='stable')
    group_key = key // num_g                     # q·P + pid per entry
    jk = key % num_g
    del key
    new_group = np.empty(len(jk), bool)
    new_group[0] = True
    new_group[1:] = group_key[1:] != group_key[:-1]
    seg_starts = np.flatnonzero(new_group)
    seg_lens = np.diff(np.append(seg_starts, len(jk)))
    group_q = group_key[seg_starts] // num_p     # query of each group
    group_true = uq_pids[group_key[seg_starts] % num_p] == q_pids[group_q]
    n_groups = np.bincount(group_q, minlength=num_q)
    # each query's true-pid group (a valid query has exactly one)
    true_group = np.full(num_q, -1, np.int64)
    true_group[group_q[group_true]] = np.flatnonzero(group_true)

    cmc = np.zeros((num_q, max_rank), np.float64)
    ranks_row = np.arange(max_rank)[None, :]
    vq = np.flatnonzero(valid_q)
    for _ in range(num_repeats):
        u = (rng.random(len(seg_starts)) * seg_lens).astype(np.int64)
        picked = jk[seg_starts + u]                 # one pick per group
        true_pos = picked[true_group[group_q]]      # its query's true pick
        precedes = picked < true_pos
        rank_of_true = np.bincount(
            group_q, weights=precedes, minlength=num_q)
        cmc += (rank_of_true[:, None] <= ranks_row) \
            & (ranks_row < n_groups[:, None])
    cmc /= num_repeats

    cmc_mean = cmc[vq].sum(axis=0) / len(vq)
    return {'cmc': cmc_mean.astype(np.float32), 'mAP': float(ap[vq].mean())}


def evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50,
                  eval_metric='default', q_anns=None, g_anns=None,
                  use_cython=True, use_native=True):
    """CMC rank + mAP: ``'default'`` (Market-1501) or ``'cuhk03'``.

    The JAX dispatcher's signature (reference
    torchreid/metrics/rank.py:173-214; ``q_anns``, ``g_anns`` and
    ``use_cython`` are accepted and unused). ``'default'`` runs the
    native ranker unless ``use_native`` is False; ``'cuhk03'`` stays on
    the numpy path, whose fixed-seed sampling stream is JAX's."""
    del q_anns, g_anns, use_cython
    args = (np.asarray(distmat), np.asarray(q_pids), np.asarray(g_pids),
            np.asarray(q_camids), np.asarray(g_camids), max_rank)
    if eval_metric == 'default':
        if use_native:
            from bpbreid_tpu_torch.native import rank as native_rank
            return native_rank.eval_market1501(*args)
        return eval_market1501(*args)
    if eval_metric == 'cuhk03':
        return eval_cuhk03(*args)
    raise ValueError("Incorrect eval_metric value '{}'".format(eval_metric))
