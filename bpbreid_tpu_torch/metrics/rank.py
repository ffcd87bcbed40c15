"""CMC / mAP ranking on the host (port of the numpy path of
bpbreid_tpu/metrics/rank.py:34 and :162).

Vectorized over all queries: junk removal and the cumulative statistics
are masked cumsums over the sorted gallery axis. The sort is stable, so
tied distances keep gallery index order (as the JAX package's native
ranker does); the ``max + 1`` sentinel of incomparable pairs makes ties.
"""
import numpy as np

__all__ = ['evaluate_rank', 'eval_market1501']


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


def evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50,
                  eval_metric='default'):
    """CMC rank + mAP. Only the default (Market-1501) protocol is ported."""
    if eval_metric != 'default':
        raise NotImplementedError(
            "eval_metric '{}' is not ported yet".format(eval_metric))
    return eval_market1501(np.asarray(distmat), q_pids, g_pids, q_camids,
                           g_camids, max_rank)
