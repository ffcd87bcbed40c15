"""Pair-distance distribution statistics and SSMD (port of
bpbreid_tpu/utils/distribution.py; numpy on the host). Plotting is not
ported: ``plot_pairs_distance_distribution`` returns the five numbers."""
import numpy as np

__all__ = ['pairs_distance_distribution', 'compute_ssmd',
           'plot_pairs_distance_distribution']


def pairs_distance_distribution(distmat, q_pids, g_pids):
    """Mean/std of positive-pair and negative-pair distances."""
    distmat = np.asarray(distmat)
    same = np.asarray(q_pids)[:, None] == np.asarray(g_pids)[None, :]
    pos = distmat[same]
    neg = distmat[~same]
    return (float(pos.mean()) if pos.size else 0.0,
            float(pos.std()) if pos.size else 0.0,
            float(neg.mean()) if neg.size else 0.0,
            float(neg.std()) if neg.size else 0.0)


def compute_ssmd(pos_mean, pos_std, neg_mean, neg_std):
    """Strictly standardized mean difference of the positive and negative
    pair-distance distributions, unsigned, over sqrt(var_pos + var_neg)
    (the JAX package's denominator)."""
    denom = np.sqrt(pos_std ** 2 + neg_std ** 2)
    return float(abs(neg_mean - pos_mean) / denom) if denom > 0 else 0.0


def plot_pairs_distance_distribution(distmat, q_pids, g_pids):
    """``(pos_mean, pos_std, neg_mean, neg_std, ssmd)``."""
    pm, ps, nm, ns = pairs_distance_distribution(distmat, q_pids, g_pids)
    return pm, ps, nm, ns, compute_ssmd(pm, ps, nm, ns)
