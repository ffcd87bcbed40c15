"""k-reciprocal re-ranking (Zhong et al., CVPR 2017), the port's own
copy of bpbreid_tpu/utils/rerank.py.

It runs on the host with numpy and scipy, as in the JAX package: the
engine computes the query-gallery, query-query and gallery-gallery
distances on the device and hands them over. The reference
(torchreid/utils/rerank.py:31-96) loops over samples; this version works
on whole matrices:

* one blocked top-k pass (``argpartition`` per row block) serves the
  three neighbour levels (k1+1, k1/2+1, k2);
* the k-nearest relation is a sparse boolean matrix ``N``, so the
  k-reciprocal sets are ``R = N * N^T``;
* the expansion rule (absorb candidate c's half-level set when it
  overlaps R(i) by more than 2/3) is one sparse product ``R R2^T``,
  a threshold, and a second sparse product for the union;
* local query expansion is a sparse averaging product ``A V``;
* each query's Jaccard min-sum against every sample is a ragged gather
  over the CSC structure of ``V`` and a ``bincount``.
"""
import numpy as np
import scipy.sparse as sp

__all__ = ['re_ranking']


def _topk_indices(dist, k, block=2048):
    """Ordered [n, k] indices of each row's k smallest entries.

    Blocked so the argpartition index temporary stays small (a whole-
    matrix argpartition materializes an [n, n] int64 array — 3GB at
    Market-1501 scale on top of the distance matrix itself).
    """
    n, m = dist.shape
    k = min(k, m)
    out = np.empty((n, k), np.int64)
    for r0 in range(0, n, block):
        rows = dist[r0:r0 + block]
        part = np.argpartition(rows, k - 1, axis=1)[:, :k]
        vals = np.take_along_axis(rows, part, axis=1)
        order = np.argsort(vals, axis=1)
        out[r0:r0 + block] = np.take_along_axis(part, order, axis=1)
    return out


def _prefix_bool(topk, k, n):
    """Sparse boolean [n, n] matrix marking each row's k nearest."""
    k = min(k, topk.shape[1])
    rows = np.repeat(np.arange(topk.shape[0]), k)
    return sp.csr_matrix(
        (np.ones(topk.shape[0] * k, np.float32), (rows, topk[:, :k].ravel())),
        shape=(topk.shape[0], n))


def _expanded_reciprocal_sets(topk, k1, n):
    """Sparse boolean matrix of expanded k-reciprocal sets R*(i)."""
    full = _prefix_bool(topk, k1 + 1, n)
    half = _prefix_bool(topk, int(np.around(k1 / 2.)) + 1, n)
    recip = full.multiply(full.T)      # R(i):  j ∈ kNN(i) ∧ i ∈ kNN(j)
    recip_h = half.multiply(half.T)    # R₂(i): same at the k1/2 level

    # overlap[i, c] = |R(i) ∩ R₂(c)| for every pair; keep only pairs
    # where c is actually a candidate (c ∈ R(i)), then threshold.
    overlap = recip.multiply(recip @ recip_h.T).tocoo()
    set_sizes = np.asarray(recip_h.sum(axis=1)).ravel()
    absorb = overlap.data > (2. / 3) * set_sizes[overlap.col]
    absorber = sp.csr_matrix(
        (np.ones(int(absorb.sum()), np.float32),
         (overlap.row[absorb], overlap.col[absorb])), shape=(n, n))
    expanded = (recip + absorber @ recip_h) > 0
    return expanded.tocoo()


def re_ranking(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3):
    """Re-rank a query→gallery distance matrix with k-reciprocal encoding.

    Returns the [num_query, num_gallery] re-ranked distance matrix:
    ``(1-λ)·jaccard + λ·original`` (reference: utils/rerank.py:31-96).
    """
    nq = np.shape(q_g_dist)[0]
    n = nq + np.shape(q_g_dist)[1]

    # assemble the joint [n, n] squared distance in one buffer (no
    # np.block/astype/power temporaries — at Market scale each temp is
    # a 1.5GB memory pass), column-max normalize in place, then one
    # transpose copy so the blocked row selection stays cache-friendly
    dist = np.empty((n, n), np.float32)
    dist[:nq, :nq] = q_q_dist
    dist[:nq, nq:] = q_g_dist
    dist[nq:, :nq] = np.transpose(q_g_dist)
    dist[nq:, nq:] = g_g_dist
    np.square(dist, out=dist)
    dist /= dist.max(axis=0)
    dist = dist.T.copy()

    kmax = max(k1 + 1, k2)
    topk = _topk_indices(dist, kmax)

    # --- encode each sample as a sparse affinity vector over its R*(i) ---
    sets = _expanded_reciprocal_sets(topk, k1, n)
    weights = np.exp(-dist[sets.row, sets.col]).astype(np.float32)
    V = sp.csr_matrix((weights, (sets.row, sets.col)), shape=(n, n))
    V = sp.diags(1.0 / np.asarray(V.sum(axis=1)).ravel()) @ V

    if k2 != 1:  # local query expansion: average each row's k2-NN rows
        avg = _prefix_bool(topk, k2, n)
        V = ((avg * (1.0 / k2)) @ V).tocsr()

    # --- Jaccard distance between query rows and every sample ---
    # rows are L1-normalized, so Σmax = 2 − Σmin and
    # jaccard = 1 − Σmin / (2 − Σmin). Σmin against all n rows at once:
    # gather the stored entries of V's columns in this query's support
    # (CSC ragged slice) and bincount the elementwise minima by row.
    Vq = V[:nq]
    cols_csr = V.T.tocsr()  # row c = column c of V
    indptr, col_rows = cols_csr.indptr, cols_csr.indices
    col_vals = cols_csr.data
    jaccard = np.empty((nq, n), np.float32)
    for i in range(nq):
        support = Vq.indices[Vq.indptr[i]:Vq.indptr[i + 1]]
        vals = Vq.data[Vq.indptr[i]:Vq.indptr[i + 1]]
        starts, ends = indptr[support], indptr[support + 1]
        counts = ends - starts
        total = int(counts.sum())
        # ragged gather: positions of all stored entries of V[:, support]
        offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
        take = np.repeat(starts - offsets, counts) + np.arange(total)
        mins = np.minimum(col_vals[take], np.repeat(vals, counts))
        min_sum = np.bincount(col_rows[take], weights=mins, minlength=n)
        jaccard[i] = 1.0 - min_sum / (2.0 - min_sum)

    final = jaccard * (1 - lambda_value) + dist[:nq] * lambda_value
    return final[:, nq:]
