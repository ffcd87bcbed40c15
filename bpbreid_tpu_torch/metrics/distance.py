"""Global and part-based query-gallery distance matrices (port of
bpbreid_tpu/metrics/distance.py).

Global: one matmul between two ``[M, D]`` and ``[N, D]`` feature
matrices, the squared euclidean distance or 1 - cosine similarity
(``compute_distance_matrix`` :50). Per-part distances are one batched
matmul (``[K, Nq, Ng]``); the gallery is processed in chunks of
``batch_size_pairwise_dist_matrix`` to bound device memory. Pairs with
no mutually visible part get the ``-1`` sentinel, later replaced by
``max + 1`` so they rank last.
"""
import torch

from bpbreid_tpu_torch.ops.tensortools import masked_mean, replace_values

__all__ = ['compute_distance_matrix', 'euclidean_squared_distance',
           'cosine_distance', 'compute_distance_matrix_using_bp_features']


def euclidean_squared_distance(input1, input2):
    """``[M, D]``, ``[N, D]`` -> ``[M, N]`` squared euclidean distances in
    f32."""
    a, b = input1.float(), input2.float()
    return (a * a).sum(dim=1, keepdim=True) - 2.0 * (a @ b.T) \
        + (b * b).sum(dim=1)[None, :]


def cosine_distance(input1, input2):
    """1 - the cosine similarity of the L2-normalized rows, in f32."""
    a, b = input1.float(), input2.float()
    a = a / a.norm(dim=1, keepdim=True).clamp(min=1e-12)
    b = b / b.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return 1.0 - a @ b.T


def compute_distance_matrix(input1, input2, metric='euclidean'):
    """Distance matrix between two 2-D feature matrices on one device."""
    if input1.dim() != 2 or input2.dim() != 2:
        raise ValueError('Expected 2-D tensors, got {}-D and {}-D'.format(
            input1.dim(), input2.dim()))
    if input1.shape[1] != input2.shape[1]:
        raise ValueError('Feature dims mismatch: {} vs {}'.format(
            input1.shape[1], input2.shape[1]))
    if metric == 'euclidean':
        return euclidean_squared_distance(input1, input2)
    if metric == 'cosine':
        return cosine_distance(input1, input2)
    raise ValueError('Unknown distance metric: {}'.format(metric))


def _part_dist_matrices(qf, gf, metric='euclidean'):
    """qf [Nq,K,D], gf [Ng,K,D] -> [K,Nq,Ng]."""
    dot = torch.einsum('qkd,gkd->kqg', qf.float(), gf.float())
    if metric == 'cosine':
        return 1.0 - dot
    q_sq = (qf * qf).sum(dim=-1).T[:, :, None]        # [K, Nq, 1]
    g_sq = (gf * gf).sum(dim=-1).T[:, None, :]        # [K, 1, Ng]
    return torch.sqrt(torch.relu(q_sq - 2.0 * dot + g_sq))


def _combine(part_dist, valid_mask, strat):
    """[K,Nq,Ng] part distances -> [Nq,Ng] with validity masking."""
    if strat not in ('max', 'mean'):
        raise ValueError('Body parts distance combination strategy "{}" '
                         'not supported'.format(strat))
    if valid_mask is None:
        if strat == 'max':
            return part_dist.amax(dim=0), part_dist
        return part_dist.mean(dim=0), part_dist
    if strat == 'max':
        valid_part_dist = replace_values(part_dist, ~valid_mask.bool(), -1.0)
        return valid_part_dist.amax(dim=0), valid_part_dist
    combined = masked_mean(part_dist, valid_mask, dim=0)
    valid_part_dist = replace_values(part_dist, valid_mask == 0, -1.0)
    return combined, valid_part_dist


def _bp_dist_block(qf, gf, qf_vis, gf_vis, strat, metric):
    part_dist = _part_dist_matrices(qf, gf, metric)
    if qf_vis is None or gf_vis is None:
        return _combine(part_dist, None, strat)
    if qf_vis.dtype == torch.bool and gf_vis.dtype == torch.bool:
        # a pair is valid iff both sides see the part
        valid = qf_vis.T[:, :, None] & gf_vis.T[:, None, :]     # [K,Nq,Ng]
        return _combine(part_dist, valid, strat)
    # continuous visibility: geometric-mean weights
    weights = torch.sqrt(qf_vis.T[:, :, None].to(part_dist.dtype)
                         * gf_vis.T[:, None, :].to(part_dist.dtype))
    return masked_mean(part_dist, weights, dim=0), part_dist


def compute_distance_matrix_using_bp_features(
        qf, gf, qf_parts_visibility=None, gf_parts_visibility=None,
        dist_combine_strat='mean', batch_size_pairwise_dist_matrix=0,
        metric='euclidean'):
    """Visibility-weighted part-based query-gallery distance matrix.

    Args:
        qf: query part features ``[Nq, K, D]`` (tensor).
        gf: gallery part features ``[Ng, K, D]`` on the same device.
        qf_parts_visibility / gf_parts_visibility: ``[Nq, K]`` / ``[Ng, K]``,
            bool or continuous in [0, 1]; ``None`` disables filtering.
        dist_combine_strat: 'mean' or 'max'.
        batch_size_pairwise_dist_matrix: gallery chunk size (0 = one
            block).
    Returns:
        ``(pairwise_dist [Nq, Ng], part_pairwise_dist [K, Nq, Ng])``.
    """
    has_vis = qf_parts_visibility is not None \
        and gf_parts_visibility is not None
    qf_vis = qf_parts_visibility if has_vis else None
    gf_vis = gf_parts_visibility if has_vis else None
    ng = gf.shape[0]
    bs = int(batch_size_pairwise_dist_matrix)
    if bs <= 0 or ng <= bs:
        bs = max(ng, 1)
    blocks = [_bp_dist_block(qf, gf[s:s + bs], qf_vis,
                             gf_vis[s:s + bs] if has_vis else None,
                             dist_combine_strat, metric)
              for s in range(0, ng, bs)]
    pairwise = torch.cat([b[0] for b in blocks], dim=-1)
    part_pairwise = torch.cat([b[1] for b in blocks], dim=-1)

    if has_vis:
        # push incomparable pairs to the end of every ranking
        max_value = part_pairwise.max() + 1.0
        pairwise = replace_values(pairwise, pairwise == -1.0, max_value)
        if qf_vis.dtype == torch.bool and gf_vis.dtype == torch.bool:
            part_pairwise = replace_values(
                part_pairwise, part_pairwise == -1.0, max_value)
    return pairwise, part_pairwise
