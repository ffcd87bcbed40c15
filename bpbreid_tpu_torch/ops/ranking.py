"""CMC / mAP ranking on the device (port of bpbreid_tpu/ops/ranking.py).

``cmc_map``: the Market-1501 protocol as one stable sort of each query's
distances plus masked cumulative statistics (the vectorized form of
``metrics/rank.py``), on the device that holds the distances.

``cmc_map_counting``: the sort-free large-gallery form. CMC and mAP only
need the ranks of the true matches, and a match's rank is a count: the
kept gallery entries strictly closer, or as close with a lower gallery
index (the stable-sort order). So take the ``max_matches`` closest
matches of each query with ``topk``, then count, gallery block by gallery
block, the kept entries that precede each of them: O(Q·G·M) compares
instead of O(Q·G·log G) sorting. ``topk``'s order among tied match
distances is unspecified, which does not matter: when no query has more
than ``max_matches`` true matches every match is selected, and the match
ranks are sorted afterwards; a query with more is counted in the fourth
return value, and the caller falls back to ``cmc_map``.

Both take ``distmat [Q, G]`` and int ids ``[Q]`` / ``[G]`` (tensors or
arrays; ids are moved to ``distmat``'s device) and return tensors on that
device: counts int32, CMC and mAP f32, as the JAX functions do.
"""
import torch

__all__ = ['cmc_map', 'cmc_map_counting']

_INT32_MAX = torch.iinfo(torch.int32).max


def _ids(distmat, *ids):
    return [torch.as_tensor(i, device=distmat.device) for i in ids]


def cmc_map(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50):
    """Market-1501-protocol CMC curve and mAP, with one full sort.

    Returns:
        ``(cmc [max_rank] f32, mAP f32 scalar, num_valid_q int scalar)``.
    """
    q_pids, g_pids, q_camids, g_camids = _ids(distmat, q_pids, g_pids,
                                              q_camids, g_camids)
    num_g = distmat.shape[1]
    order = torch.sort(distmat, dim=1, stable=True).indices         # [Q, G]
    matches = g_pids[order] == q_pids[:, None]
    keep = ~(matches & (g_camids[order] == q_camids[:, None]))

    mk = matches & keep
    pos = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    cum_matches = torch.cumsum(mk, dim=1, dtype=torch.int32)
    num_rel = cum_matches[:, -1]
    valid_q = num_rel > 0

    prec = torch.where(mk, cum_matches / (pos + 1.0), 0.0)
    ap = prec.sum(dim=1) / num_rel.clamp(min=1)

    first_match = torch.where(mk, pos, num_g).amin(dim=1)
    ranks = torch.arange(max_rank, device=distmat.device)[None, :]
    cmc_per_q = (first_match[:, None] <= ranks).float()

    n_valid = valid_q.sum(dtype=torch.int32)
    cmc = (cmc_per_q * valid_q[:, None]).sum(dim=0) / n_valid.clamp(min=1)
    mAP = (ap * valid_q).sum() / n_valid.clamp(min=1)
    return cmc, mAP, n_valid


def cmc_map_counting(distmat, q_pids, g_pids, q_camids, g_camids,
                     max_rank=50, max_matches=64, block=8192):
    """Sort-free Market-1501-protocol CMC/mAP (see the module docstring).

    Equal to ``cmc_map`` whenever every query has at most ``max_matches``
    true (non-junk) gallery matches.

    Args:
        max_matches: cap on true matches per query.
        block: gallery columns per counting step; clamped so that the
            ``[Q, block, max_matches]`` compare tensor stays near 2^27
            elements.
    Returns:
        ``(cmc [max_rank], mAP, num_valid_q, num_overflow_q)``.
    """
    q_pids, g_pids, q_camids, g_camids = _ids(distmat, q_pids, g_pids,
                                              q_camids, g_camids)
    device = distmat.device
    num_q, num_g = distmat.shape
    max_matches = min(max_matches, num_g)
    block = max(256, min(block, (1 << 27) // max(1, num_q * max_matches)))
    distmat = distmat.float()
    same = g_pids[None, :] == q_pids[:, None]                       # [Q, G]
    keep = ~(same & (g_camids[None, :] == q_camids[:, None]))
    match = same & keep
    num_rel = match.sum(dim=1, dtype=torch.int32)
    valid_q = num_rel > 0
    n_overflow = (num_rel > max_matches).sum(dtype=torch.int32)

    # the <= max_matches closest matches per query (distance, gallery idx)
    neg = torch.where(match, -distmat, -torch.inf)
    md_neg, midx = torch.topk(neg, max_matches, dim=1)              # [Q, M]
    mdist = -md_neg
    mvalid = torch.isfinite(mdist)

    # rank of each match among kept entries = #{k kept : d_k < d_m or
    # (d_k == d_m and k < idx_m)}, counted in gallery blocks
    counts = torch.zeros((num_q, max_matches), dtype=torch.int32,
                         device=device)
    md, mi = mdist[:, None, :], midx[:, None, :]
    for s in range(0, num_g, block):
        d_b = distmat[:, s:s + block, None]                          # [Q,B,1]
        i_b = torch.arange(s, s + d_b.shape[1], device=device)[None, :, None]
        less = (d_b < md) | ((d_b == md) & (i_b < mi))
        counts += (less & keep[:, s:s + block, None]).sum(dim=1,
                                                          dtype=torch.int32)

    # match ranks ascending; precision at the i-th closest match is
    # (i+1)/(rank_i+1)
    ranks_m = torch.sort(torch.where(mvalid, counts, _INT32_MAX),
                         dim=1).values                              # [Q, M]
    i = torch.arange(max_matches, device=device)[None, :]
    prec = torch.where(mvalid, (i + 1.0) / (ranks_m + 1.0), 0.0)
    ap = prec.sum(dim=1) / num_rel.clamp(min=1)

    first = torch.where(valid_q, ranks_m[:, 0], num_g)
    cmc_per_q = (first[:, None]
                 <= torch.arange(max_rank, device=device)[None, :]).float()
    n_valid = valid_q.sum(dtype=torch.int32)
    cmc = (cmc_per_q * valid_q[:, None]).sum(dim=0) / n_valid.clamp(min=1)
    mAP = (ap * valid_q).sum() / n_valid.clamp(min=1)
    return cmc, mAP, n_valid, n_overflow
