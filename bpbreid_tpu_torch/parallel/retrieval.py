"""Gallery-sharded retrieval: the distance matrix and the ranking over the
ranks of a ``Mesh`` (port of bpbreid_tpu/parallel/retrieval.py).

The gallery features ``[Ng, K, D]`` and visibility ``[Ng, K]`` are padded
to a multiple of the world size and split by columns: each rank computes
its ``[K, Nq, Ng/n]`` block of the part distances (``_bp_dist_block``,
one batched matmul), and the blocks are gathered. Queries are replicated
(Nq << Ng). The ranking counts each query's true matches' ranks over the
rank's columns (the sort-free counter of ``ops/ranking.py``) and
all-reduces the per-query sums.

The incomparable-pair sentinel (``max + 1``) is the maximum over the real
gallery columns, as the unpadded path takes it. JAX's sharded function
takes it over the padded gallery, whose zero-feature columns can raise it
(ROADMAP, "The JAX package at fault").
"""
import numpy as np
import torch

from bpbreid_tpu_torch.metrics.distance import _bp_dist_block
from bpbreid_tpu_torch.ops.ranking import _INT32_MAX, cmc_map
from bpbreid_tpu_torch.ops.tensortools import replace_values
from bpbreid_tpu_torch.parallel.mesh import (all_gather, all_reduce,
                                             shard_bounds)

__all__ = ['sharded_bp_distance', 'sharded_cmc_map', 'pad_to_multiple']


def pad_to_multiple(x, multiple, axis=0, value=0.0):
    """Pad ``x`` (a numpy array or a tensor) along ``axis`` to a multiple
    of ``multiple`` with ``value``; returns ``(padded, n_orig)``."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=axis), n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths, constant_values=value), n


def sharded_bp_distance(mesh, qf, gf, qf_vis=None, gf_vis=None,
                        dist_combine_strat='mean', metric='euclidean'):
    """Visibility-weighted part distance with the gallery split over the
    ranks (every rank passes the same ``qf`` and ``gf``).

    Args:
        mesh: the ``Mesh``.
        qf: ``[Nq, K, D]``; gf: ``[Ng, K, D]`` (tensors on the mesh's
            device); qf_vis, gf_vis: ``[Nq, K]`` / ``[Ng, K]`` or None.
    Returns:
        ``(pairwise [Nq, Ng_pad], part_pairwise [K, Nq, Ng_pad],
        n_gallery)`` on every rank; strip the padding with ``[...,
        :n_gallery]``.
    """
    gf_p, ng = pad_to_multiple(gf, mesh.size, axis=0)
    lo, hi = shard_bounds(gf_p.shape[0], mesh)
    has_vis = qf_vis is not None and gf_vis is not None
    gv_block = None
    if has_vis:
        gv_block = pad_to_multiple(gf_vis, mesh.size, axis=0)[0][lo:hi]
    pairwise, part_pairwise = _bp_dist_block(
        qf, gf_p[lo:hi], qf_vis if has_vis else None, gv_block,
        dist_combine_strat, metric)
    pairwise = all_gather(pairwise, mesh, dim=1)
    part_pairwise = all_gather(part_pairwise, mesh, dim=2)
    if has_vis:
        # push incomparable pairs to the end of every ranking; the maximum
        # over the real columns only
        max_value = part_pairwise[..., :ng].max() + 1.0
        pairwise = replace_values(pairwise, pairwise == -1.0, max_value)
        if qf_vis.dtype == torch.bool and gf_vis.dtype == torch.bool:
            part_pairwise = replace_values(part_pairwise,
                                           part_pairwise == -1.0, max_value)
    return pairwise, part_pairwise, ng


def sharded_cmc_map(mesh, distmat, q_pids, g_pids, q_camids, g_camids,
                    n_gallery=None, max_rank=50, max_matches=128):
    """Market-1501-protocol CMC/mAP with the gallery columns split over the
    ranks (every rank passes the same ``distmat [Nq, Ng]``).

    Columns beyond ``n_gallery`` (padding) are set to +inf with pid and
    camera -1, so they rank last and never match. Each rank counts over
    its columns: the per-query match counts, its closest ``max_matches``
    matches (gathered, then the global closest taken) and, for each of
    those, the kept entries that precede it; the sums are all-reduced. A
    query with more true matches than ``max_matches`` sends every rank to
    the exact full sort (``ops.ranking.cmc_map``), as in JAX.

    Returns:
        ``(cmc [max_rank] numpy, mAP float, num_valid_q int)``.
    """
    device = mesh.device
    distmat = torch.as_tensor(distmat, device=device).float()
    ng_pad = distmat.shape[1]
    n_gallery = n_gallery or ng_pad
    q_pids, q_camids = (torch.as_tensor(np.asarray(a), device=device)
                        for a in (q_pids, q_camids))
    g_pids, g_camids = (torch.as_tensor(np.asarray(a), device=device)
                        for a in (g_pids, g_camids))
    total = ng_pad + (-ng_pad) % mesh.size
    distmat = torch.cat([distmat, distmat.new_full(
        (distmat.shape[0], total - ng_pad), torch.inf)], dim=1)
    distmat[:, n_gallery:] = torch.inf
    g_pids, g_camids = (torch.cat([ids[:n_gallery], ids.new_full(
        (total - n_gallery,), -1)]) for ids in (g_pids, g_camids))

    lo, hi = shard_bounds(total, mesh)
    d = distmat[:, lo:hi]
    num_q = d.shape[0]
    same = g_pids[None, lo:hi] == q_pids[:, None]
    keep = ~(same & (g_camids[None, lo:hi] == q_camids[:, None]))
    match = same & keep
    num_rel = all_reduce(match.sum(dim=1, dtype=torch.int64), mesh)
    if int((num_rel > max_matches).sum()):
        cmc, mAP, n_valid = cmc_map(distmat, q_pids, g_pids, q_camids,
                                    g_camids, max_rank=max_rank)
        return cmc.cpu().numpy(), float(mAP), int(n_valid)

    m = min(max_matches, total)
    # this rank's closest matches, padded to m candidates, then the global
    # closest m of every rank's candidates
    m_loc = min(m, hi - lo)
    neg, idx = torch.topk(torch.where(match, -d, -torch.inf), m_loc, dim=1)
    cand_neg = neg.new_full((num_q, m), -torch.inf)
    cand_idx = idx.new_full((num_q, m), total)
    cand_neg[:, :m_loc], cand_idx[:, :m_loc] = neg, idx + lo
    cand_neg = all_gather(cand_neg, mesh, dim=1)
    cand_idx = all_gather(cand_idx, mesh, dim=1)
    md_neg, pick = torch.topk(cand_neg, m, dim=1)
    mdist = -md_neg
    midx = torch.gather(cand_idx, 1, pick)
    mvalid = torch.isfinite(mdist)

    counts = torch.zeros((num_q, m), dtype=torch.int64, device=device)
    # gallery columns a counting step: the [Q, block, m] compare tensor
    # near 2^27 elements, as in ops.ranking.cmc_map_counting
    block = max(256, min(8192, (1 << 27) // max(1, num_q * m)))
    md, mi = mdist[:, None, :], midx[:, None, :]
    for s in range(0, hi - lo, block):
        d_b = d[:, s:s + block, None]
        i_b = torch.arange(lo + s, lo + s + d_b.shape[1],
                           device=device)[None, :, None]
        less = (d_b < md) | ((d_b == md) & (i_b < mi))
        counts += (less & keep[:, s:s + block, None]).sum(dim=1)
    all_reduce(counts, mesh)

    ranks_m = torch.sort(torch.where(mvalid, counts, _INT32_MAX),
                         dim=1).values
    i = torch.arange(m, device=device)[None, :]
    prec = torch.where(mvalid, (i + 1.0) / (ranks_m + 1.0), 0.0)
    ap = prec.sum(dim=1) / num_rel.clamp(min=1)
    valid_q = num_rel > 0
    first = torch.where(valid_q, ranks_m[:, 0], total)
    cmc_per_q = (first[:, None]
                 <= torch.arange(max_rank, device=device)[None, :]).float()
    n_valid = valid_q.sum()
    cmc = (cmc_per_q * valid_q[:, None]).sum(dim=0) / n_valid.clamp(min=1)
    mAP = (ap * valid_q).sum() / n_valid.clamp(min=1)
    return cmc.cpu().numpy(), float(mAP), int(n_valid)
