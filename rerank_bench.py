#!/usr/bin/env python3
"""Times k-reciprocal re-ranking (``bpbreid_tpu_torch/utils/rerank.py``,
host numpy and scipy) at Market-1501 size: 3,368 queries against 19,732
gallery images, on the features of ``chip_smoke.py`` phase 8b (seeded
``[N, 6, 512]`` with planted identities, made on the card).

    python3 rerank_bench.py

The three distance matrices (query-gallery, query-query,
gallery-gallery) are computed on the card as the engine computes them
under ``test.rerank`` (``compute_distance_matrix_using_bp_features``,
binary visibility, mean over parts) and copied to the host; then
``re_ranking`` on them, timed by the host clock, with the process's peak
resident memory before and after (``getrusage``); then CMC and mAP with
and without re-ranking. Prints one JSON line, with the card's name and
power limit, and writes it to ``chiprun_out/rerank_bench.json``. Needs
one CUDA card; exits 1 without one.
"""
import json
import os
import resource
import sys
import time

import chip_smoke as cs


def max_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    import torch
    if not torch.cuda.is_available():
        print('rerank_bench: CUDA is not available', file=sys.stderr)
        return 1
    from bpbreid_tpu_torch.metrics.distance import \
        compute_distance_matrix_using_bp_features
    from bpbreid_tpu_torch.metrics.rank import evaluate_rank
    from bpbreid_tpu_torch.utils.rerank import re_ranking
    gpu = cs.gpu_name_and_power_limit()
    # phase 8b's features: the same seeds and draws
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED + 5)
    centers = torch.randn((2 * cs.MARKET_IDS, 6, 512), device='cuda',
                          generator=gen)
    q_pids = torch.arange(cs.MARKET_QUERY, device='cuda') % cs.MARKET_IDS
    g_pids = torch.randint(0, 2 * cs.MARKET_IDS, (cs.MARKET_GALLERY,),
                           device='cuda', generator=gen)
    qf, qv, qp, qc = cs._synthetic_split(torch, gen, q_pids, centers)
    gf, gv, gp, gc = cs._synthetic_split(torch, gen, g_pids, centers)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = [compute_distance_matrix_using_bp_features(
        a, b, va.bool(), vb.bool(), 'mean', 500)[0].cpu().numpy()
        for a, b, va, vb in ((qf, gf, qv, gv), (qf, qf, qv, qv),
                             (gf, gf, gv, gv))]
    distances_s = time.perf_counter() - t0
    del qf, gf, centers
    torch.cuda.empty_cache()

    rss_before = max_rss_gb()
    t0 = time.perf_counter()
    reranked = re_ranking(*dist)
    rerank_s = time.perf_counter() - t0
    rss_after = max_rss_gb()
    plain = evaluate_rank(dist[0], qp, gp, qc, gc)
    ranked = evaluate_rank(reranked, qp, gp, qc, gc)
    out = {'queries': cs.MARKET_QUERY, 'gallery': cs.MARKET_GALLERY,
           'distances_on_card_s': distances_s, 'rerank_s': rerank_s,
           'host_peak_rss_gb_before': rss_before,
           'host_peak_rss_gb_after': rss_after,
           'host_peak_rss_gb_growth': rss_after - rss_before,
           'mAP': float(plain['mAP']), 'rank1': float(plain['cmc'][0]),
           'rerank_mAP': float(ranked['mAP']),
           'rerank_rank1': float(ranked['cmc'][0]),
           'torch': torch.__version__, 'gpu': gpu}
    print(json.dumps(out), flush=True)
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/rerank_bench.json', 'w') as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
